"""Camera models and sweep permutation tables."""
