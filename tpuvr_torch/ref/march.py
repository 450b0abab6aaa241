"""Axis-permutation tables of the plane sweep.

``GRID_PERM[axis]`` transposes the (Z, Y, X, C) grid so that the sweep
axis becomes dim 0; ``PT_PERM[axis]`` is the matching permutation of
(x, y, z) point and direction components. Every entry is an involution.
"""

GRID_PERM = {0: (2, 1, 0, 3), 1: (1, 0, 2, 3), 2: (0, 1, 2, 3)}
PT_PERM = {0: (2, 1, 0), 1: (0, 2, 1), 2: (0, 1, 2)}
