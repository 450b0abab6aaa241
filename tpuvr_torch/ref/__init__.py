"""Cameras, the sweep permutation tables, and the plain oracles: trilinear
sampling, compositing and the fixed-step and plane-sweep marchers."""
