"""Inverse rendering: fit a voxel grid to posed views."""
