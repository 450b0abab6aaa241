"""CUDA kernel wrappers, their plain PyTorch twins, the build, and the
occupancy reductions."""
