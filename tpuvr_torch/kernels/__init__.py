"""CUDA kernel wrappers, their plain PyTorch twins, and the build."""
