"""Banded (min,+) relaxation kernels: CUDA sources, build, wrappers and their
plain PyTorch versions."""
