"""The Mamba-2 SSD chunked scan (B9): CUDA source, wrapper, its autograd
Function and its plain PyTorch version."""
