"""The early-exit confidence gate (B6): CUDA source, wrapper and its plain
PyTorch version."""
