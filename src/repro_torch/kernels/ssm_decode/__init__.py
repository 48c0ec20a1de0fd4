"""The Mamba-2 decode step's recurrent core (B14): CUDA source, wrapper,
its plain PyTorch version and a mirror of the kernel's order of
operations."""
