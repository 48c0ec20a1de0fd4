"""Flash-decode GQA attention (B7): CUDA source, wrapper and its plain
PyTorch version."""
