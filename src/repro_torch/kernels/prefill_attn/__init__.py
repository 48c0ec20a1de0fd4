"""Flash-prefill GQA attention (B8): CUDA source, wrapper, its autograd
Function and its plain PyTorch version."""
