"""The MoE experts' SwiGLU of the gather dispatch (B10): CUDA source,
wrapper, its autograd Function, its plain PyTorch version and a mirror of
its launch plan."""
