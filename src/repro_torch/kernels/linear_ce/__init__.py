"""The training loss (B11): the LM head product, log-softmax cross-entropy
and its backward without the float32 logits in memory: CUDA source,
wrappers, their autograd Function, the plain PyTorch version and a mirror
of the launch plan."""
