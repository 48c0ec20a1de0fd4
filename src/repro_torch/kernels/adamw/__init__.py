"""The train step's optimizer programs: the gradients' global norm and
clip scale (B12) and AdamW's update with the clip folded in (B13), over a
whole tree in one launch each: CUDA source, wrappers, the plain PyTorch
versions and a mirror of the chunk table."""
