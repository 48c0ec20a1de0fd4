"""LM backbones of the port: layers, attention, the Mamba-2 SSM mixer, the
MoE FFN, early exits and the transformer's entry points."""
