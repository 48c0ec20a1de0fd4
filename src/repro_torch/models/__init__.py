"""LM backbones of the port: layers, decode attention, early exits and the
decode path of the transformer."""
