"""Models of the port: the dense-GQA transformer LM's serving path."""
from . import transformer_lm
