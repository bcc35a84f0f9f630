"""Models of the port: the dense-GQA transformer LM's serving path and
SASRec's serving path."""
from . import sasrec, transformer_lm
