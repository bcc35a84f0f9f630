"""Models of the port: the transformer LM's serving path (dense GQA, MoE,
MLA) and SASRec's serving path."""
from . import sasrec, transformer_lm
