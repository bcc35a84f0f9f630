"""Models of the port: the transformer LM (dense GQA, MoE, MLA), SASRec,
and the GNN family (GIN, PNA, DimeNet, Equiformer-v2)."""
from . import gnn, sasrec, transformer_lm
