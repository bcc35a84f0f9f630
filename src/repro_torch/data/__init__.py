from .recsys import make_candidates, make_sasrec_batch_fn
from .rmat import rmat_edges, rmat_graph, rmat_weights, structured_graph
from .tokens import make_lm_batch_fn
