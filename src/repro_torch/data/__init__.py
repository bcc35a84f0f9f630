from .recsys import make_candidates, make_sasrec_batch_fn
from .rmat import rmat_edges, rmat_graph, rmat_weights, structured_graph
