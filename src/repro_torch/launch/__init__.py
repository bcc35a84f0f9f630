"""Step bodies of the port's serving cells (no mesh, no sharding)."""
from .steps import TOP_K, assert_topk_agrees, sasrec_retrieval_step, sasrec_serve_step
