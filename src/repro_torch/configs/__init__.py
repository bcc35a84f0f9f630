"""Model configurations of the port, each a copy of its JAX module's
``ARCH_ID``, ``FAMILY``, ``MODULE``, ``full_config()`` and ``smoke_config()``:
the five LMs on the port's ``LMConfig``, sasrec on its ``SASRecConfig``, and
the four GNNs with their ``cells()`` (``gnn_common``) and ``smoke_batch``."""
from . import (
    dbrx_132b,
    deepseek_v2_lite_16b,
    dimenet,
    equiformer_v2,
    gin_tu,
    mistral_large_123b,
    pna,
    qwen1_5_4b,
    qwen2_1_5b,
    sasrec,
)

GNN_ARCHS = {m.ARCH_ID: m for m in (pna, dimenet, equiformer_v2, gin_tu)}
