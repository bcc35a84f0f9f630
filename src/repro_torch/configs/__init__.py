"""Model configurations of the port, each a copy of its JAX module's
``ARCH_ID``, ``FAMILY``, ``MODULE``, ``full_config()`` and ``smoke_config()``:
the five LMs on the port's ``LMConfig``, sasrec on its ``SASRecConfig``."""
from . import (
    dbrx_132b,
    deepseek_v2_lite_16b,
    mistral_large_123b,
    qwen1_5_4b,
    qwen2_1_5b,
    sasrec,
)
