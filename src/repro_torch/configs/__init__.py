"""Model configurations of the port: qwen2-1.5b on its own ``LMConfig``,
sasrec on its ``SASRecConfig``."""
from . import qwen2_1_5b, sasrec
