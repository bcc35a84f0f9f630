"""Model configurations of the port, on its own ``LMConfig``."""
from . import qwen2_1_5b
