from .defaults import (
    DEFAULT_CHUNK_BLOCKS,
    DEFAULT_DENSE_FRAC,
    DEFAULT_MAX_BATCH,
    DEFAULT_TILE_BLOCKS,
)
from .table import TuningDecision, constants_decision
