"""The GNN family (GIN, PNA, DimeNet, Equiformer-v2) on the aggregation
primitives of ``aggregate``.  Each model module has ``init(cfg, generator=,
device=)``, ``forward``, ``loss_fn`` (both with ``part=``, an ``EdgeSlice``),
``param_shapes``, ``param_specs`` and ``SPLIT``;
parameters are dict/list trees of tensors, the JAX package's leaf by leaf."""
from . import dimenet, equiformer_v2, gin, pna
from .aggregate import (
    EdgeSlice, degrees, gather_src, scatter_max, scatter_mean, scatter_min,
    scatter_std, scatter_sum, segment_softmax,
)

MODELS = (gin, pna, dimenet, equiformer_v2)


def module_of(cfg):
    """The model module whose config class ``cfg`` is an instance of."""
    for mod in MODELS:
        if type(cfg).__module__ == mod.__name__:
            return mod
    raise TypeError(f"{type(cfg).__name__} is not a GNN config")
