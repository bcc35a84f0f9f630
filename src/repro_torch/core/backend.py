"""Graph-backend views — one edgeMap engine over two storage formats.

``edge_map`` / ``edgemap_dense`` / ``edgemap_chunked`` / ``edgemap_reduce``
accept a ``CSRGraph`` (uncompressed blocked CSR) or a ``CompressedCSR``
(delta-packed blocks, §5.1.3).  The two structural hooks that differ per
backend live here:

* ``dense_block_view`` — the (target, weight) view of a contiguous range of
  blocks for the dense (pull) pass.  The dense pass walks the graph range
  by range, so a compressed graph is decoded one range at a time.
* ``tile_block_view``  — a C-block tile for the chunked (sparse) pass.  For
  the compressed backend this decodes *inside the chunk loop* (App. D.1),
  so peak intermediates stay ``chunk_blocks × F_B`` words for both formats.
"""
from __future__ import annotations

from typing import Protocol, Union, runtime_checkable

import torch

from .compressed import CompressedCSR, decode_block_range, decode_block_tile
from .csr import CSRGraph
from .primitives import take_fill



@runtime_checkable
class GraphBackend(Protocol):
    """Structural surface every graph execution backend provides."""

    n: int
    m: int
    num_blocks: int
    block_size: int
    block_src: torch.Tensor  # int32[NB] — owner vertex per block
    degrees: torch.Tensor    # int32[n]

    @property
    def block_dst(self) -> torch.Tensor: ...  # int32[NB, FB], sentinel n pads

    @property
    def block_w(self) -> torch.Tensor: ...    # float32[NB, FB]

    @property
    def edge_valid(self) -> torch.Tensor: ...  # bool[NB*FB]

    def shard(self, num_shards: int) -> list["GraphBackend"]: ...
    # block-range partition: each shard is a valid backend over the global
    # vertex space (n, degrees replicated; blocks split; non-dividing counts
    # pad with empty blocks).  Consumed by the planner (core.plan).


GraphLike = Union[CSRGraph, CompressedCSR]


def dense_block_view(g: GraphLike, lo: int = 0, hi: int | None = None):
    """(block_dst, block_w), both (hi-lo, F_B), for blocks ``lo..hi-1``."""
    hi = g.num_blocks if hi is None else hi
    if isinstance(g, CompressedCSR):
        dst = decode_block_range(g, lo, hi)
        if g.block_weights is not None:
            return dst, g.block_weights[lo:hi]
        return dst, torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    return g.block_dst[lo:hi], g.block_w[lo:hi]


def tile_block_view(g: GraphLike, bids: torch.Tensor):
    """(dst, w), both (C, F_B), for a tile of block ids.

    Ids equal to ``num_blocks`` (the compact_mask fill) yield all-sentinel
    targets / zero weights for both backends (unweighted compressed graphs
    give weight 1 everywhere, as in the JAX package)."""
    if isinstance(g, CompressedCSR):
        dst = decode_block_tile(g, bids)
        if g.block_weights is not None:
            return dst, take_fill(g.block_weights, bids, 0.0)
        return dst, torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    return take_fill(g.block_dst, bids, g.n), take_fill(g.block_w, bids, 0.0)
