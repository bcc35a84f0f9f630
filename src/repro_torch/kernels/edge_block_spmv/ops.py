"""Public wrappers around the uncompressed-block SpMV kernel.

``spmv_vertex`` (+``_batched``) run ``edge_block_spmv`` over every block of
a ``CSRGraph`` and reduce the per-block sums onto their owners by
``block_src``, outside the kernel, as the JAX package does.  They pass the
graph's owner arrays, so the kernel reads only the real slots; with no
filter they pass no filter words, since ``dst < n`` already masks the
padding.
"""
from __future__ import annotations

import torch

from ...core.csr import CSRGraph
from ...core.graph_filter import GraphFilter, edge_active_words
from ...core.primitives import segment_reduce
from ...tuning.defaults import DEFAULT_TILE_BLOCKS
from .edge_block_spmv import edge_block_spmv


def _per_block_sums(g: CSRGraph, x, f, edge_active, tile_blocks):
    bits = None if f is None else f.bits
    active = None if edge_active is None else edge_active_words(edge_active, g.block_size)
    return edge_block_spmv(x, g.block_dst, g.block_w, bits, active, n=g.n,
                           tile_blocks=tile_blocks,
                           owners=(g.block_src, g.block_offsets, g.degrees))


def spmv_vertex(
    g: CSRGraph,
    x: torch.Tensor,
    f: GraphFilter | None = None,
    *,
    edge_active=None,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
) -> torch.Tensor:
    """``out[v] = Σ_{(v,u) active} w_vu · x[u]`` — the PageRank/GNN
    aggregation step, (n,).

    The kernel computes the per-block sums; a segment reduction by block
    owner follows.  ``edge_active`` is the per-call traversal mask (a
    GraphFilter, packed int32 words, or a bool slot mask), ANDed with the
    filter bits in the kernel."""
    per_block = _per_block_sums(g, x, f, edge_active, tile_blocks)
    return segment_reduce(per_block, g.block_src, g.n + 1, "sum")[: g.n]


def spmv_vertex_batched(
    g: CSRGraph,
    xb: torch.Tensor,
    f: GraphFilter | None = None,
    *,
    edge_active=None,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
) -> torch.Tensor:
    """Batched ``spmv_vertex``: ``xb`` is (B, n); returns (B, n).  One sweep
    of the edge blocks serves all B queries."""
    per_block = _per_block_sums(g, xb, f, edge_active, tile_blocks)   # (NB, B)
    return segment_reduce(per_block, g.block_src, g.n + 1, "sum")[: g.n].T
