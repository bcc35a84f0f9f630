"""Public wrappers around the compressed-block kernels.

* ``compressed_spmv_vertex`` (+``_batched``) — the pull SpMV over every
  block (kernel ``compressed_block_spmv``), exceptions patched, then the
  owner reduction by ``block_src``.
* ``compressed_chunked_stream_tile`` — the chunk-pool decoder behind the
  core ``edgemap_chunked`` streamed path: one chunk of live ids in, exact
  masked targets + aligned weights out, exceptions patched by gathered id.
* ``compressed_stream_round_graph`` — a whole ``sparse_streamed`` round of
  min over int32 (BFS, wBFS) in one launch, exception blocks read from
  their exact rows.
* ``compressed_spmv_vertex_chunked`` — the frontier-sparse SpMV: sums over
  only the blocks owned by ``frontier`` vertices, single or (B, n)-batched.

The kernels decode blocks holding ESCAPE deltas wrong on purpose; these
wrappers recompute those (rare) blocks exactly and patch them in.  Past the
exception limit (``exception_dense``) the exact plain decode runs instead,
which is the JAX package's documented semantics for such graphs.
"""
from __future__ import annotations

import torch

from ...core.compressed import (
    CompressedCSR,
    decode_block_tile,
    exception_dense,
    rows_for_ids,
)
from ...core.graph_filter import (
    GraphFilter,
    edge_active_words,
    make_filter,
    unpack_word_bits,
)
from ...core.primitives import compact_mask, segment_reduce, take_fill
from ...tuning.defaults import DEFAULT_TILE_BLOCKS
from .compressed_spmv import (
    compressed_block_spmv,
    compressed_chunked_spmv,
    compressed_stream_round,
)
from .ref import compressed_block_sums_exact, exact_block_sums

def _active_words(c: CompressedCSR, edge_active):
    return None if edge_active is None else edge_active_words(edge_active, c.block_size)


def _patch_rows(out: torch.Tensor, rows: torch.Tensor, values: torch.Tensor):
    """``out[rows] = values`` into a fresh copy, dropping rows == len(out)."""
    ext = torch.cat([out, out.new_zeros((1,) + out.shape[1:])])
    ext[rows] = values
    return ext[: out.shape[0]]


def _unique_block_tile(c: CompressedCSR, bids: torch.Tensor) -> torch.Tensor:
    """Exact decode of a block list that may repeat ids (the exception list);
    ids outside ``[0, num_blocks)`` decode to all-sentinel rows."""
    ub, inv = torch.unique(bids.long(), return_inverse=True)
    return decode_block_tile(c, ub)[inv]


def _exception_blocks(c: CompressedCSR) -> torch.Tensor:
    """Each exception row's block id, with the rows outside ``[0,
    num_blocks)`` (a shard's padded list carries ``num_blocks``) mapped to
    ``num_blocks``: an index every scatter below drops."""
    eb = c.exc_block.long()
    return torch.where((eb >= 0) & (eb < c.num_blocks), eb, c.num_blocks)


def _exception_block_sums(c: CompressedCSR, x, bits, weights=None, active=None):
    """Exact per-block partial sums for the blocks on the exception list,
    masked exactly as the kernel masks: (NE,) or (NE, B)."""
    dst = _unique_block_tile(c, c.exc_block)
    return exact_block_sums(c, dst, c.exc_block, x, bits, weights, active)


def _per_block_sums(c: CompressedCSR, x, f, edge_active, tile_blocks, weighted=None):
    """Exact per-block sums of every block, (NB,) or (NB, B): the kernel with
    the exception blocks patched, or the exact decode on an exception-dense
    graph.  ``weighted`` (default ``c.weighted``) says whether the sums take
    the block weights."""
    bits = f.bits if f is not None else make_filter(c).bits
    active = _active_words(c, edge_active)
    w = c.block_weights if (c.weighted if weighted is None else weighted) else None
    if exception_dense(c):
        return compressed_block_sums_exact(c, x, bits, w, active)
    per_block = compressed_block_spmv(
        x, c.block_first, c.deltas, c.valid_count, bits, active, w, n=c.n,
        tile_blocks=tile_blocks,
    )
    if c.n_exceptions:
        fixed = _exception_block_sums(c, x, bits, w, active)
        per_block = _patch_rows(per_block, _exception_blocks(c), fixed)
    return per_block


def compressed_spmv_vertex(
    c: CompressedCSR,
    x: torch.Tensor,
    f: GraphFilter | None = None,
    *,
    edge_active=None,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
    weighted: bool | None = None,
) -> torch.Tensor:
    """``out[v] = Σ_{(v,u) active} w_vu · x[u]`` straight off the compressed
    stream, (n,); with ``weighted=False`` the unweighted ``Σ x[u]`` even on a
    weighted graph (default: ``c.weighted``).

    One launch of the fused decode + masked SpMV over every block
    (``tile_blocks`` blocks per CTA on the card), the ESCAPE blocks
    recomputed exactly and patched, then the O(#blocks) owner reduction.
    ``edge_active`` is the per-call traversal mask (a GraphFilter, packed
    int32 words, or a bool slot mask), ANDed with the filter bits in the
    kernel and in the exception fixup alike."""
    per_block = _per_block_sums(c, x, f, edge_active, tile_blocks, weighted)
    return segment_reduce(per_block, c.block_src, c.n + 1, "sum")[: c.n]


def compressed_spmv_vertex_batched(
    c: CompressedCSR,
    xb: torch.Tensor,
    f: GraphFilter | None = None,
    *,
    edge_active=None,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
) -> torch.Tensor:
    """Batched ``compressed_spmv_vertex``: ``xb`` is (B, n); returns (B, n).

    One sweep serves all B queries: each block is decoded once and its
    gather fans across the B columns; every lane equals its own
    single-query run (exactly for int32 state)."""
    per_block = _per_block_sums(c, xb, f, edge_active, tile_blocks)   # (NB, B)
    return segment_reduce(per_block, c.block_src, c.n + 1, "sum")[: c.n].T


def _exception_row_targets(c: CompressedCSR, active=None) -> torch.Tensor:
    """Exact decoded targets for every exception-list block, active-masked.

    (NE, FB) int32 with inactive slots already at the sentinel ``n`` — the
    same folding the kernel applies, so a patched row is indistinguishable
    from a correctly decoded one."""
    exact = _unique_block_tile(c, c.exc_block)
    if active is not None:
        abits = unpack_word_bits(take_fill(active, c.exc_block, 0))
        exact = torch.where(abits, exact, c.n)
    return exact


def compressed_chunked_stream_tile(
    c: CompressedCSR,
    ids: torch.Tensor,
    edge_active=None,
    *,
    exact_rows: torch.Tensor | None = None,
):
    """Stream + decode ONE chunk of live blocks: (dst (C, FB), w (C, FB)).

    The kernel reads only the blocks named by ``ids`` (ids ≥ num_blocks
    decode to all-sentinel rows), fusing the cumsum decode and the packed
    ``edge_active`` masking; ESCAPE blocks are then patched keyed on the
    ids.  ``exact_rows`` is the id-independent
    ``_exception_row_targets(c, words)``: a chunk-loop caller computes it
    once and passes it to every chunk."""
    active = _active_words(c, edge_active)
    w = c.block_weights if c.weighted else None
    dst, ws = compressed_chunked_spmv(
        None, ids.to(torch.int32), c.block_first, c.deltas, c.valid_count,
        None, active, w, n=c.n, emit="decode",
    )
    if c.n_exceptions:
        exact = _exception_row_targets(c, active) if exact_rows is None else exact_rows
        dst = _patch_rows(dst, rows_for_ids(ids, c.exc_block, c.num_blocks), exact)
    return dst, ws


def compressed_stream_round_graph(
    c: CompressedCSR,
    frontier: torch.Tensor,
    x: torch.Tensor,
    words: torch.Tensor | None,
    *,
    map_kind: str,
    exact_rows: torch.Tensor | None = None,
    map_lanes: torch.Tensor | None = None,
):
    """One ``sparse_streamed`` round of min over int32 on ``c``: ``(out,
    touched)``, (n,) or (B, n) as ``x`` is.

    ``words`` are the packed ``edge_active`` words (or None) and
    ``exact_rows`` their ``_exception_row_targets(c, words)``, which a
    caller that has them passes.  Each exception block gets the index of its
    exact row (``exc_row``), so the kernel reads that row instead of its
    decode, as ``compressed_chunked_stream_tile`` patches it; every other
    block, and every exception row whose block id lies outside the graph
    (a shard's padding), leaves ``exc_row`` at -1."""
    exc_row = None
    if c.n_exceptions:
        if exact_rows is None:
            exact_rows = _exception_row_targets(c, words)
        # all exact rows of one block are the same: any of them will do; the
        # rows of no real block land on the dropped entry num_blocks
        exc_row = torch.full((c.num_blocks + 1,), -1, dtype=torch.int32, device=c.device)
        exc_row[_exception_blocks(c)] = torch.arange(c.n_exceptions, dtype=torch.int32,
                                                     device=c.device)
        exc_row = exc_row[: c.num_blocks]
    w = c.block_weights if c.weighted else None
    x = x if x.stride(-1) == 1 else x.contiguous()
    frontier = frontier if frontier.stride(-1) == 1 else frontier.contiguous()
    return compressed_stream_round(
        x, frontier, c.block_src, c.block_first, c.deltas, c.valid_count, words, w,
        exc_row, exact_rows, n=c.n, map_kind=map_kind, map_lanes=map_lanes,
    )


def compressed_spmv_vertex_chunked(
    c: CompressedCSR,
    x: torch.Tensor,
    frontier: torch.Tensor,
    f: GraphFilter | None = None,
    *,
    edge_active=None,
    tile_blocks: int = DEFAULT_TILE_BLOCKS,
) -> torch.Tensor:
    """Frontier-sparse SpMV: sums over ONLY the frontier-owned blocks.

    ``out[v] = Σ_{(v,u) active} w_vu · x[u]`` for frontier vertices v, 0
    elsewhere.  The live block ids are compacted once and walked in chunks
    of ``tile_blocks``, one kernel launch (``emit="sums"``) each; exception
    blocks are patched with exact sums.  Exception-dense graphs take the
    exact plain decode for every chunk instead.  ``x`` may be (n,) or a
    (B, n) batch that shares each chunk's single read, returning (B, n).
    """
    bits = f.bits if f is not None else make_filter(c).bits
    active = _active_words(c, edge_active)
    w = c.block_weights if c.weighted else None
    batched = x.dim() == 2
    NB, n = c.num_blocks, c.n
    TB = min(tile_blocks, NB)
    blk_live = take_fill(frontier, c.block_src, False)
    idx, k = compact_mask(blk_live, fill=NB)
    nchunks = -(-NB // TB)
    idx = torch.nn.functional.pad(idx, (0, nchunks * TB - NB), value=NB)
    dense = exception_dense(c)
    fixed = (
        _exception_block_sums(c, x, bits, w, active)
        if c.n_exceptions and not dense
        else None
    )
    out = torch.zeros((n + 1, x.shape[0]) if batched else (n + 1,),
                      dtype=x.dtype, device=x.device)
    for lo in range(0, k, TB):
        ids = idx[lo : lo + TB]
        if dense:
            sums = exact_block_sums(c, decode_block_tile(c, ids), ids, x, bits, w, active)
        else:
            sums = compressed_chunked_spmv(
                x, ids.to(torch.int32), c.block_first, c.deltas, c.valid_count,
                bits, active, w, n=n, emit="sums",
            )
            if fixed is not None:
                sums = _patch_rows(sums, rows_for_ids(ids, c.exc_block, NB), fixed)
        srcs = take_fill(c.block_src, ids, n)
        out = out + segment_reduce(sums, srcs, n + 1, "sum")
    out = out[:n]
    return out.T if batched else out
