"""Public wrappers around the frontier-sparse compressed-block kernel.

* ``compressed_chunked_stream_tile`` — the chunk-pool decoder behind the
  core ``edgemap_chunked`` streamed path: one chunk of live ids in, exact
  masked targets + aligned weights out, exceptions patched by gathered id.
* ``compressed_spmv_vertex_chunked`` — the frontier-sparse SpMV: sums over
  only the blocks owned by ``frontier`` vertices, single or (B, n)-batched.

The kernel decodes blocks holding ESCAPE deltas wrong on purpose; these
wrappers recompute those (rare) blocks exactly and patch them in.
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
from .compressed_spmv import compressed_chunked_spmv

def _active_words(c: CompressedCSR, edge_active):
    return None if edge_active is None else edge_active_words(edge_active, c.block_size)


def _patch_rows(out: torch.Tensor, rows: torch.Tensor, values: torch.Tensor):
    """``out[rows] = values`` into a fresh copy, dropping rows == len(out)."""
    ext = torch.cat([out, out.new_zeros((1,) + out.shape[1:])])
    ext[rows] = values
    return ext[: out.shape[0]]


def _unique_block_tile(c: CompressedCSR, bids: torch.Tensor) -> torch.Tensor:
    """Exact decode of a block list that may repeat ids (the exception list)."""
    ub, inv = torch.unique(bids.long(), return_inverse=True)
    return decode_block_tile(c, ub)[inv]


def _exact_block_sums(c: CompressedCSR, dst, bids, x, bits, weights=None, active=None):
    """Exact per-block partial sums of the decoded rows ``dst`` of ``bids``:
    Σ over active slots of w · x[dst]; (len,) or (len, B) for a batched x."""
    act = unpack_word_bits(take_fill(bits, bids, 0))
    if active is not None:
        act = act & unpack_word_bits(take_fill(active, bids, 0))
    mask = (dst < c.n) & act
    safe = torch.where(mask, dst, 0).long()
    w = None if weights is None else take_fill(weights, bids, 0.0)
    if x.dim() == 2:
        xv = x[:, safe]                                    # (B, len, FB)
        if w is not None:
            xv = xv * w[None]
        contrib = torch.where(mask[None], xv, 0)
        return contrib.sum(dim=2, dtype=contrib.dtype).T.to(x.dtype)
    xv = x[safe]
    if w is not None:
        xv = xv * w
    contrib = torch.where(mask, xv, 0)
    return contrib.sum(dim=1, dtype=contrib.dtype).to(x.dtype)


def _exception_block_sums(c: CompressedCSR, x, bits, weights=None, active=None):
    """Exact per-block partial sums for the blocks on the exception list,
    masked exactly as the kernel masks: (NE,) or (NE, B)."""
    dst = _unique_block_tile(c, c.exc_block)
    return _exact_block_sums(c, dst, c.exc_block, x, bits, weights, active)


def _exception_row_targets(c: CompressedCSR, active=None) -> torch.Tensor:
    """Exact decoded targets for every exception-list block, active-masked.

    (NE, FB) int32 with inactive slots already at the sentinel ``n`` — the
    same folding the kernel applies, so a patched row is indistinguishable
    from a correctly decoded one."""
    exact = _unique_block_tile(c, c.exc_block)
    if active is not None:
        abits = unpack_word_bits(active[c.exc_block.long()])
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
            sums = _exact_block_sums(c, decode_block_tile(c, ids), ids, x, bits, w, active)
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
