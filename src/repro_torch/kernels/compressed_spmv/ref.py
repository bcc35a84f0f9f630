"""Plain PyTorch versions of the compressed-block kernels, and the exact oracle.

``compressed_chunked_spmv_ref``, ``compressed_block_spmv_ref`` and
``compressed_stream_round_ref`` have the signatures of the kernel wrappers in
``compressed_spmv.py`` and compute the same functions with ordinary tensor
ops: the CPU route runs them, and the card's tests hold the CUDA kernels
against them.  Like the
kernels, they decode blocks holding ESCAPE deltas wrong on purpose (the
callers in ``ops.py`` patch them), and they widen one chunk or range of
deltas at a time, never the graph.

``compressed_block_sums_exact`` and ``compressed_spmv_vertex_ref`` are the
JAX package's oracles (its ``compressed_block_spmv_ref(c, ...)`` and
``compressed_spmv_vertex_ref``): the exact decode, exception list included.
The wrappers take the first for an exception-dense graph, as the JAX
package does.
"""
from __future__ import annotations

import torch

from ...core.compressed import CompressedCSR, decode_block_range
from ...core.graph_filter import unpack_word_bits
from ...core.primitives import INF_I32, segment_reduce, take_fill
from ...tuning.defaults import DEFAULT_DENSE_RANGE_BLOCKS


def compressed_chunked_spmv_ref(
    x: torch.Tensor | None,        # (n_pad,) / (B, n_pad) for "sums"; None for "decode"
    ids: torch.Tensor,             # (C,) — compacted live block ids (pad: >= NB)
    block_first: torch.Tensor,     # (NB,) int32
    deltas: torch.Tensor,          # (NB, FB) int16 bit-view of the uint16 codes
    valid_count: torch.Tensor,     # (NB,) int16 bit-view
    bits: torch.Tensor | None = None,           # (NB, FB//32) int32 graphFilter words
    edge_active: torch.Tensor | None = None,    # (NB, FB//32) int32 traversal mask
    block_weights: torch.Tensor | None = None,  # (NB, FB) float32
    *,
    n: int,
    emit: str = "sums",
):
    """``emit="decode"`` → (dst (C, FB) int32, w (C, FB) float32);
    ``emit="sums"`` → (C,) for a 1-D ``x``, (C, B) for a (B, n_pad) ``x``."""
    if emit not in ("sums", "decode"):
        raise ValueError(f"emit must be 'sums' or 'decode', got {emit!r}")
    NB, FB = deltas.shape
    ids = ids.long()
    pad = (ids < 0) | (ids >= NB)
    rows = torch.where(pad, 0, ids)
    d = deltas[rows].to(torch.int32) & 0xFFFF
    d[:, 0] = 0
    dst = block_first[rows][:, None] + torch.cumsum(d, dim=1, dtype=torch.int32)
    vc = torch.where(pad, 0, valid_count[rows].to(torch.int32) & 0xFFFF)
    lane = torch.arange(FB, device=deltas.device)
    mask = lane[None, :] < vc[:, None]
    if bits is not None:
        mask = mask & unpack_word_bits(bits[rows])
    if edge_active is not None:
        mask = mask & unpack_word_bits(edge_active[rows])
    live = mask & (dst < n)

    if block_weights is not None:
        w = torch.where(pad[:, None], 0.0, block_weights[rows])
    else:
        w = None
    if emit == "decode":
        if w is None:
            w = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
        return torch.where(live, dst, n), w

    safe = torch.where(live, dst, 0).long()
    if x.dim() == 2:
        xv = x[:, safe]                                   # (B, C, FB)
        if w is not None:
            xv = xv * w[None]
        contrib = torch.where(mask[None], xv, 0)
        return contrib.sum(dim=2, dtype=contrib.dtype).T.to(x.dtype)
    xv = x[safe]
    if w is not None:
        xv = xv * w
    contrib = torch.where(mask, xv, 0)
    return contrib.sum(dim=1, dtype=contrib.dtype).to(x.dtype)


def compressed_block_spmv_ref(
    x: torch.Tensor,               # (n_pad,) / (B, n_pad), float32 or int32
    block_first: torch.Tensor,     # (NB,) int32
    deltas: torch.Tensor,          # (NB, FB) int16 bit-view of the uint16 codes
    valid_count: torch.Tensor,     # (NB,) int16 bit-view
    bits: torch.Tensor | None,     # (NB, FB//32) int32 graphFilter words
    edge_active: torch.Tensor | None = None,    # (NB, FB//32) int32 traversal mask
    block_weights: torch.Tensor | None = None,  # (NB, FB) float32
    *,
    n: int,
) -> torch.Tensor:
    """Per-block sums of every block, (NB,) or (NB, B): the chunked sums over
    the ids of one range of blocks at a time."""
    NB = deltas.shape[0]
    parts = []
    for lo in range(0, NB, DEFAULT_DENSE_RANGE_BLOCKS):
        ids = torch.arange(lo, min(NB, lo + DEFAULT_DENSE_RANGE_BLOCKS), device=deltas.device)
        parts.append(compressed_chunked_spmv_ref(
            x, ids, block_first, deltas, valid_count, bits, edge_active, block_weights,
            n=n, emit="sums",
        ))
    return torch.cat(parts)


def round_map(map_kind: str, xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The maps a fused round knows: ``"identity"`` (BFS) and
    ``"sat_add_i32"`` (wBFS: ``xs + trunc(w)``, saturating at
    ``INF_I32 - 2**24``)."""
    if map_kind == "identity":
        return xs
    if map_kind == "sat_add_i32":
        return torch.where(xs >= INF_I32 - (1 << 24), INF_I32, xs + w.to(torch.int32))
    raise ValueError(f"no fused round for map {map_kind!r}")


def compressed_stream_round_ref(
    x: torch.Tensor,               # (n,) / (B, n) int32 vertex state
    frontier: torch.Tensor,        # (n,) / (B, n) bool
    block_src: torch.Tensor,       # (NB,) int32
    block_first: torch.Tensor,     # (NB,) int32
    deltas: torch.Tensor,          # (NB, FB) int16 bit-view of the uint16 codes
    valid_count: torch.Tensor,     # (NB,) int16 bit-view
    edge_active: torch.Tensor | None = None,    # (NB, FB//32) int32 traversal mask
    block_weights: torch.Tensor | None = None,  # (NB, FB) float32
    exc_row: torch.Tensor | None = None,        # (NB,) int32: row of exact_rows, or -1
    exact_rows: torch.Tensor | None = None,     # (rows, FB) int32, masked, sentinel n
    *,
    n: int,
    map_kind: str,
    map_lanes: torch.Tensor | None = None,      # (B,) bool: queries the map applies to
):
    """One ``sparse_streamed`` round of min over int32 → ``(out, touched)``,
    (n,) each, or (B, n) for a batch: for every block whose owner a query's
    frontier holds, every masked-in slot contributes ``map(x[owner], w)`` to
    ``out[dst]`` (min, identity ``INF_I32``) and sets ``touched[dst]``.  A
    block with ``exc_row >= 0`` takes its targets from that exact row; a
    block owned by the sentinel ``n`` (a shard's padding) is never live.
    Walks every block, one range at a time, and masks the dead ones."""
    batched = x.dim() == 2
    xb, fb = (x, frontier) if batched else (x[None], frontier[None])
    B, NB = xb.shape[0], deltas.shape[0]
    out = torch.full((n + 1, B), INF_I32, dtype=torch.int32, device=x.device)
    touched = torch.zeros((n + 1, B), dtype=torch.bool, device=x.device)
    R = max(1, DEFAULT_DENSE_RANGE_BLOCKS // B)
    for lo in range(0, NB, R):
        ids = torch.arange(lo, min(NB, lo + R), device=deltas.device)
        dst, w = compressed_chunked_spmv_ref(None, ids, block_first, deltas, valid_count,
                                             None, edge_active, block_weights, n=n,
                                             emit="decode")
        if exc_row is not None:
            r = exc_row[ids].long()
            dst = torch.where((r >= 0)[:, None], exact_rows[r.clamp(min=0)], dst)
        src = block_src[ids].long()
        owned = src < n                     # owner n: a shard's pad block, never live
        src = torch.where(owned, src, 0)
        valid = (dst >= 0) & (dst < n)
        act = (fb[:, src] & owned)[:, :, None] & valid[None]          # (B, R, FB)
        xs = xb[:, src][:, :, None].expand(act.shape)
        vals = round_map(map_kind, xs, w[None])
        if map_lanes is not None:
            vals = torch.where(map_lanes[:, None, None], vals, xs)
        vals = torch.where(act, vals, INF_I32).reshape(B, -1)
        route = torch.where(valid, dst, n).reshape(-1)
        out = torch.minimum(out, segment_reduce(vals.T, route, n + 1, "min"))
        touched |= segment_reduce(act.reshape(B, -1).T, route, n + 1, "or")
    out, touched = out[:n], touched[:n]
    return (out.T, touched.T) if batched else (out[:, 0], touched[:, 0])


def exact_block_sums(c: CompressedCSR, dst, bids, x, bits, weights=None, active=None):
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


def compressed_block_sums_exact(c: CompressedCSR, x, bits, weights=None, active=None):
    """Exact per-block sums of every block, (NB,) or (NB, B), decoded (with
    the exception list) one range of blocks at a time."""
    NB = c.num_blocks
    parts = []
    for lo in range(0, NB, DEFAULT_DENSE_RANGE_BLOCKS):
        hi = min(NB, lo + DEFAULT_DENSE_RANGE_BLOCKS)
        bids = torch.arange(lo, hi, device=c.device)
        parts.append(exact_block_sums(c, decode_block_range(c, lo, hi), bids, x, bits,
                                      weights, active))
    return torch.cat(parts)


def compressed_spmv_vertex_ref(c: CompressedCSR, x, bits, weights=None, active=None):
    """``out[v] = Σ_{(v,u) active} w_vu · x[u]`` from the exact decode:
    (n,) for a 1-D ``x``, (B, n) for a (B, n) batch."""
    per_block = compressed_block_sums_exact(c, x, bits, weights, active)
    out = segment_reduce(per_block, c.block_src, c.n + 1, "sum")[: c.n]
    return out.T if x.dim() == 2 else out
