"""edgeMap / edgeMapChunked (§4.1) — PSAM-efficient frontier expansion.

Four execution modes, mirroring the paper:

* ``dense``  — the pull-style pass over *all* edge slots, walked one range
  of blocks at a time (``DEFAULT_DENSE_RANGE_BLOCKS``) so a compressed
  graph is never decoded whole.  Work O(m).
* ``sparse`` — EDGEMAPCHUNKED: only blocks owned by frontier vertices are
  touched.  The active block list is O(n) words, and blocks are processed
  in fixed-size chunks so the peak intermediate is ``chunk_blocks × F_B``.
* ``sparse_streamed`` — the same chunk loop, but on a ``CompressedCSR``
  backend each chunk's tile comes from the frontier-sparse kernel
  (``repro_torch.kernels.compressed_spmv``), which reads only the live
  blocks' compressed bytes.  On the card a round of min over int32 with a
  map the kernel knows (``kernel_map``: BFS's identity, wBFS's saturating
  add) is one launch instead (``stream_round_route``), the chunk loop
  fused into it.  Raw ``CSRGraph`` backends and exception-dense compressed
  graphs run plain ``sparse`` — identical results either way.
* ``auto``   — Beamer direction optimization: dense when the frontier's
  incident-edge count exceeds ``m / dense_frac``.

Semantics (Ligra): ``out[v] = monoid over {map_fn(x[u], w_uv) : u∈frontier,
(u,v) active}``, plus a ``touched`` mask (v received ≥1 contribution).

The loops are Python loops: the chunk count is read on the host once per
call (not on the fused route), and the Beamer choice is an ``if`` on a
host-read predicate.
``edgemap_reduce_batched`` runs B queries through one sweep: the edge
stream is read once per round and fanned across the B state columns.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..device import kernel_route
from ..obs import get_registry
from ..tuning.defaults import (
    DEFAULT_CHUNK_BLOCKS,
    DEFAULT_DENSE_FRAC,
    DEFAULT_DENSE_RANGE_BLOCKS,
)
from .backend import GraphLike, dense_block_view, tile_block_view
from .graph_filter import edge_active_words, unpack_word_bits
from .primitives import compact_mask, monoid_identity, segment_reduce, take_fill
from .vertex_subset import VertexSubset


def _identity_map(x_src, w):
    del w
    return x_src


# the fused round's name for this map (``stream_round_route``)
_identity_map.kernel_map = "identity"


def _words(g: GraphLike, edge_active):
    """Any edge-activity form → packed int32 (NB, F_B/32) words, or None."""
    return None if edge_active is None else edge_active_words(edge_active, g.block_size)


def _take_cols(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr[:, idx]`` with ``fill`` where idx is out of range."""
    return take_fill(arr.T, idx, fill).T


class _Stream(NamedTuple):
    """A streaming backend's two routes through a ``sparse_streamed`` round."""

    tile: Callable   # bids -> (dst, w): one chunk of the chunk loop
    round: Callable  # (frontier, x, kernel_map, map_lanes=None) -> (out, touched)


def stream_round_route(device, monoid: str, map_fn: Callable, dtype) -> str:
    """The route of a ``sparse_streamed`` round on a streaming backend:
    ``"fused"`` (one ``compressed_stream_round`` launch for the whole round)
    or ``"chunks"`` (the chunk loop over ``compressed_chunked_spmv`` tiles,
    the fused round's plain version).  A function of these four alone:
    fused on the card, for ``min`` over int32 with a map whose
    ``kernel_map`` tag the kernel knows."""
    from ..kernels.compressed_spmv import ROUND_MAPS

    fused = (kernel_route(device) == "cuda" and monoid == "min" and dtype == torch.int32
             and getattr(map_fn, "kernel_map", None) in ROUND_MAPS)
    return "fused" if fused else "chunks"


def _streaming_decoder(g: GraphLike, edge_active) -> _Stream | None:
    """The kernel-backed routes of the ``sparse_streamed`` mode, or None.

    ``tile(bids) -> (dst, w)`` reads ONLY the named blocks, with the packed
    ``edge_active`` words folded into ``dst`` (masked slots come back as the
    sentinel ``n``); ``round`` runs the whole round in one launch.  None when
    the backend has no streaming decoder: a raw ``CSRGraph`` or an
    exception-dense ``CompressedCSR``."""
    from .compressed import CompressedCSR, exception_dense

    if not isinstance(g, CompressedCSR) or exception_dense(g):
        return None
    # lazy import: kernels depend on core, never the other way around
    from ..kernels.compressed_spmv.ops import (
        _exception_row_targets,
        compressed_chunked_stream_tile,
        compressed_stream_round_graph,
    )

    words = _words(g, edge_active)
    # exception rows are id-independent: decode them once per call
    exact = _exception_row_targets(g, words) if g.n_exceptions else None

    def tile(bids):
        return compressed_chunked_stream_tile(g, bids, words, exact_rows=exact)

    def round_(frontier, x, kernel_map, map_lanes=None):
        return compressed_stream_round_graph(g, frontier, x, words, map_kind=kernel_map,
                                             exact_rows=exact, map_lanes=map_lanes)

    return _Stream(tile, round_)


def _combine(monoid, a, b):
    if monoid == "sum":
        return a + b
    if monoid == "min":
        return torch.minimum(a, b)
    if monoid == "max":
        return torch.maximum(a, b)
    if monoid == "or":
        return a | b
    raise ValueError(monoid)


def _out0(monoid, shape, dtype, device):
    if monoid == "or":
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.full(shape, monoid_identity(monoid, dtype).item(), dtype=dtype,
                      device=device)


def edgemap_dense(
    g: GraphLike,
    frontier_mask: torch.Tensor,
    x: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    edge_active=None,
):
    """Pull-style pass over all edge slots.  Returns (out[n,...], touched[n])."""
    n, NB, FB = g.n, g.num_blocks, g.block_size
    ident = monoid_identity(monoid, x.dtype).item()
    feat = tuple(x.shape[1:])
    words = _words(g, edge_active)
    frontier_blk = take_fill(frontier_mask, g.block_src, False)
    xs_blk = take_fill(x, g.block_src, ident)
    out = _out0(monoid, (n + 1,) + feat, x.dtype, x.device)
    touched = torch.zeros(n + 1, dtype=torch.bool, device=x.device)
    R = DEFAULT_DENSE_RANGE_BLOCKS
    for lo in range(0, NB, R):
        hi = min(NB, lo + R)
        block_dst, block_w = dense_block_view(g, lo, hi)
        act = frontier_blk[lo:hi, None] & (block_dst < n)
        if words is not None:
            act = act & unpack_word_bits(words[lo:hi])
        xs = xs_blk[lo:hi, None].expand((hi - lo, FB) + feat)
        vals = map_fn(xs, block_w if not feat else block_w[..., None])
        sel = act.reshape(act.shape + (1,) * (vals.dim() - act.dim()))
        vals = torch.where(sel, vals, ident)
        ids = torch.where(act, block_dst, n).reshape(-1)
        flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
        out = _combine(monoid, out, segment_reduce(flat, ids, n + 1, monoid))
        touched.index_fill_(0, ids.long(), True)  # inactive slots land on row n
    return out[:n], touched[:n]


def edgemap_chunked(
    g: GraphLike,
    frontier_mask: torch.Tensor,
    x: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    edge_active=None,
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
    streamed: bool = False,
):
    """EDGEMAPCHUNKED — only frontier-owned blocks, chunked emission.

    With ``streamed=True`` (the ``sparse_streamed`` mode) a ``CompressedCSR``
    backend takes each chunk's tile from the frontier-sparse kernel, one
    launch per chunk of ``chunk_blocks`` live ids, so the bytes read track
    the live count, not NB; where ``stream_round_route`` says ``"fused"``
    the whole round is one launch and ``chunk_blocks`` plays no part.
    Results are bit-identical to the un-streamed path; backends without a
    streaming decoder ignore the flag.
    """
    n, NB, FB = g.n, g.num_blocks, g.block_size
    C = min(chunk_blocks, NB)
    nchunks = -(-NB // C)
    ident = monoid_identity(monoid, x.dtype).item()
    feat = tuple(x.shape[1:])

    stream = _streaming_decoder(g, edge_active) if streamed else None
    if (stream is not None and not feat
            and stream_round_route(x.device, monoid, map_fn, x.dtype) == "fused"):
        # the whole round in one launch, no live count read on the host
        return stream.round(frontier_mask, x, map_fn.kernel_map)
    words = _words(g, edge_active) if stream is None else None

    blk_act = take_fill(frontier_mask, g.block_src, False)
    idx, k = compact_mask(blk_act, fill=NB)  # O(n) words: NB = O(n) by F_B=d_avg
    idx = torch.nn.functional.pad(idx, (0, nchunks * C - NB), value=NB)

    out = _out0(monoid, (n + 1,) + feat, x.dtype, x.device)
    touched = torch.zeros(n + 1, dtype=torch.bool, device=x.device)

    for lo in range(0, k, C):
        bids = idx[lo : lo + C]
        if stream is not None:
            # frontier-sparse kernel: ONLY these C blocks are read; filter
            # bits already folded (masked slots → n)
            dsts, ws = stream.tile(bids)
            act = dsts < n
        else:
            # per-backend tile view; compressed backends decode here, inside
            # the chunk loop, so the peak intermediate stays C × F_B words
            dsts, ws = tile_block_view(g, bids)
            act = dsts < n
            if words is not None:
                act = act & unpack_word_bits(take_fill(words, bids, 0))
        srcs = take_fill(g.block_src, bids, n)
        xs = take_fill(x, srcs, ident)
        xs = xs[:, None].expand((C, FB) + feat)
        vals = map_fn(xs, ws if not feat else ws[..., None])
        sel = act if not feat else act[..., None]
        vals = torch.where(sel, vals, ident)
        ids = torch.where(act, dsts, n).reshape(-1)
        flat = vals.reshape((C * FB,) + feat)
        out = _combine(monoid, out, segment_reduce(flat, ids, n + 1, monoid))
        touched.index_fill_(0, ids.long(), True)
    return out[:n], touched[:n]


def _resolve_knobs(plan, mode, dense_frac, chunk_blocks, auto_sparse, batched):
    if plan is not None:
        mode = plan.resolve_mode(mode)
        if dense_frac is None:
            dense_frac = plan.dense_frac_batched if batched else plan.dense_frac
        chunk_blocks = plan.chunk_blocks if chunk_blocks is None else chunk_blocks
        if auto_sparse is None:
            auto_sparse = plan.auto_sparse_batched if batched else plan.auto_sparse
    dense_frac = DEFAULT_DENSE_FRAC if dense_frac is None else dense_frac
    chunk_blocks = DEFAULT_CHUNK_BLOCKS if chunk_blocks is None else chunk_blocks
    auto_sparse = "sparse" if auto_sparse is None else auto_sparse
    return mode, dense_frac, chunk_blocks, auto_sparse


def edgemap_reduce(
    g: GraphLike,
    frontier_mask: torch.Tensor,
    x: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    edge_active=None,
    mode: str = "auto",
    dense_frac: float | None = None,
    chunk_blocks: int | None = None,
    auto_sparse: str | None = None,
    plan=None,
):
    """Direction-optimized edgeMap (Beamer §4.1.1).

    ``mode`` is ``'dense' | 'sparse' | 'sparse_streamed' | 'auto'``.  With
    ``plan`` (an ``ExecutionPlan``) the plan's strategy and knobs apply;
    explicit ``mode`` / ``dense_frac`` / ``chunk_blocks`` arguments win.  A
    mesh plan runs the sharded executor (``core.plan``), which runs this
    body on every shard of the plan-prepared ``ShardedGraph`` ``g``.
    """
    if plan is not None and plan.is_sharded:
        from .plan import sharded_edgemap_reduce

        return sharded_edgemap_reduce(
            plan, g, frontier_mask, x, monoid=monoid, map_fn=map_fn,
            edge_active=edge_active, mode=mode, dense_frac=dense_frac,
            chunk_blocks=chunk_blocks, auto_sparse=auto_sparse,
        )
    mode, dense_frac, chunk_blocks, auto_sparse = _resolve_knobs(
        plan, mode, dense_frac, chunk_blocks, auto_sparse, batched=False
    )
    reg = get_registry()
    if reg.enabled:
        reg.counter(
            "sage_edgemap_calls_total",
            "eager edgemap_reduce dispatches by resolved mode",
            labels=("mode",),
        ).inc(mode=mode)
    return _edgemap_reduce_local(
        g, frontier_mask, x, monoid=monoid, map_fn=map_fn, edge_active=edge_active,
        mode=mode, dense_frac=dense_frac, chunk_blocks=chunk_blocks,
        auto_sparse=auto_sparse,
    )


def _edgemap_reduce_local(g, frontier_mask, x, *, monoid, map_fn, mode, dense_frac,
                          chunk_blocks, auto_sparse, edge_active=None):
    """``edgemap_reduce``'s body on one device, its knobs resolved; the
    sharded executor runs it on every shard."""
    dense = dict(monoid=monoid, map_fn=map_fn, edge_active=edge_active)
    if mode == "dense":
        return edgemap_dense(g, frontier_mask, x, **dense)
    if mode in ("sparse", "sparse_streamed"):
        return edgemap_chunked(
            g, frontier_mask, x, **dense, chunk_blocks=chunk_blocks,
            streamed=mode == "sparse_streamed",
        )
    sum_deg = torch.where(frontier_mask, g.degrees, 0).sum()
    if bool(sum_deg.to(torch.float32) * dense_frac > g.m):
        return edgemap_dense(g, frontier_mask, x, **dense)
    return edgemap_chunked(
        g, frontier_mask, x, **dense, chunk_blocks=chunk_blocks,
        streamed=auto_sparse == "sparse_streamed",
    )


def edgemap_dense_batched(
    g: GraphLike,
    frontier_masks: torch.Tensor,
    xb: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    edge_active=None,
    map_lanes: torch.Tensor | None = None,
):
    """Dense pull pass, B queries per sweep.  Returns (out[B,n], touched[B,n]).

    The edge-side work (block view, validity/filter masks, scatter routing)
    is computed once per range and the monoid reduction runs over B-wide
    value rows.  Per-lane inactive slots contribute the monoid identity at
    their real target row, which reduces to the same value: every lane is
    bit-identical to its own ``edgemap_dense`` run.  ``map_lanes`` (bool[B])
    applies ``map_fn`` only on the selected lanes; the rest pass ``xs``
    through (the cross-op batching hook).
    """
    n, NB, FB = g.n, g.num_blocks, g.block_size
    B = xb.shape[0]
    ident = monoid_identity(monoid, xb.dtype).item()
    words = _words(g, edge_active)
    frontier_blk = _take_cols(frontier_masks, g.block_src, False)   # (B, NB)
    xs_blk = _take_cols(xb, g.block_src, ident)                    # (B, NB)
    out = _out0(monoid, (n + 1, B), xb.dtype, xb.device)
    hits = torch.zeros((n + 1, B), dtype=torch.int32, device=xb.device)
    R = max(1, DEFAULT_DENSE_RANGE_BLOCKS // B)
    for lo in range(0, NB, R):
        hi = min(NB, lo + R)
        block_dst, block_w = dense_block_view(g, lo, hi)
        valid = block_dst < n
        ids = torch.where(valid, block_dst, n).reshape(-1)         # shared routing
        if words is not None:
            valid = valid & unpack_word_bits(words[lo:hi])
        act = (frontier_blk[:, lo:hi, None] & valid[None]).reshape(B, -1)
        xs = xs_blk[:, lo:hi, None].expand(B, hi - lo, FB).reshape(B, -1)
        vals = map_fn(xs, block_w.reshape(1, -1))
        if map_lanes is not None:
            vals = torch.where(map_lanes[:, None], vals, xs)
        vals = torch.where(act, vals, ident)
        out = _combine(monoid, out, segment_reduce(vals.T, ids, n + 1, monoid))
        hits.index_add_(0, ids, act.T.to(torch.int32))
    return out[:n].T, (hits[:n] > 0).T


def edgemap_chunked_batched_streamed(
    g: GraphLike,
    frontier_masks: torch.Tensor,
    xb: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    edge_active=None,
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
    map_lanes: torch.Tensor | None = None,
):
    """Batched EDGEMAPCHUNKED over the streaming kernel: B queries, one
    compressed-tile read per live block.

    The live set is the UNION of the per-lane frontiers' blocks, compacted
    once; each chunk is decoded by the kernel exactly once and fanned
    across the B lanes — lanes for which a block is dead contribute the
    monoid identity.  Per-lane results equal the single-query streamed runs
    exactly for int/min/max/or state.  Where ``stream_round_route`` says
    ``"fused"`` the whole round is one launch.
    """
    n, NB, FB = g.n, g.num_blocks, g.block_size
    B = xb.shape[0]
    C = min(chunk_blocks, NB)
    nchunks = -(-NB // C)
    ident = monoid_identity(monoid, xb.dtype).item()

    stream = _streaming_decoder(g, edge_active)
    assert stream is not None, "caller guards on _streaming_decoder"
    if stream_round_route(xb.device, monoid, map_fn, xb.dtype) == "fused":
        return stream.round(frontier_masks, xb, map_fn.kernel_map, map_lanes)

    frontier_blk = _take_cols(frontier_masks, g.block_src, False)   # (B, NB)
    idx, k = compact_mask(frontier_blk.any(dim=0), fill=NB)         # union live set
    idx = torch.nn.functional.pad(idx, (0, nchunks * C - NB), value=NB)

    out = _out0(monoid, (n + 1, B), xb.dtype, xb.device)
    hits = torch.zeros((n + 1, B), dtype=torch.int32, device=xb.device)
    for lo in range(0, k, C):
        bids = idx[lo : lo + C]
        dsts, ws = stream.tile(bids)                    # decoded ONCE for all B
        srcs = take_fill(g.block_src, bids, n)          # (C,)
        act_sh = dsts < n                               # shared: filter folded
        lane_blk = _take_cols(frontier_masks, srcs, False)              # (B, C)
        xs = _take_cols(xb, srcs, ident)[:, :, None].expand(B, C, FB)
        vals = map_fn(xs, ws[None])
        if map_lanes is not None:
            vals = torch.where(map_lanes[:, None, None], vals, xs)
        act = lane_blk[:, :, None] & act_sh[None]       # (B, C, FB)
        vals = torch.where(act, vals, ident).reshape(B, C * FB)
        ids = torch.where(act_sh, dsts, n).reshape(-1)  # shared scatter routing
        out = _combine(monoid, out, segment_reduce(vals.T, ids, n + 1, monoid))
        hits.index_add_(0, ids, act.reshape(B, -1).T.to(torch.int32))
    return out[:n].T, (hits[:n] > 0).T


def edgemap_reduce_batched(
    g: GraphLike,
    frontier_masks: torch.Tensor,
    xb: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    edge_active=None,
    mode: str = "auto",
    dense_frac: float | None = None,
    chunk_blocks: int | None = None,
    auto_sparse: str | None = None,
    flavor_crossover: float | None = None,
    plan=None,
    map_lanes: torch.Tensor | None = None,
):
    """Batched edgeMap: B concurrent queries share ONE edge sweep.

    ``frontier_masks`` is bool[B, n], ``xb`` is [B, n]; returns
    ``(out[B, n], touched[B, n])``, each lane bit-identical to its own
    ``edgemap_reduce`` run.  ``map_lanes`` (bool[B]) applies ``map_fn`` only
    on the selected lanes.  The dense strategy runs one shared sweep; the
    sparse strategy runs each lane's chunk loop (the JAX package vmaps it);
    ``sparse_streamed`` runs one union live-block loop through the kernel;
    ``auto`` takes ONE Beamer decision on the batch's aggregate density.
    When its sparse branch would stream, a measured ``flavor_crossover``
    (the plan's ``batched_flavor_crossover`` unless given) switches to the
    per-lane chunk loops once the batch's mean lane density
    ``Σ sum_deg / (B·m)`` reaches it; the switch is taken on the host.
    Plans resolve the batched knobs (``dense_frac_batched``,
    ``auto_sparse_batched``, ``batched_flavor_crossover``); a mesh plan runs
    this body on every shard and combines the O(B·n) outputs.
    """
    if plan is not None and plan.is_sharded:
        from .plan import sharded_edgemap_reduce_batched

        return sharded_edgemap_reduce_batched(
            plan, g, frontier_masks, xb, monoid=monoid, map_fn=map_fn,
            edge_active=edge_active, mode=mode, dense_frac=dense_frac,
            chunk_blocks=chunk_blocks, auto_sparse=auto_sparse, map_lanes=map_lanes,
        )
    mode, dense_frac, chunk_blocks, auto_sparse = _resolve_knobs(
        plan, mode, dense_frac, chunk_blocks, auto_sparse, batched=True
    )
    if flavor_crossover is None and plan is not None:
        flavor_crossover = plan.batched_flavor_crossover
    if xb.dim() != 2:
        raise NotImplementedError("batched vertex state with feature dims is not ported")
    B = xb.shape[0]
    common = dict(monoid=monoid, map_fn=map_fn, edge_active=edge_active)

    def dense_all():
        return edgemap_dense_batched(g, frontier_masks, xb, **common, map_lanes=map_lanes)

    def sparse_lanes():
        outs, touched = [], []
        for q in range(B):
            fn = map_fn
            if map_lanes is not None and not bool(map_lanes[q]):
                fn = _identity_map
            o, t = edgemap_chunked(
                g, frontier_masks[q], xb[q], monoid=monoid, map_fn=fn,
                edge_active=edge_active, chunk_blocks=chunk_blocks,
            )
            outs.append(o)
            touched.append(t)
        return torch.stack(outs), torch.stack(touched)

    def streamed_or_lanes():
        if _streaming_decoder(g, edge_active) is None:
            return sparse_lanes()
        return edgemap_chunked_batched_streamed(
            g, frontier_masks, xb, **common, chunk_blocks=chunk_blocks,
            map_lanes=map_lanes,
        )

    if mode == "dense":
        return dense_all()
    if mode == "sparse_streamed":
        return streamed_or_lanes()
    if mode == "sparse":
        return sparse_lanes()
    # auto: ONE Beamer predicate for the whole batch, on the aggregate density
    sum_deg = torch.where(frontier_masks, g.degrees[None, :], 0).sum()
    if bool(sum_deg.to(torch.float32) * dense_frac > B * g.m):
        return dense_all()
    if auto_sparse != "sparse_streamed":
        return sparse_lanes()
    if flavor_crossover is not None and flavor_crossover < 1.0:
        # the measured flavor switch: the shared live-block loop wins only
        # while the union frontier is sparse, at the batch's mean lane density
        mean_density = sum_deg.to(torch.float32) / (B * g.m)
        if not bool(mean_density < flavor_crossover):
            return sparse_lanes()
    return streamed_or_lanes()


def _apply_update(update, x, out, ok):
    if update == "min":
        return torch.where(ok, torch.minimum(x, out), x), ok & (out < x)
    if update == "max":
        return torch.where(ok, torch.maximum(x, out), x), ok & (out > x)
    if update == "sum":
        return torch.where(ok, x + out, x), ok
    if update == "replace":
        return torch.where(ok, out, x), ok
    raise ValueError(update)


def edge_map_batched(
    g: GraphLike,
    frontier_masks: torch.Tensor,
    xb: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    cond_masks: torch.Tensor | None = None,
    update: str = "min",
    edge_active=None,
    mode: str = "auto",
    plan=None,
    map_lanes: torch.Tensor | None = None,
):
    """Batched Ligra-style EDGEMAP: returns (new_x[B, n], next_masks[B, n])."""
    out, touched = edgemap_reduce_batched(
        g, frontier_masks, xb, monoid=monoid, map_fn=map_fn,
        edge_active=edge_active, mode=mode, plan=plan, map_lanes=map_lanes,
    )
    ok = touched if cond_masks is None else (touched & cond_masks)
    return _apply_update(update, xb, out, ok)


def edge_map(
    g: GraphLike,
    frontier: VertexSubset,
    x: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn: Callable = _identity_map,
    cond_mask: torch.Tensor | None = None,
    update: str = "min",
    edge_active=None,
    mode: str = "auto",
    plan=None,
):
    """Full Ligra-style EDGEMAP: returns (new_x, next_frontier).

    ``cond_mask[v]`` plays C(v); ``update`` decides how reduced contributions
    merge into x ('min'|'max'|'sum'|'replace')."""
    out, touched = edgemap_reduce(
        g, frontier.mask, x, monoid=monoid, map_fn=map_fn, edge_active=edge_active,
        mode=mode, plan=plan,
    )
    ok = touched if cond_mask is None else (touched & cond_mask)
    new_x, changed = _apply_update(update, x, out, ok)
    return new_x, VertexSubset(mask=changed, n=g.n)
