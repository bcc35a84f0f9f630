"""Execution planner — where and how an edgeMap runs, and the round loop.

An :class:`ExecutionPlan` names the device mesh (or none), the storage
backend, the dense/sparse/auto strategy and its knobs, the cross-shard
reduce, and the kernel route (``"cuda"`` or ``"torch"``, resolved from the
graph's device).  ``edgemap_reduce`` / ``edge_map`` and the algorithms
accept one via ``plan=``, so algorithm code never picks an engine.
``make_plan`` takes its knobs from a ``TuningTable`` measured on the card
(the shipped one by default, for ``strategy="auto"``) or from the constants.

Sharded execution reuses the single-device bodies unchanged: each shard
(``GraphBackend.shard``: a block-range split, compressed blocks with their
own exception lists) is a valid backend over the global vertex space, on
its mesh device (``repro_torch.core.mesh``).  The executor runs the local
``edgemap_reduce`` / ``edgemap_reduce_batched`` on every shard with the
frontier and vertex state replicated, then combines the O(n) outputs by the
monoid on ``mesh.devices[0]`` — never O(m) words, the PSAM small-memory
bound as a communication bound (§5.2).  GraphFilter words partition like
the blocks (``shard_edge_active``).

``round_loop`` owns the frontier recurrence every traversal shares::

    while cond_fn(state):
        state, frontier, x = sweep_inputs(state)
        out, touched = edgeMap(g, frontier, x)
        state = epilogue(state, out, touched)

as a Python loop on the host-read predicate, on every plan.  A sharded
plan's ``pipeline_rounds`` is kept for parity with the JAX package, whose
skewed schedule lets XLA overlap round r's combine with round r+1's local
sweeps inside one program; run eagerly on the host the skew issues the same
calls in the same order, so the flag runs the sequential loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import kernel_route, resolve_device
from ..obs import get_registry
from ..tuning.defaults import DEFAULT_CHUNK_BLOCKS, DEFAULT_DENSE_FRAC
from ..tuning.table import TuningTable, constants_decision, default_table
from .compressed import CompressedCSR, exception_dense
from .csr import CSRGraph, graph_spec, sharded_block_counts
from .graph_filter import edge_active_words
from .mesh import ShardMesh

REDUCE_MODES = ("flat", "hierarchical")


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """A graph backend split into per-shard block sets.

    ``shards`` lists one ``CSRGraph`` / ``CompressedCSR`` per shard, each on
    its mesh device; each describes one shard (``num_blocks`` is the
    per-shard block count; ``n``, ``m`` and ``degrees`` stay global).
    ``orig_num_blocks`` is the block count before the split, against which
    filter words are validated exactly.  Made by
    :meth:`ExecutionPlan.prepare`, run by the sharded executor.
    """

    shards: list
    num_shards: int
    orig_num_blocks: int | None = None

    @property
    def n(self) -> int:
        return self.shards[0].n

    @property
    def m(self) -> int:
        return self.shards[0].m

    @property
    def block_size(self) -> int:
        return self.shards[0].block_size

    @property
    def blocks_per_shard(self) -> int:
        return self.shards[0].num_blocks

    @property
    def degrees(self) -> torch.Tensor:
        """int32[n] — the replicated vertex degrees (shard 0's copy)."""
        return self.shards[0].degrees

    @property
    def device(self) -> torch.device:
        """Where the combined outputs land: shard 0's device."""
        return self.shards[0].device


@dataclasses.dataclass(frozen=True)
class ShardedEdgeActive:
    """Shard-local filter state: packed int32 words, stacked by shard.

    ``words`` is int32[num_shards, blocks_per_shard, F_B/32]; shard s's rows
    line up 1:1 with shard s of the matching ``ShardedGraph`` (the same
    block-range split, zero-padded tail).  ``live_ids`` (optional) records a
    live-block compaction (``prepare(..., compact_live=True)``):
    int32[num_shards, blocks_per_shard] *original* block ids, padded with
    the pre-compaction block count — an audit trail, never read by the
    executor.
    """

    words: torch.Tensor
    num_shards: int
    live_ids: torch.Tensor | None = None

    @property
    def blocks_per_shard(self) -> int:
        return self.words.shape[1]


def compact_live_blocks(g, edge_active):
    """Drop the blocks with no active slot under ``edge_active`` (§4.2.2's
    empty-block compaction, applied physically, before any shard split).

    Returns ``(g_live, words_live, live_ids)``: the same backend type over
    the live blocks only (``n``, ``m`` and ``degrees`` untouched; a
    ``CompressedCSR`` keeps the exceptions of live blocks, re-keyed to
    their compacted positions, and pins the whole graph's
    ``exception_dense`` verdict), their packed words (int32[k, F_B/32]),
    and their original ids (int32[k]).  A filter with no live block
    leaves one all-dead block.  Runs in torch ops on the graph's device.
    """
    words = edge_active_words(edge_active, g.block_size)
    if words.shape[0] != g.num_blocks:
        raise ValueError(
            f"edge_active covers {words.shape[0]} blocks, graph has "
            f"{g.num_blocks} — was the filter built for a different graph?"
        )
    live = torch.nonzero((words != 0).any(dim=1)).reshape(-1)
    if live.numel() == 0:
        # keep shapes non-degenerate: one block, fully masked off
        live = torch.zeros(1, dtype=torch.int64, device=words.device)
        words = torch.zeros_like(words)
    live_ids = live.to(torch.int32)
    words_live = words[live]
    if isinstance(g, CompressedCSR):
        eb = g.exc_block.long()
        pos = torch.full((g.num_blocks + 1,), -1, dtype=torch.int64, device=eb.device)
        pos[live] = torch.arange(live.numel(), device=eb.device)
        keep = pos[eb.clamp(0, g.num_blocks)] >= 0
        g_live = dataclasses.replace(
            g,
            block_first=g.block_first[live],
            deltas=g.deltas[live],
            valid_count=g.valid_count[live],
            exc_block=pos[eb[keep]].to(torch.int32),
            exc_slot=g.exc_slot[keep],
            exc_value=g.exc_value[keep],
            block_src=g.block_src[live],
            num_blocks=int(live.numel()),
            n_exceptions=int(keep.sum()),
            block_weights=None if g.block_weights is None else g.block_weights[live],
            exception_dense_hint=exception_dense(g),
        )
    elif isinstance(g, CSRGraph):
        NB, FB = g.num_blocks, g.block_size
        g_live = dataclasses.replace(
            g,
            block_src=g.block_src[live],
            edge_src=g.edge_src.view(NB, FB)[live].reshape(-1),
            edge_dst=g.edge_dst.view(NB, FB)[live].reshape(-1),
            edge_w=g.edge_w.view(NB, FB)[live].reshape(-1),
            num_blocks=int(live.numel()),
        )
    else:
        raise TypeError(f"cannot compact {type(g).__name__}")
    return g_live, words_live, live_ids


def shard_edge_active(
    edge_active,
    *,
    block_size: int,
    blocks_per_shard: int,
    num_shards: int,
    num_blocks: int | None = None,
) -> ShardedEdgeActive:
    """Partition filter words alongside the edge blocks (block-range split).

    ``edge_active`` is any form ``edge_active_words`` accepts, over the
    *global* block set; the zero-padded tail rows mask the empty blocks
    that pad a non-dividing block count.  ``num_blocks`` (the graph's block
    count before the split, when known) is checked exactly; without it a
    pad of a whole shard or more is still refused (a filter for this graph
    pads fewer than ``num_shards`` rows).  Zero-filling a short filter
    would deactivate real blocks, so both checks raise.
    """
    words = edge_active_words(edge_active, block_size)
    total = blocks_per_shard * num_shards
    pad = total - words.shape[0]
    if (
        num_blocks is not None and words.shape[0] != num_blocks
    ) or pad < 0 or pad >= num_shards:
        raise ValueError(
            f"edge_active covers {words.shape[0]} blocks but the plan "
            f"carries {total} ({num_shards} shards x {blocks_per_shard}"
            + (f", graph has {num_blocks}" if num_blocks is not None else "")
            + ") — was the filter built for a different graph?"
        )
    if pad:
        words = torch.nn.functional.pad(words, (0, 0, 0, pad))
    return ShardedEdgeActive(
        words=words.reshape(num_shards, blocks_per_shard, words.shape[-1]),
        num_shards=num_shards,
    )


def _place(g, device):
    """``g`` with every tensor field on ``device`` (no copy where it is)."""
    moved = {f.name: getattr(g, f.name).to(device) for f in dataclasses.fields(g)
             if isinstance(getattr(g, f.name), torch.Tensor)}
    return dataclasses.replace(g, **moved)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static description of how an edgeMap executes.

    backend     — 'csr' | 'compressed' | 'auto' (recorded from the graph)
    strategy    — default edgeMap mode when the call site doesn't pass one:
                  'dense' | 'sparse' | 'sparse_streamed' | 'auto'
    chunk_blocks— chunk size of the sparse strategies (ids per kernel launch)
    dense_frac  — Beamer threshold: dense when frontier degree > m/dense_frac
    auto_sparse — the sparse flavor the 'auto' strategy's sparse branch runs
    dense_frac_batched / auto_sparse_batched — the same two knobs for
                  batched rounds
    batched_flavor_crossover — measured mean lane density below which a
                  batched auto round's sparse branch streams (None: the
                  static ``auto_sparse_batched`` flavor always runs)
    route       — 'cuda' (hand kernels) or 'torch' (plain versions), from the
                  graph's device; part of ``tuning_key`` so a cache keyed on
                  it never mixes the two routes
    mesh        — a ``ShardMesh``, or None for single-device execution
    shard_axes  — mesh axes the edge blocks shard over (() → all axes)
    reduce_mode — the sum combine: 'flat' sums over every shard axis in
                  turn; 'hierarchical' sums along the fastest axis first,
                  then the slow ones (1-D or (B, n) outputs)
    state_dtype — a sum is cast to it before the combine (e.g. bfloat16)
    pipeline_rounds — the JAX package's skewed round schedule; kept for
                  parity and in ``tuning_key``, the eager loop is the same
    decisions   — the TuningDecision behind the knobs (source 'measured' |
                  'constants', the crossover density, the table's host)
    """

    backend: str = "auto"
    strategy: str = "auto"
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS
    dense_frac: float = DEFAULT_DENSE_FRAC
    auto_sparse: str = "sparse"
    dense_frac_batched: float = DEFAULT_DENSE_FRAC
    auto_sparse_batched: str = "sparse"
    batched_flavor_crossover: float | None = None
    route: str = "cuda"
    mesh: Any = None
    shard_axes: tuple = ()
    reduce_mode: str = "flat"
    state_dtype: Any = None
    pipeline_rounds: bool = False
    decisions: Any = None

    @property
    def axes(self) -> tuple:
        if self.mesh is None:
            return ()
        return tuple(self.shard_axes) or tuple(self.mesh.axis_names)

    @property
    def tuning_key(self) -> tuple:
        """Hashable summary of the knobs that change what a call runs."""
        return (
            self.strategy,
            self.auto_sparse,
            self.auto_sparse_batched,
            None
            if self.batched_flavor_crossover is None
            else float(self.batched_flavor_crossover),
            float(self.dense_frac),
            float(self.dense_frac_batched),
            int(self.chunk_blocks),
            bool(self.pipeline_rounds),
            None if self.mesh is None
            else tuple(zip(self.mesh.axis_names, self.mesh.shape)),
            self.route,
        )

    @property
    def num_shards(self) -> int:
        k = 1
        for ax in self.axes:
            k *= self.mesh.axis_size(ax)
        return k

    @property
    def shard_devices(self) -> list:
        """The device of each shard (``ShardMesh.shard_devices``)."""
        return self.mesh.shard_devices(self.axes)

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    def resolve_mode(self, mode: str | None) -> str:
        """Explicit call-site mode wins; otherwise the plan's strategy."""
        if mode is not None and mode != "auto":
            return mode
        return self.strategy

    def edge_read_words_per_round(self, g) -> int:
        """Large-memory words one dense edgeMap round reads under this plan:
        per-shard block reads (padding included) over the plan's shards, the
        read quantum the serving scheduler prices admission and per-lane
        drain accounting in.  ``g`` may be the raw backend or its prepared
        ``ShardedGraph``: both price the same."""
        from .psam import edgemap_round_read_words

        if isinstance(g, ShardedGraph):
            return edgemap_round_read_words(g.shards[0], num_shards=1) * g.num_shards
        return edgemap_round_read_words(g, num_shards=self.num_shards)

    def prepare(self, g, edge_active=None, *, compact_live: bool = False):
        """Shard and place a graph for this plan (the identity off-mesh).

        Call once per graph, like the paper's preprocessing step; a
        ``ShardedGraph`` comes back as it is.  ``edge_active`` (any form
        ``edge_active_words`` accepts) rides along: the result is then
        ``(graph, active)``, the words split block-range-wise
        (``shard_edge_active``) on a mesh.  ``compact_live=True`` (needs
        ``edge_active``) first drops the blocks with no active slot
        (:func:`compact_live_blocks`), *before* the split, and records each
        shard row's original block in ``ShardedEdgeActive.live_ids``; every
        edgeMap result under that filter is unchanged.
        """
        if compact_live:
            if edge_active is None:
                raise ValueError("compact_live=True requires edge_active")
            if isinstance(g, ShardedGraph) or isinstance(edge_active, ShardedEdgeActive):
                raise ValueError(
                    "compact_live must run before the shard split — pass the "
                    "un-sharded graph and filter"
                )
            orig_nb = g.num_blocks
            g, edge_active, live_ids = compact_live_blocks(g, edge_active)
        if not self.is_sharded:
            return g if edge_active is None else (g, edge_active)
        if isinstance(g, ShardedGraph):
            if g.num_shards != self.num_shards:
                raise ValueError(
                    f"graph prepared for {g.num_shards} shards, plan has "
                    f"{self.num_shards}"
                )
            gs = g
        else:
            shards = [_place(s, d) for s, d in zip(g.shard(self.num_shards),
                                                   self.shard_devices)]
            gs = ShardedGraph(shards=shards, num_shards=self.num_shards,
                              orig_num_blocks=g.num_blocks)
        if edge_active is None:
            return gs
        if not isinstance(edge_active, ShardedEdgeActive):
            edge_active = shard_edge_active(
                edge_active,
                block_size=gs.block_size,
                blocks_per_shard=gs.blocks_per_shard,
                num_shards=self.num_shards,
                num_blocks=gs.orig_num_blocks,
            )
        if compact_live:
            # pad rows carry the pre-compaction block count, always dead
            per = gs.blocks_per_shard
            lid = torch.nn.functional.pad(
                live_ids, (0, per * self.num_shards - live_ids.shape[0]), value=orig_nb
            ).reshape(self.num_shards, per)
            edge_active = dataclasses.replace(edge_active, live_ids=lid)
        return gs, edge_active

    def describe(self) -> str:
        if self.is_sharded:
            where = (f"mesh{tuple(self.mesh.axis_size(a) for a in self.axes)} "
                     f"reduce={self.reduce_mode}")
        else:
            where = "single-device"
        return (
            f"plan[{where} backend={self.backend} strategy={self.strategy} "
            f"route={self.route} shards={self.num_shards}]"
        )


def _resolve_decision(backend: str, strategy: str, tuning):
    """The TuningDecision behind a plan's knobs.

    ``tuning`` is a :class:`repro_torch.tuning.TuningTable` (always
    consulted), ``"default"`` (the shipped table, measured on the H100,
    consulted for ``strategy="auto"`` plans only — fixed-strategy plans keep
    the constants unless a table is passed explicitly), or ``None``/``"off"``
    (static constants).  Backends the table has no measurements for —
    including ``"auto"`` when no graph was passed — get the constants
    decision; so does a missing or stale shipped table.
    """
    if tuning is None or tuning == "off":
        return constants_decision(backend, strategy)
    if isinstance(tuning, TuningTable):
        return tuning.decide(backend, strategy)
    if tuning == "default":
        if strategy == "auto":
            try:
                return default_table().decide(backend, strategy)
            except (OSError, ValueError):  # missing/stale shipped table
                return constants_decision(backend, strategy)
        return constants_decision(backend, strategy)
    raise ValueError(
        f"tuning must be a TuningTable, 'default', 'off' or None; got {tuning!r}"
    )


def make_plan(
    g=None,
    *,
    strategy: str = "auto",
    chunk_blocks: int | None = None,
    dense_frac: float | None = None,
    device=None,
    mesh: ShardMesh | None = None,
    shard_axes: tuple = (),
    reduce_mode: str = "flat",
    state_dtype=None,
    pipeline_rounds: bool = False,
    tuning="default",
) -> ExecutionPlan:
    """Build an :class:`ExecutionPlan`, recording the backend from ``g``.

    Knob resolution, most specific first: explicit ``chunk_blocks`` /
    ``dense_frac`` arguments → the ``tuning`` source (a calibrated
    :class:`~repro_torch.tuning.TuningTable`, or the shipped table for
    ``strategy="auto"`` plans) → the constants in
    ``repro_torch.tuning.defaults``.  The resolved ``TuningDecision`` is
    recorded on ``plan.decisions``.  Pass ``tuning=None`` (or ``"off"``) to
    pin the constants.  The route comes from ``g``'s device, else from the
    mesh's first device, else from ``device`` (default ``cuda``) — never
    from a table.

    ``mesh`` (a :class:`~repro_torch.core.mesh.ShardMesh`) makes the plan
    sharded over ``shard_axes`` (default: every axis); ``reduce_mode`` and
    ``state_dtype`` shape its combine (see :class:`ExecutionPlan`).
    """
    if mesh is not None and not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a ShardMesh (core.mesh.make_mesh), got {mesh!r}")
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"reduce_mode must be one of {REDUCE_MODES}, got {reduce_mode!r}")
    if mesh is not None:
        for ax in shard_axes:
            mesh.axis_size(ax)  # ValueError on an axis the mesh lacks
    backend = "auto"
    base = g.shards[0] if isinstance(g, ShardedGraph) else g
    if isinstance(base, CompressedCSR):
        backend = "compressed"
    elif isinstance(base, CSRGraph):
        backend = "csr"
    if g is not None:
        where = g.device
    elif mesh is not None and device is None:
        where = mesh.devices[0]
    else:
        where = resolve_device(device)
    route = kernel_route(where)
    decision = _resolve_decision(backend, strategy, tuning)
    if dense_frac is not None:
        # an explicit threshold pins BOTH predicates
        dense_frac_batched = float(dense_frac)
    else:
        dense_frac = decision.dense_frac
        dense_frac_batched = float(
            decision.dense_frac_batched
            if decision.dense_frac_batched is not None
            else dense_frac
        )
    if chunk_blocks is None:
        chunk_blocks = decision.chunk_blocks
    decision = dataclasses.replace(
        decision,
        strategy=strategy,
        dense_frac=float(dense_frac),
        dense_frac_batched=dense_frac_batched,
        chunk_blocks=int(chunk_blocks),
        route=route,
    )
    return ExecutionPlan(
        backend=backend,
        strategy=strategy,
        chunk_blocks=int(chunk_blocks),
        dense_frac=float(dense_frac),
        auto_sparse=decision.auto_sparse,
        dense_frac_batched=dense_frac_batched,
        auto_sparse_batched=decision.auto_sparse_batched,
        batched_flavor_crossover=decision.batched_flavor_crossover,
        route=route,
        mesh=mesh,
        shard_axes=tuple(shard_axes),
        reduce_mode=reduce_mode,
        state_dtype=state_dtype,
        pipeline_rounds=bool(pipeline_rounds),
        decisions=decision,
    )


def sharded_graph_spec(
    n: int,
    num_blocks: int,
    block_size: int,
    num_shards: int,
    weighted: bool = False,
) -> ShardedGraph:
    """A stand-in ``ShardedGraph`` for shape and dtype planning: one
    ``graph_spec`` per shard, on the ``meta`` device."""
    per, _ = sharded_block_counts(num_blocks, num_shards)
    return ShardedGraph(
        shards=[graph_spec(n, per, block_size, weighted) for _ in range(num_shards)],
        num_shards=num_shards,
        orig_num_blocks=num_blocks,
    )


# ----------------------------------------------------------------------
# Sharded executor — the single-device bodies, once per shard
# ----------------------------------------------------------------------
def _fold(parts: list, op):
    """``op``-fold of equal-shape tensors, left to right."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def _fold_axes(plan: ExecutionPlan, outs: list, op, order) -> torch.Tensor:
    """Fold per-shard ``outs`` (row-major over ``plan.axes``) along each
    shard axis in ``order`` (indices into ``plan.axes``)."""
    sizes = [plan.mesh.axis_size(a) for a in plan.axes]
    grid = torch.stack(outs).reshape(tuple(sizes) + tuple(outs[0].shape))
    dims = list(range(len(sizes)))
    for ax in order:
        grid = _fold(list(grid.unbind(dims.index(ax))), op)
        dims.remove(ax)
    return grid


def _combine_shards(plan: ExecutionPlan, parts: list, monoid: str, out_dtype):
    """Monoid-combine the per-shard ``(out, touched)`` pairs on the plan's
    first device: O(n) (or O(B·n)) words a shard, never O(m).

    ``sum`` folds along every shard axis in turn (``flat``) or along the
    fastest axis first, then the slow ones (``hierarchical``, 1-D or (B, n)
    outputs only), in ``state_dtype`` when the plan sets one; ``min`` /
    ``max`` fold exactly; ``or`` and ``touched`` are a count > 0."""
    dev = plan.mesh.devices[0]
    outs = [o.to(dev) for o, _ in parts]
    hits = [t.to(dev).to(torch.int32) for _, t in parts]
    order = list(range(len(plan.axes)))
    if monoid == "sum":
        if plan.state_dtype is not None:
            outs = [o.to(plan.state_dtype) for o in outs]
        if plan.reduce_mode == "hierarchical" and len(plan.axes) > 1:
            if outs[0].dim() > 2:
                raise NotImplementedError("hierarchical reduce: 1-D or (B, n) only")
            order = order[-1:] + order[:-1]
        out = _fold_axes(plan, outs, torch.add, order)
    elif monoid == "min":
        out = _fold_axes(plan, outs, torch.minimum, order)
    elif monoid == "max":
        out = _fold_axes(plan, outs, torch.maximum, order)
    elif monoid == "or":
        out = _fold_axes(plan, [o.to(torch.int32) for o in outs], torch.add, order) > 0
    else:
        raise ValueError(monoid)
    touched = _fold_axes(plan, hits, torch.add, order) > 0
    if monoid != "or":
        out = out.to(out_dtype)
    return out, touched


def _shard_active(plan: ExecutionPlan, g: ShardedGraph, edge_active):
    """The filter words of each shard, or None."""
    if edge_active is None:
        return None
    if isinstance(edge_active, ShardedEdgeActive):
        if edge_active.num_shards != plan.num_shards:
            raise ValueError(
                f"edge_active prepared for {edge_active.num_shards} "
                f"shards, plan has {plan.num_shards}"
            )
        return edge_active
    return shard_edge_active(
        edge_active,
        block_size=g.block_size,
        blocks_per_shard=g.blocks_per_shard,
        num_shards=plan.num_shards,
        num_blocks=g.orig_num_blocks,
    )


def _local_sweeps(g: ShardedGraph, frontier, x, active, local, kwargs, map_lanes=None):
    """Each shard's uncombined ``local(...)`` result, on its own device."""
    parts = []
    for s, gl in enumerate(g.shards):
        dev = gl.device
        kw = dict(kwargs)
        if active is not None:
            kw["edge_active"] = active.words[s].to(dev)
        if map_lanes is not None:
            kw["map_lanes"] = map_lanes.to(dev)
        parts.append(local(gl, frontier.to(dev), x.to(dev), **kw))
    return parts


def _sharded_edgemap_call(plan, g, frontier, x, *, batched, monoid, map_fn, edge_active,
                          mode, dense_frac, chunk_blocks, auto_sparse, map_lanes=None):
    """The plumbing both sharded executors share: prepare, split the filter
    words, run the local body on every shard, combine, count the call."""
    from .edgemap import _edgemap_reduce_local, _resolve_knobs, edgemap_reduce_batched

    if not isinstance(g, ShardedGraph):
        g = plan.prepare(g)
    active = _shard_active(plan, g, edge_active)
    mode, dense_frac, chunk_blocks, auto_sparse = _resolve_knobs(
        plan, mode, dense_frac, chunk_blocks, auto_sparse, batched)
    kwargs = dict(mode=mode, dense_frac=dense_frac, chunk_blocks=chunk_blocks,
                  auto_sparse=auto_sparse, monoid=monoid, map_fn=map_fn)
    if batched:
        # the batched body's own measured flavor switch, as one device's
        kwargs["flavor_crossover"] = plan.batched_flavor_crossover
        local = edgemap_reduce_batched
    else:
        local = _edgemap_reduce_local
    parts = _local_sweeps(g, frontier, x, active, local, kwargs, map_lanes)
    out = _combine_shards(plan, parts, monoid, x.dtype)
    reg = get_registry()
    if reg.enabled:
        reg.counter(
            "sage_sharded_edgemap_calls_total",
            "eager sharded edgeMap rounds dispatched",
            labels=("batched",),
        ).inc(batched=str(batched).lower())
    return out


def sharded_edgemap_reduce(
    plan: ExecutionPlan,
    g,
    frontier_mask: torch.Tensor,
    x: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn=None,
    edge_active=None,
    mode: str | None = None,
    dense_frac: float | None = None,
    chunk_blocks: int | None = None,
    auto_sparse: str | None = None,
):
    """Direction-optimized edgeMap over a mesh: each shard runs the
    single-device body on its block set (the global ``m`` and ``degrees``,
    so every shard takes the same Beamer branch), then one monoid combine
    of the O(n) outputs.  ``g`` is the plan-prepared ``ShardedGraph`` (a raw
    backend is prepared first); frontier and vertex state are replicated.
    ``edge_active`` is a ``ShardedEdgeActive`` from ``plan.prepare`` or any
    raw form over the global block set, split here."""
    from .edgemap import _identity_map

    return _sharded_edgemap_call(
        plan, g, frontier_mask, x, batched=False, monoid=monoid,
        map_fn=_identity_map if map_fn is None else map_fn, edge_active=edge_active,
        mode=mode, dense_frac=dense_frac, chunk_blocks=chunk_blocks,
        auto_sparse=auto_sparse,
    )


def sharded_edgemap_reduce_batched(
    plan: ExecutionPlan,
    g,
    frontier_masks: torch.Tensor,
    xb: torch.Tensor,
    *,
    monoid: str = "min",
    map_fn=None,
    edge_active=None,
    mode: str | None = None,
    dense_frac: float | None = None,
    chunk_blocks: int | None = None,
    auto_sparse: str | None = None,
    map_lanes: torch.Tensor | None = None,
):
    """Batched edgeMap over a mesh: B queries share each shard's one local
    sweep (``edgemap_reduce_batched`` with the plan's batched knobs and
    flavor crossover), then one combine of the O(B·n) outputs.
    ``map_lanes`` (bool[B]) restricts ``map_fn`` to the selected lanes, as
    on one device."""
    from .edgemap import _identity_map

    return _sharded_edgemap_call(
        plan, g, frontier_masks, xb, batched=True, monoid=monoid,
        map_fn=_identity_map if map_fn is None else map_fn, edge_active=edge_active,
        mode=mode, dense_frac=dense_frac, chunk_blocks=chunk_blocks,
        auto_sparse=auto_sparse, map_lanes=map_lanes,
    )


def round_loop(
    g,
    state,
    *,
    sweep_inputs,
    epilogue,
    cond_fn,
    monoid: str,
    plan: ExecutionPlan | None = None,
    map_fn=None,
    edge_active=None,
    mode: str = "auto",
    batched: bool = False,
):
    """Run a frontier round loop (see the module docstring).

    ``sweep_inputs(state) -> (state', frontier, x)`` may mutate state before
    the sweep; ``epilogue(state, out, touched) -> state`` applies it;
    ``cond_fn(state)`` is the loop predicate, read on the host.

    Every plan runs the recurrence as written, one ``edgemap_reduce`` (or
    the batched one) a round; a sharded plan's call runs the local sweeps
    and their combine.  ``plan.pipeline_rounds`` changes nothing here: the
    skew only pays where a compiler or an async collective can overlap the
    combine with the next sweeps, and the eager loop has neither.
    """
    from .edgemap import edgemap_reduce, edgemap_reduce_batched

    if plan is not None and plan.is_sharded and not isinstance(g, ShardedGraph):
        g = plan.prepare(g)
    kwargs = {} if map_fn is None else {"map_fn": map_fn}
    if edge_active is not None:
        kwargs["edge_active"] = edge_active
    local_reduce = edgemap_reduce_batched if batched else edgemap_reduce
    while bool(cond_fn(state)):
        state, frontier, x = sweep_inputs(state)
        out, touched = local_reduce(
            g, frontier, x, monoid=monoid, mode=mode, plan=plan, **kwargs
        )
        state = epilogue(state, out, touched)
    return state
