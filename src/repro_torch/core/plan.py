"""Execution planner — where and how an edgeMap runs, and the round loop.

An :class:`ExecutionPlan` names the storage backend, the dense/sparse/auto
strategy and its knobs, and the kernel route (``"cuda"`` or ``"torch"``,
resolved from the graph's device).  ``edgemap_reduce`` / ``edge_map`` and
the algorithms accept one via ``plan=``, so algorithm code never picks an
engine.  ``make_plan`` takes its knobs from a ``TuningTable`` measured on
the card (the shipped one by default, for ``strategy="auto"``) or from the
constants.  Only single-device plans exist so far; a sharded plan raises.

``round_loop`` owns the frontier recurrence every traversal shares::

    while cond_fn(state):
        state, frontier, x = sweep_inputs(state)
        out, touched = edgeMap(g, frontier, x)
        state = epilogue(state, out, touched)

as a Python loop on the host-read predicate.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..device import kernel_route, resolve_device
from ..tuning.defaults import DEFAULT_CHUNK_BLOCKS, DEFAULT_DENSE_FRAC
from ..tuning.table import TuningTable, constants_decision, default_table
from .compressed import CompressedCSR
from .csr import CSRGraph


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
    mesh        — always None: sharded execution is not ported yet
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
    decisions: Any = None

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
            self.route,
        )

    @property
    def num_shards(self) -> int:
        return 1

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
        the read quantum the serving scheduler prices admission and per-lane
        drain accounting in."""
        from .psam import edgemap_round_read_words

        return edgemap_round_read_words(g, num_shards=self.num_shards)

    def prepare(self, g, edge_active=None, *, compact_live: bool = False):
        """Place a graph for this plan: the identity on one device.

        Returns ``g``, or ``(g, edge_active)`` when a filter is given.
        ``compact_live=True`` (dropping filter-dead blocks) and sharded
        plans are not ported yet."""
        if compact_live:
            raise NotImplementedError("compact_live is not ported yet")
        if self.is_sharded:
            raise NotImplementedError("sharded plans are not ported yet")
        return g if edge_active is None else (g, edge_active)

    def describe(self) -> str:
        return (
            f"plan[single-device backend={self.backend} strategy={self.strategy} "
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
    mesh=None,
    tuning="default",
) -> ExecutionPlan:
    """Build an :class:`ExecutionPlan`, recording the backend from ``g``.

    Knob resolution, most specific first: explicit ``chunk_blocks`` /
    ``dense_frac`` arguments → the ``tuning`` source (a calibrated
    :class:`~repro_torch.tuning.TuningTable`, or the shipped table for
    ``strategy="auto"`` plans) → the constants in
    ``repro_torch.tuning.defaults``.  The resolved ``TuningDecision`` is
    recorded on ``plan.decisions``.  Pass ``tuning=None`` (or ``"off"``) to
    pin the constants.  The route comes from ``g``'s device, or from
    ``device`` (default ``cuda``) when no graph is given — never from a table.
    """
    if mesh is not None:
        raise NotImplementedError("sharded plans are not ported yet")
    backend = "auto"
    if isinstance(g, CompressedCSR):
        backend = "compressed"
    elif isinstance(g, CSRGraph):
        backend = "csr"
    route = kernel_route(g.device if g is not None else resolve_device(device))
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
        decisions=decision,
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
    """Run a frontier round loop sequentially (see the module docstring).

    ``sweep_inputs(state) -> (state', frontier, x)`` may mutate state before
    the sweep; ``epilogue(state, out, touched) -> state`` applies it;
    ``cond_fn(state)`` is the loop predicate, read on the host.
    """
    if plan is not None and plan.is_sharded:
        raise NotImplementedError("sharded plans are not ported yet")
    from .edgemap import edgemap_reduce, edgemap_reduce_batched

    local_reduce = edgemap_reduce_batched if batched else edgemap_reduce
    kwargs = {} if map_fn is None else {"map_fn": map_fn}
    if edge_active is not None:
        kwargs["edge_active"] = edge_active
    while bool(cond_fn(state)):
        state, frontier, x = sweep_inputs(state)
        out, touched = local_reduce(
            g, frontier, x, monoid=monoid, mode=mode, plan=plan, **kwargs
        )
        state = epilogue(state, out, touched)
    return state
