"""Batched multi-query serving engine — one edge sweep, many queries.

Sage's PSAM makes edge reads the scarce resource: the edges live in
read-only large memory, every query's mutable state is O(n) words.  The
:class:`QueryEngine` shares one scan across many concurrent queries:

    submit() ──► per-(op, params) buckets ──► pad to power-of-two B
                                                     │
                 callable cache keyed (backend, mesh, ▼
                 tuning_key, op, B, scalars) ◄── flush()
                 batched algorithm (bfs_batched, …): each round reads every
                 live edge block ONCE and applies it to all B query columns
                                                     │
                 per-handle results (padding dropped) ◄┘

* **Coalescing** — requests (``bfs``, ``wbfs``, ``ppr``,
  ``pagerank_iteration``) bucket by ``(op, scalar params)``; each bucket
  drains as one batched call.
* **Padding** — buckets pad to the next power of two (capped at
  ``max_batch``; larger buckets split) by repeating the last request.
  Batched ops are bit-identical per query, so padding never perturbs a
  real lane.
* **Callable cache** — PyTorch runs eagerly, so there is nothing to trace;
  the cache holds one bound callable per ``(backend, mesh, tuning_key, op,
  B, scalars)`` key and ``trace_counts`` counts its misses, the counterpart
  of the JAX engine's retrace count.  The plan's ``tuning_key`` carries the
  kernel route, so one cache never mixes the CUDA and the plain routes.
* **Sharding** — a mesh plan prepares the graph once (``plan.prepare``):
  every batch runs the sharded executor, and the PSAM account charges the
  plan's shards (padding blocks and the O(B·n) combine per shard boundary).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..algorithms.eigen import pagerank_iteration_batched
from ..algorithms.local import personalized_pagerank_batched
from ..algorithms.traversal import bfs_batched, wbfs_batched
from ..core.compressed import CompressedCSR, exception_dense
from ..core.primitives import INF_I32
from ..core.psam import PSAMCost
from ..obs import get_registry
from ..tuning.defaults import DEFAULT_MAX_BATCH

# engine batch widths are powers of two capped at max_batch — exact-width
# buckets, so the batch-size histogram is lossless
_BATCH_BUCKETS = tuple(float(1 << i) for i in range(11))


def _bfs_sweeps(res) -> int:
    """Edge sweeps a drained BFS batch executed: deepest level + drain round."""
    _, levels = res
    return int(levels.max()) + 1


def _wbfs_sweeps(res) -> int:
    """Edge sweeps a drained wBFS batch executed — one relaxation sweep per
    extracted bucket ≈ distinct finite distances of the longest-running
    query (analytic estimate, like Table 1's)."""
    finite = torch.where(res < INF_I32, res, -1).cpu().numpy()
    per_q = [len(np.unique(r[r >= 0])) for r in finite]
    return max(max(per_q, default=1), 1)


@dataclasses.dataclass(frozen=True)
class _OpSpec:
    """How one query kind batches: stack requests → run → slice → account."""

    stack: Callable[[list[dict], torch.device], tuple]  # requests → batched args
    run: Callable                                       # (g, plan, args, scalars)
    unbatch: Callable[[Any, int], Any]                  # batched res → query i's
    sweeps: Callable[[Any], int]                        # res → edge sweeps
    scalar_keys: tuple = ()                             # params keyed per bucket


def _src_stack(reqs: list[dict], device) -> tuple:
    return (torch.tensor([int(r["src"]) for r in reqs], dtype=torch.int64, device=device),)


def _pr_stack(reqs: list[dict], device) -> tuple:
    return (torch.stack([torch.as_tensor(r["pr"], dtype=torch.float32, device=device)
                         for r in reqs]),)


_OPS: dict[str, _OpSpec] = {
    "bfs": _OpSpec(
        stack=_src_stack,
        run=lambda g, plan, args, sc: bfs_batched(g, *args, plan=plan, **sc),
        unbatch=lambda res, i: (res[0][i], res[1][i]),
        sweeps=_bfs_sweeps,
        scalar_keys=("mode",),
    ),
    "wbfs": _OpSpec(
        stack=_src_stack,
        run=lambda g, plan, args, sc: wbfs_batched(g, *args, plan=plan, **sc),
        unbatch=lambda res, i: res[i],
        sweeps=_wbfs_sweeps,
        scalar_keys=("mode",),
    ),
    "ppr": _OpSpec(
        stack=_src_stack,
        run=lambda g, plan, args, sc: personalized_pagerank_batched(
            g, *args, plan=plan, **sc
        ),
        unbatch=lambda res, i: (res[0][i], res[1][i], res[2][i]),
        sweeps=lambda res: max(int(res[2].max()), 1),
        scalar_keys=("alpha", "eps", "max_rounds", "mode"),
    ),
    "pagerank_iteration": _OpSpec(
        stack=_pr_stack,
        run=lambda g, plan, args, sc: pagerank_iteration_batched(
            g, *args, plan=plan, **sc
        ),
        unbatch=lambda res, i: res[i],
        sweeps=lambda res: 1,
        scalar_keys=("damping",),
    ),
}


def _pow2_batch(k: int, max_batch: int) -> int:
    """Next power-of-two batch width ≥ k, capped at ``max_batch``."""
    b = 1
    while b < k:
        b *= 2
    return min(b, max_batch)


@dataclasses.dataclass(frozen=True)
class QueryHandle:
    """Ticket for a submitted query; resolves in the flush that drains it."""

    id: int
    op: str


class QueryEngine:
    """Coalesce, batch and serve graph queries over one graph backend.

    ``g`` is the read-only large memory (``CSRGraph | CompressedCSR``) on
    its device; ``plan`` (optional) the ``ExecutionPlan`` every batch runs
    under; ``max_batch`` caps the padded batch width B (default: the plan's
    decision, else ``DEFAULT_MAX_BATCH``).

    ``stats`` counts submitted/served queries, drained batches, batch
    columns (``lanes``) and padding columns (``padded``); ``cost``
    accumulates the PSAM model of every drained batch; ``registry`` (the
    process-global default when omitted) receives the ``sage_engine_*``
    metrics.
    """

    def __init__(self, g, *, plan=None, max_batch: int | None = None, registry=None):
        self.graph = g
        self.plan = plan
        self.registry = registry if registry is not None else get_registry()
        self.prepared = g if plan is None else plan.prepare(g)
        if max_batch is None:
            decisions = getattr(plan, "decisions", None)
            max_batch = decisions.max_batch if decisions is not None else DEFAULT_MAX_BATCH
        self.max_batch = int(max_batch)
        self.cost = PSAMCost(registry=self.registry)
        reg = self.registry
        self._m_submitted = reg.counter(
            "sage_engine_submitted_total", "queries submitted", labels=("op",)
        )
        self._m_served = reg.counter(
            "sage_engine_served_total", "queries served (padding excluded)",
            labels=("op",),
        )
        self._m_batches = reg.counter(
            "sage_engine_batches_total", "batch buckets drained", labels=("op",)
        )
        self._m_lanes = reg.counter(
            "sage_engine_lanes_total", "batch columns drained (padding included)"
        )
        self._m_padded = reg.counter(
            "sage_engine_padded_lanes_total", "padding columns drained"
        )
        self._m_batch_size = reg.histogram(
            "sage_engine_batch_size", "padded batch width B per drained bucket",
            labels=("op",), buckets=_BATCH_BUCKETS,
        )
        self._m_cache_hits = reg.counter(
            "sage_engine_cache_hits_total",
            "callable cache hits", labels=("cache",),
        )
        self._m_cache_misses = reg.counter(
            "sage_engine_cache_misses_total",
            "callable cache misses", labels=("cache",),
        )
        self._m_occupancy = reg.gauge(
            "sage_engine_occupancy", "served / lanes over the engine lifetime"
        )
        self._pending: dict[tuple, list[tuple[int, dict]]] = {}
        self._in_flush = False
        self._reset_deferred = False
        self._compiled: dict[tuple, Callable] = {}
        self.trace_counts: dict[tuple, int] = {}
        self.stats = {"submitted": 0, "served": 0, "batches": 0, "lanes": 0, "padded": 0}
        self._next_id = 0
        if plan is not None and plan.is_sharded:
            self._mesh_key = tuple(zip(plan.mesh.axis_names, plan.mesh.shape))
        else:
            self._mesh_key = None
        self._backend_key = type(g).__name__
        self._tuning_key = plan.tuning_key if plan is not None else None

    # ------------------------------------------------------------------
    def submit(self, op: str, **params) -> QueryHandle:
        """Enqueue one query; returns a handle resolved by ``flush()``."""
        spec = _OPS.get(op)
        if spec is None:
            raise ValueError(f"unknown op {op!r}; serving ops: {sorted(_OPS)}")
        scalars = tuple((k, params.pop(k)) for k in spec.scalar_keys if k in params)
        h = QueryHandle(self._next_id, op)
        self._next_id += 1
        self.stats["submitted"] += 1
        self._m_submitted.inc(op=op)
        self._pending.setdefault((op, scalars), []).append((h.id, params))
        return h

    def flush(self) -> dict[QueryHandle, Any]:
        """Drain every bucket; returns {handle: result} for all pending.

        A ``reset_stats`` requested while buckets drain is deferred to the
        end of this flush, so the in-flight buckets' counters land exactly
        once."""
        out: dict[QueryHandle, Any] = {}
        pending, self._pending = self._pending, {}
        self._in_flush = True
        try:
            for (op, scalars), reqs in pending.items():
                for lo in range(0, len(reqs), self.max_batch):
                    chunk = reqs[lo : lo + self.max_batch]
                    out.update(self._run_bucket(op, scalars, chunk))
        finally:
            self._in_flush = False
            if self._reset_deferred:
                self._reset_deferred = False
                self._apply_reset()
        return out

    def serve(self, requests: list[tuple[str, dict]]) -> list[Any]:
        """Convenience: submit all, flush once, return results in order."""
        handles = [self.submit(op, **params) for op, params in requests]
        resolved = self.flush()
        return [resolved[h] for h in handles]

    @property
    def occupancy(self) -> float:
        """Fraction of drained batch columns that carried real queries
        (``served / lanes``); NaN before any batch drains."""
        lanes = self.stats["lanes"]
        return self.stats["served"] / lanes if lanes else float("nan")

    def reset_stats(self) -> None:
        """Zero ``stats`` and the registry's ``sage_engine_*`` families
        (deferred to the end of a flush in progress).  ``cost`` and
        ``trace_counts`` are lifetime records and stay."""
        if self._in_flush:
            self._reset_deferred = True
            return
        self._apply_reset()

    def _apply_reset(self) -> None:
        for k in self.stats:
            self.stats[k] = 0
        self.registry.reset(prefix="sage_engine_")
        for (op, _), reqs in self._pending.items():
            self.stats["submitted"] += len(reqs)
            self._m_submitted.inc(len(reqs), op=op)

    # ------------------------------------------------------------------
    def _run_bucket(self, op, scalars, chunk) -> dict[QueryHandle, Any]:
        """Pad one (op, scalars) bucket to power-of-two B, run it, account
        its PSAM cost, and slice per-handle results (padding dropped)."""
        spec = _OPS[op]
        k = len(chunk)
        B = _pow2_batch(k, self.max_batch)
        reqs = [r for _, r in chunk] + [chunk[-1][1]] * (B - k)
        args = spec.stack(reqs, self.graph.device)
        res = self._compiled_fn(op, scalars, B, spec)(self.prepared, *args)
        self.stats["batches"] += 1
        self.stats["served"] += k
        self.stats["lanes"] += B
        self.stats["padded"] += B - k
        self._m_batches.inc(op=op)
        self._m_served.inc(k, op=op)
        self._m_lanes.inc(B)
        self._m_padded.inc(B - k)
        self._m_batch_size.observe(float(B), op=op)
        self._m_occupancy.set(self.stats["served"] / self.stats["lanes"])
        self._charge(B, spec.sweeps(res), op=op, scalars=scalars)
        return {QueryHandle(hid, op): spec.unbatch(res, i) for i, (hid, _) in enumerate(chunk)}

    def _compiled_fn(self, op, scalars, B, spec):
        """Fetch or bind the callable for one ``(backend, mesh, tuning_key,
        op, B, scalars)`` key; a miss bumps ``trace_counts[key]``."""
        key = (self._backend_key, self._mesh_key, self._tuning_key, op, B, scalars)
        fn = self._compiled.get(key)
        if fn is not None:
            self._m_cache_hits.inc(cache="engine")
            return fn
        self._m_cache_misses.inc(cache="engine")
        self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
        sc = dict(scalars)
        plan = self.plan

        def fn(g, *args):
            return spec.run(g, plan, args, sc)

        self._compiled[key] = fn
        return fn

    def _streamed_accounting(self, op: str, scalars: tuple) -> bool:
        """True when the drained bucket really ran the streamed frontier-sparse
        path AND its read model applies: the plan's strategy is
        ``sparse_streamed`` and the bucket's ``mode`` doesn't override it,
        the backend streams (``CompressedCSR``, not exception-dense), and the
        op is BFS, whose monotone frontiers stream each block at most
        ``min(B, sweeps)`` times per drain."""
        if self.plan is None or self.plan.strategy != "sparse_streamed":
            return False
        if op != "bfs":
            return False
        if dict(scalars).get("mode", "auto") not in ("auto", "sparse_streamed"):
            return False
        return isinstance(self.graph, CompressedCSR) and not exception_dense(self.graph)

    def _charge(self, B: int, sweeps: int, op: str = "", scalars: tuple = ()):
        """PSAM model of one drained batch: ``sweeps`` rounds, each reading
        the edge blocks once for all B lanes — or, on a certified streamed
        BFS drain, the ``min(B, sweeps) · NB / sweeps`` live share — over
        the plan's shards."""
        shards = self.plan.num_shards if self._mesh_key is not None else 1
        sweeps = max(sweeps, 1)
        if self._streamed_accounting(op, scalars):
            live = -(-self.graph.num_blocks * min(B, sweeps) // sweeps)
            for _ in range(sweeps):
                self.cost.charge_edgemap_sparse(self.graph, live, batch=B, num_shards=shards)
            return
        for _ in range(sweeps):
            self.cost.charge_edgemap_batched(self.graph, B, num_shards=shards)
