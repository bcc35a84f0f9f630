"""Always-on serving service — a deadline-driven drain loop over the engine.

:class:`ServingService` is the control loop the :class:`QueryEngine`
lacks, in virtual time: requests arrive with a per-request SLO budget,
queue until a trigger fires, and drain through shared edge sweeps::

    submit(op, tenant, now) ──► admission control (per-tenant PSAM ledger)
         │                           │ reject / defer when over budget
         ▼                           ▼
       queue ──────────── tick(now) drain loop ──────────► completed
         │        flush when EITHER fires first:              tickets
         │          · deadline:  now ≥ arrival + slo
         │          · depth:     len(queue) ≥ depth_trigger
         ▼
       cross-op cohorts (bfs+wbfs fused, ≤ max_batch lanes)
         └─ quantum of shared sweeps ─ repack drained lanes out ─ repeat

* **Deadline-driven flushing** — a deadline flush drains the WHOLE queue,
  so later arrivals ride the same sweeps.
* **Cross-op batching** — BFS and wBFS lanes share one edge sweep a round
  (``traversal_cohort_rounds``; ``map_lanes`` gives each lane its own map,
  and on the card a ``sparse_streamed`` round is one fused launch).  PPR and
  PageRank iterations drain through the wrapped engine in the same flush.
* **Early-exit accounting** — a lane stops being charged the round it
  drains, and between quanta the cohort repacks to a narrower power-of-two
  width.  Each lane's result equals its single-query run.

Admission prices requests in large-memory edge-read words against
per-tenant token buckets (:class:`~repro_torch.core.psam.TenantLedgers`):
an estimate is reserved at submit and settled against the drain's actual
per-lane attribution.

Only the immutable-graph path is ported: a delta overlay, ``submit_edit``
and ``force_compact`` raise ``NotImplementedError`` (mutability is not
ported yet).  The service takes its device from the graph it serves.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..algorithms.traversal import traversal_cohort_init, traversal_cohort_rounds
from ..core.compressed import CompressedCSR
from ..core.csr import CSRGraph
from ..core.psam import TenantLedgers, edgemap_round_read_words
from ..obs import DEFAULT_LATENCY_BUCKETS, get_registry
from ..tuning.defaults import DEFAULT_EST_ROUNDS
from .engine import QueryEngine, _pow2_batch

TRAVERSAL_OPS = ("bfs", "wbfs")
_NO_MUTABILITY = "mutable graphs (the delta overlay and its edit path) are not ported yet"


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Tuning knobs for one :class:`ServingService`.

    ``slo`` is the per-request latency budget in virtual-time units
    (``deadline = arrival + slo``).  ``depth_trigger`` (default
    ``max_batch``) flushes once the queue can fill a batch.
    ``round_quantum`` bounds the fused rounds between repacks.
    ``admission`` is what happens when a tenant's ledger cannot cover a
    request's estimate: ``"reject"`` fails it, ``"defer"`` parks it until
    refills cover it (its SLO clock restarts at admission).  ``budgets``
    maps tenant → ``(capacity_words, refill_rate)``; unnamed tenants are
    unlimited.  ``max_batch`` resolves like the engine's.  ``est_rounds``
    prices a request whose (op, backend) pair has never drained; after
    that an EWMA (weight ``ewma_alpha``) of the observed rounds does.

    ``compact_trigger``, ``ckpt_dir`` and ``compact_keep`` belong to the
    delta-overlay path, which is not ported yet; they are kept so a
    configuration carries over unchanged.
    """

    slo: float = 0.05
    max_batch: int | None = None
    depth_trigger: int | None = None
    round_quantum: int = 4
    admission: str = "reject"
    budgets: dict | None = None
    mode: str = "auto"
    est_rounds: int = DEFAULT_EST_ROUNDS
    ewma_alpha: float = 0.25
    compact_trigger: Any = None
    ckpt_dir: str | None = None
    compact_keep: int = 3

    def __post_init__(self):
        if self.admission not in ("reject", "defer"):
            raise ValueError(f"admission must be 'reject'|'defer', got {self.admission!r}")


@dataclasses.dataclass
class ServingTicket:
    """One submitted request's lifecycle record.

    ``status`` walks ``queued → done`` (or ``rejected``, or ``deferred →
    queued → done``).  ``deadline`` is the flush-by time; ``finished_at``
    the virtual time of the tick that drained it.  ``rounds`` / ``words``
    are the early-exit accounting actuals the tenant ledger settles
    against."""

    id: int
    op: str
    tenant: str
    params: dict
    arrival: float
    deadline: float
    status: str = "queued"
    result: Any = None
    finished_at: float | None = None
    rounds: int = 0
    words: float = 0.0
    est_words: float = 0.0


class ServingService:
    """Deadline-driven drain loop with admission control over a QueryEngine.

    ``g`` is the read-only graph (``CSRGraph | CompressedCSR``) on its
    device, ``plan`` the ``ExecutionPlan`` every batch runs under, and
    ``config`` the :class:`ServiceConfig`.  The service runs in virtual
    time: callers stamp ``submit`` and ``tick`` with ``now``.  Only the
    ``sage_service_flush_seconds`` histogram, the latencies and the drift
    gauge read the wall clock, and only with a live ``registry`` (the
    process-global default when omitted).

    ``stats`` extends the engine's counters with trigger attribution and
    round-weighted lane occupancy; ``cost`` is the engine's PSAM account,
    which the cohort rounds are charged to as well.
    """

    def __init__(self, g, *, plan=None, config: ServiceConfig | None = None, registry=None):
        if not isinstance(g, (CSRGraph, CompressedCSR)):
            raise NotImplementedError(f"{_NO_MUTABILITY}: serve a CSRGraph or CompressedCSR")
        self.config = config or ServiceConfig()
        self.registry = registry if registry is not None else get_registry()
        self.engine = QueryEngine(
            g, plan=plan, max_batch=self.config.max_batch, registry=self.registry
        )
        self.max_batch = self.engine.max_batch
        self.plan = plan
        # per-(op, backend) observed rounds-per-request (EWMA, settled at
        # drain): the admission estimate once warm
        self.observed_rounds: dict[tuple, float] = {}
        self.ledgers = TenantLedgers(self.config.budgets)
        if plan is not None:
            self._round_words = plan.edge_read_words_per_round(self.engine.prepared)
        else:
            self._round_words = edgemap_round_read_words(g)
        self._queue: list[ServingTicket] = []
        self._deferred: list[ServingTicket] = []
        self._cohort_compiled: dict[tuple, Callable] = {}
        self.trace_counts: dict[tuple, int] = {}
        self._next_id = 0
        self.stats = {
            "submitted": 0,
            "admitted": 0,
            "rejected": 0,
            "deferred": 0,
            "served": 0,
            "ticks": 0,
            "flushes": 0,
            "deadline_flushes": 0,
            "depth_flushes": 0,
            "forced_flushes": 0,
            "cohort_rounds": 0,
            "repacks": 0,
            "lane_rounds_total": 0,
            "active_lane_rounds": 0,
            "edits_submitted": 0,
            "edits_applied": 0,
            "edits_rejected": 0,
            "compactions": 0,
        }
        reg = self.registry
        self._m_submitted = reg.counter(
            "sage_service_submitted_total", "requests submitted", labels=("op", "tenant"),
        )
        self._m_admission = reg.counter(
            "sage_service_admission_total",
            "admission outcomes (admitted includes deferred re-admissions)",
            labels=("outcome", "tenant"),
        )
        self._m_flushes = reg.counter(
            "sage_service_flushes_total", "queue flushes by trigger cause", labels=("cause",),
        )
        self._m_latency = reg.histogram(
            "sage_service_latency_seconds",
            "end-to-end request latency: virtual queue wait + drain wall time",
            labels=("op", "tenant"), buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self._m_flush_seconds = reg.histogram(
            "sage_service_flush_seconds", "wall seconds per queue flush",
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self._m_queue_depth = reg.gauge(
            "sage_service_queue_depth", "admitted, undrained requests"
        )
        self._m_deferred_depth = reg.gauge(
            "sage_service_deferred_depth", "deferred (unadmitted) requests"
        )
        self._m_occupancy = reg.gauge(
            "sage_service_occupancy",
            "round-weighted fraction of cohort lane-slots doing real work",
        )
        self._m_drift = reg.gauge(
            "sage_psam_drift_words_per_second",
            "modeled edge-read words charged per wall second of the last flush",
        )

    # ------------------------------------------------------------------
    @property
    def cost(self):
        """The PSAM cost account (shared with the wrapped engine)."""
        return self.engine.cost

    @property
    def depth_trigger(self) -> int:
        """Queue depth that triggers an immediate flush."""
        return self.config.depth_trigger or self.max_batch

    @property
    def queue_depth(self) -> int:
        """Currently queued (admitted, undrained) requests."""
        return len(self._queue)

    @property
    def occupancy(self) -> float:
        """Round-weighted fraction of cohort lane-slots doing real work:
        each fused round offers B lane-slots (the packed width), of which
        the active lanes did work.  NaN before any cohort round runs."""
        total = self.stats["lane_rounds_total"]
        return self.stats["active_lane_rounds"] / total if total else float("nan")

    # ------------------------------------------------------------------
    def submit(self, op: str, *, tenant: str = "default", now: float = 0.0, **params):
        """Submit one request at virtual time ``now``; returns its ticket.

        The request is priced (``_estimate_words``); if the tenant's bucket
        cannot cover it, it is rejected or deferred per
        ``config.admission``.  Admitted tickets reserve the estimate and get
        ``deadline = now + slo``."""
        self.stats["submitted"] += 1
        self._m_submitted.inc(op=op, tenant=tenant)
        t = ServingTicket(
            id=self._next_id,
            op=op,
            tenant=tenant,
            params=params,
            arrival=now,
            deadline=now + self.config.slo,
            est_words=self._estimate_words(op),
        )
        self._next_id += 1
        self.ledgers.refill(now)
        led = self.ledgers.ledger(tenant)
        if led.can_admit(t.est_words):
            led.reserve(t.est_words)
            t.status = "queued"
            self._queue.append(t)
            self.stats["admitted"] += 1
            self._m_admission.inc(outcome="admitted", tenant=tenant)
        elif self.config.admission == "defer":
            t.status = "deferred"
            self._deferred.append(t)
            self.stats["deferred"] += 1
            self._m_admission.inc(outcome="deferred", tenant=tenant)
        else:
            t.status = "rejected"
            self.stats["rejected"] += 1
            self._m_admission.inc(outcome="rejected", tenant=tenant)
        self._m_queue_depth.set(float(len(self._queue)))
        self._m_deferred_depth.set(float(len(self._deferred)))
        return t

    def submit_edit(self, kind: str, u: int, v: int, w: float = 1.0, *,
                    tenant: str = "default", now: float = 0.0) -> bool:
        """Graph edits belong to the delta-overlay path: not ported yet."""
        raise NotImplementedError(_NO_MUTABILITY)

    def force_compact(self, now: float = 0.0):
        """Compaction belongs to the delta-overlay path: not ported yet."""
        raise NotImplementedError(_NO_MUTABILITY)

    def tick(self, now: float) -> list[ServingTicket]:
        """One drain-loop iteration at virtual time ``now``: refill the
        tenant buckets, re-admit deferred work that now fits, and flush the
        WHOLE queue when the depth trigger or the earliest deadline fires.
        Returns the tickets completed by this tick."""
        self.stats["ticks"] += 1
        self.ledgers.refill(now)
        self._readmit(now)
        if not self._queue:
            return []
        if len(self._queue) >= self.depth_trigger:
            self.stats["depth_flushes"] += 1
            self._m_flushes.inc(cause="depth")
        elif min(t.deadline for t in self._queue) <= now:
            self.stats["deadline_flushes"] += 1
            self._m_flushes.inc(cause="deadline")
        else:
            return []
        return self._flush(now)

    def drain(self, now: float) -> list[ServingTicket]:
        """Force-flush everything queued, ignoring both triggers."""
        self.ledgers.refill(now)
        self._readmit(now)
        if not self._queue:
            return []
        self.stats["forced_flushes"] += 1
        self._m_flushes.inc(cause="forced")
        return self._flush(now)

    def next_deadline(self) -> float | None:
        """Earliest queued deadline (when the next tick MUST run); None if
        the queue is empty."""
        return min((t.deadline for t in self._queue), default=None)

    # ------------------------------------------------------------------
    def _estimate_words(self, op: str) -> float:
        """Admission-time price of one ``op`` request: its observed rounds
        (EWMA over this service's drains of the same (op, backend) pair, or
        ``est_rounds`` while cold) of shared sweeps split across a full
        batch."""
        rounds = self.observed_rounds.get(
            (op, self.engine._backend_key), float(self.config.est_rounds)
        )
        return self._round_words * rounds / self.max_batch

    def _observe_rounds(self, t: ServingTicket) -> None:
        """Fold one drained ticket's round count into its (op, backend)
        estimate."""
        key = (t.op, self.engine._backend_key)
        obs = float(max(t.rounds, 1))
        prev = self.observed_rounds.get(key)
        a = self.config.ewma_alpha
        self.observed_rounds[key] = obs if prev is None else (1 - a) * prev + a * obs

    def _readmit(self, now: float) -> None:
        """Move deferred tickets whose tenants can now afford them back
        into the queue (FIFO); their SLO clock restarts at admission."""
        still = []
        for t in self._deferred:
            led = self.ledgers.ledger(t.tenant)
            if led.can_admit(t.est_words):
                led.reserve(t.est_words)
                t.status = "queued"
                t.deadline = now + self.config.slo
                self._queue.append(t)
                self.stats["admitted"] += 1
                self._m_admission.inc(outcome="admitted", tenant=t.tenant)
            else:
                still.append(t)
        self._deferred = still
        self._m_queue_depth.set(float(len(self._queue)))
        self._m_deferred_depth.set(float(len(self._deferred)))

    def _flush(self, now: float) -> list[ServingTicket]:
        """Drain the full queue: traversal tickets fuse into ≤ max_batch
        cohorts (FIFO), the rest go to the engine; every ticket is settled
        against its tenant's ledger."""
        self.stats["flushes"] += 1
        queue, self._queue = self._queue, []
        trav = [t for t in queue if t.op in TRAVERSAL_OPS]
        other = [t for t in queue if t.op not in TRAVERSAL_OPS]
        done: list[ServingTicket] = []
        # wall-clock readings only with a live registry
        observing = self.registry.enabled
        if observing:
            words_before = self.cost.large_reads
            t0 = time.perf_counter()
        for lo in range(0, len(trav), self.max_batch):
            done += self._drain_cohort(trav[lo : lo + self.max_batch], now)
        if other:
            done += self._drain_engine_ops(other, now)
        if observing:
            wall = time.perf_counter() - t0
            self._m_flush_seconds.observe(wall)
            if wall > 0.0:
                self._m_drift.set((self.cost.large_reads - words_before) / wall)
            for t in done:
                self._m_latency.observe(
                    max(now - t.arrival, 0.0) + wall, op=t.op, tenant=t.tenant
                )
            self._m_queue_depth.set(float(len(self._queue)))
            self._m_occupancy.set(self.occupancy)
        for t in done:
            self.ledgers.ledger(t.tenant).settle(t.est_words, t.words)
            self._observe_rounds(t)
        self.stats["served"] += len(done)
        return done

    # ------------------------------------------------------------------
    def _drain_cohort(self, tickets: list[ServingTicket], now: float):
        """Run one fused BFS+wBFS cohort to completion.

        Lanes start at the padded power-of-two width (pads are inert
        ``src=-1`` lanes); each quantum of shared rounds is one call, after
        which drained lanes' results are extracted and, when a narrower
        power of two holds the survivors, the state repacks down.  Edge
        reads are charged once per executed round and split equally across
        that round's active lanes."""
        k = len(tickets)
        B = _pow2_batch(k, self.max_batch)
        lane_tickets: list[ServingTicket | None] = list(tickets) + [None] * (B - k)
        ops = [t.op for t in tickets] + ["bfs"] * (B - k)
        srcs = [int(t.params["src"]) for t in tickets] + [-1] * (B - k)
        state, weighted = traversal_cohort_init(self.engine.graph, ops, srcs)
        shards = self.plan.num_shards if self.engine._mesh_key is not None else 1
        done: list[ServingTicket] = []
        while True:
            fn = self._cohort_fn(B, weighted)
            state, lane_rounds, active = fn(self.engine.prepared, state)
            lane_rounds = lane_rounds.cpu().numpy()
            active_np = active.cpu().numpy()
            rounds_exec = int(lane_rounds.max(initial=0))
            # each executed round streams the edge blocks once for the whole
            # cohort; its words split across that round's active lanes
            # (activity is prefix-monotone: round r's lanes have lane_rounds > r)
            for r in range(rounds_exec):
                act = np.flatnonzero(lane_rounds > r)
                self.engine.cost.charge_edgemap_batched(self.engine.graph, B,
                                                        num_shards=shards)
                share = self._round_words / len(act)
                for i in act:
                    lane_tickets[i].words += share
            for i, t in enumerate(lane_tickets):
                if t is not None:
                    t.rounds += int(lane_rounds[i])
            self.stats["cohort_rounds"] += rounds_exec
            self.stats["lane_rounds_total"] += B * rounds_exec
            self.stats["active_lane_rounds"] += int(lane_rounds.sum())
            # extract lanes that drained inside this quantum
            for i in range(B):
                t = lane_tickets[i]
                if t is not None and not active_np[i]:
                    t.result = self._unbatch(state, weighted, i)
                    t.status = "done"
                    t.finished_at = now
                    done.append(t)
                    lane_tickets[i] = None
            if not active_np.any():
                return done
            act_idx = np.flatnonzero(active_np)
            newB = _pow2_batch(len(act_idx), self.max_batch)
            if newB < B:
                # repack: survivors first, drained rows as inert padding
                pads = np.flatnonzero(~active_np)[: newB - len(act_idx)]
                idx = np.concatenate([act_idx, pads])
                rows = torch.as_tensor(idx, dtype=torch.int64, device=self.engine.graph.device)
                state = {key: (v if key == "rnd" else v[rows]) for key, v in state.items()}
                weighted = tuple(weighted[i] for i in idx)
                lane_tickets = [lane_tickets[i] for i in idx]
                B = newB
                self.stats["repacks"] += 1

    def _unbatch(self, state, weighted, i: int):
        """Lane i's result in the shape the engine serves: BFS → (parents,
        levels), wBFS → dist."""
        if weighted[i]:
            return state["dist"][i]
        return state["parents"][i], state["levels"][i]

    def _cohort_fn(self, B: int, weighted: tuple):
        """Fetch or bind the cohort step for one lane layout.

        Keyed as the JAX service keys it: (backend, mesh, B, weighted lane
        pattern, quantum, mode), the mesh None on one device; a miss bumps
        ``trace_counts[key]``."""
        key = (
            self.engine._backend_key,
            self.engine._mesh_key,
            B,
            weighted,
            self.config.round_quantum,
            self.config.mode,
        )
        fn = self._cohort_compiled.get(key)
        if fn is None:
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
            plan, mode, quantum = self.plan, self.config.mode, self.config.round_quantum

            def fn(g, state):
                return traversal_cohort_rounds(
                    g, state, weighted, quantum=quantum, mode=mode, plan=plan
                )

            self._cohort_compiled[key] = fn
        return fn

    def _drain_engine_ops(self, tickets: list[ServingTicket], now: float):
        """Delegate non-traversal tickets to the wrapped engine in one
        flush; the flush's PSAM edge-read delta is split equally across its
        tickets, and each ticket's ``rounds`` is the batch-amortized sweep
        count its share corresponds to."""
        before = self.engine.cost.large_reads
        handles = [self.engine.submit(t.op, **t.params) for t in tickets]
        results = self.engine.flush()
        share = (self.engine.cost.large_reads - before) / len(tickets)
        lane_words = self._round_words / self.max_batch
        for h, t in zip(handles, tickets):
            t.result = results[h]
            t.status = "done"
            t.finished_at = now
            t.words += share
            t.rounds += max(1, round(share / lane_words)) if lane_words else 1
        return tickets
