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

**Mutability** (``repro_torch.delta``): constructed over a
:class:`~repro_torch.delta.DeltaOverlay` the service also serves edits.
``submit_edit`` admits or rejects (never defers: deferral would reorder the
edit log) one insert or delete, priced at the amortized compaction
estimate; admitted edits apply at the next tick or drain boundary, so the
queries of one flush see one snapshot; after each flush the
:class:`~repro_torch.tuning.OverlayTrigger` decides whether the overlay's
accumulated surcharge pays for folding it into a fresh compressed base
(``repro_torch.delta.compact``, the subsystem's only large-memory write,
persisted atomically when ``config.ckpt_dir`` is set).  Cohort state
lives where the plan's prepared graph computes; the accounting reads the
host graph.

**Ranks** — on a process plan (``make_plan(g, mesh=make_process_mesh(...))``)
every rank constructs the same service from the same host graph and
config, submits the same stream with the same virtual ``now``, and gets
every ticket's result, replicated, on its own device.  Construction
compares the ranks' configs (``check_replicated``) and every flush the
digest of its queue and of the edits admitted so far
(``check_same_digest``); either raises ``ValueError`` on every rank.  A
compaction is folded on every rank and persisted by rank 0 alone, which
the others wait for (``run_on_first_rank``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..algorithms.traversal import traversal_cohort_init, traversal_cohort_rounds
from ..core.mesh import check_replicated, check_same_digest, digest, run_on_first_rank
from ..core.psam import TenantLedgers, edgemap_round_read_words
from ..delta import DeltaOverlay, compact, save_compacted
from ..delta import compact_write_words as _compact_write_words
from ..obs import DEFAULT_LATENCY_BUCKETS, get_registry
from ..tuning.defaults import DEFAULT_EDITS_PER_COMPACT, DEFAULT_EST_ROUNDS
from ..tuning.overlay import constants_overlay_trigger
from .engine import QueryEngine, _pow2_batch

TRAVERSAL_OPS = ("bfs", "wbfs")


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

    The mutability knobs matter only for a DeltaOverlay-backed service:
    ``compact_trigger`` is the :class:`~repro_torch.tuning.OverlayTrigger`
    deciding when to fold the overlay into a fresh compressed base
    (default: the constants trigger); ``ckpt_dir`` (when set) persists each
    compacted base atomically (``repro_torch.delta.save_compacted``),
    keeping the newest ``compact_keep`` step directories.
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
    device, or a :class:`~repro_torch.delta.DeltaOverlay` for a mutable
    service (queries run over ``overlay.snapshot()``, and ``submit_edit`` /
    ``force_compact`` become available); ``plan`` is the ``ExecutionPlan``
    every batch runs under, and ``config`` the :class:`ServiceConfig`.  The service runs in virtual
    time: callers stamp ``submit`` and ``tick`` with ``now``.  Only the
    ``sage_service_flush_seconds`` histogram, the latencies and the drift
    gauge read the wall clock, and only with a live ``registry`` (the
    process-global default when omitted).

    ``stats`` extends the engine's counters with trigger attribution and
    round-weighted lane occupancy; ``cost`` is the engine's PSAM account,
    which the cohort rounds are charged to as well.
    """

    def __init__(self, g, *, plan=None, config: ServiceConfig | None = None, registry=None):
        self.config = config or ServiceConfig()
        self.registry = registry if registry is not None else get_registry()
        self.overlay = g if isinstance(g, DeltaOverlay) else None
        if self.overlay is not None:
            g = self.overlay.snapshot()
        self.engine = QueryEngine(
            g, plan=plan, max_batch=self.config.max_batch, registry=self.registry
        )
        self.max_batch = self.engine.max_batch
        self.plan = plan
        # per-(op, backend) observed rounds-per-request (EWMA, settled at
        # drain): the admission estimate once warm
        self.observed_rounds: dict[tuple, float] = {}
        self.ledgers = TenantLedgers(self.config.budgets)
        self._price_round()
        self._queue: list[ServingTicket] = []
        self._deferred: list[ServingTicket] = []
        self._cohort_compiled: dict[tuple, Callable] = {}
        self.trace_counts: dict[tuple, int] = {}
        self._next_id = 0
        # mutability state (inert unless overlay-backed): admitted edits not
        # yet applied, their (tenant, estimate) ledger entries (settled
        # pro-rata at compaction), the next checkpoint step, the PSAM read
        # mark the trigger measures sweeps from, and the observed
        # edits-per-compaction EWMA that amortizes edit pricing
        self.compact_trigger = self.config.compact_trigger or (
            constants_overlay_trigger() if self.overlay is not None else None
        )
        self._edits: list[tuple] = []
        self._edit_ledger: list[tuple[str, float]] = []
        self._compact_step = 0
        self._reads_at_compact = self.engine.cost.large_reads
        self._edits_per_compact = float(DEFAULT_EDITS_PER_COMPACT)
        # on a process plan: the ranks' digest of every edit admitted so far
        self._ranks = self.engine._ranks
        self._edit_digest = b""
        if self._ranks is not None:
            check_replicated(self._ranks, self._rank_fields(), "ServingService")
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
        self._m_edits = reg.counter(
            "sage_delta_edits_total", "edits applied to the overlay", labels=("kind",),
        )
        self._m_patch_edges = reg.gauge(
            "sage_delta_patch_edges", "live inserted edges in the DRAM overlay"
        )
        self._m_tombstones = reg.gauge(
            "sage_delta_tombstones", "base edges masked dead by the overlay"
        )
        self._m_overlay_words = reg.gauge(
            "sage_delta_overlay_small_words",
            "per-sweep DRAM small-op surcharge of the current overlay",
        )

    def _rank_fields(self) -> dict:
        """What every rank of a process plan must hold equal beyond the
        engine's: each config field that steers a decision, and the read
        quantum admission prices in."""
        cfg, trig = self.config, self.compact_trigger
        return {
            "slo": cfg.slo, "depth_trigger": self.depth_trigger,
            "round_quantum": cfg.round_quantum, "admission": cfg.admission,
            "budgets": cfg.budgets, "mode": cfg.mode, "est_rounds": cfg.est_rounds,
            "ewma_alpha": cfg.ewma_alpha,
            "compact_trigger": dataclasses.asdict(trig) if dataclasses.is_dataclass(trig)
            else repr(trig),
            "compact_keep": cfg.compact_keep, "ckpt_dir set": cfg.ckpt_dir is not None,
            "mutable": self.overlay is not None, "round_words": self._round_words,
        }

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
        """Submit one graph edit (``kind`` in {"insert", "delete"}) at
        virtual time ``now``; returns True iff admitted.

        Edits are admit-or-reject only, whatever ``config.admission`` says:
        a deferred edit would re-enter the log after later edits.  The price
        is the next compaction's ``ω × compact_write_words`` split over the
        observed edits-per-compaction (EWMA; ``DEFAULT_EDITS_PER_COMPACT``
        while cold), reserved against the tenant's ledger and settled
        pro-rata against the actual write when the overlay compacts.
        Admitted edits apply at the next tick or drain boundary."""
        if self.overlay is None:
            raise TypeError(
                "submit_edit requires a DeltaOverlay-backed service "
                "(construct with ServingService(DeltaOverlay(base), ...))"
            )
        if kind not in ("insert", "delete"):
            raise ValueError(f"kind must be 'insert'|'delete', got {kind!r}")
        self.stats["edits_submitted"] += 1
        est = self._estimate_edit_words()
        self.ledgers.refill(now)
        led = self.ledgers.ledger(tenant)
        if not led.can_admit(est):
            self.stats["edits_rejected"] += 1
            self._m_admission.inc(outcome="edit_rejected", tenant=tenant)
            return False
        led.reserve(est)
        self._edit_ledger.append((tenant, est))
        edit = (("insert", int(u), int(v), float(w)) if kind == "insert"
                else ("delete", int(u), int(v)))
        self._edits.append(edit)
        if self._ranks is not None:
            self._edit_digest = digest((self._edit_digest, tenant, edit))
        self._m_admission.inc(outcome="edit_admitted", tenant=tenant)
        return True

    def force_compact(self, now: float = 0.0):
        """Apply pending edits, then compact the overlay whatever the
        trigger says; returns the new ``CompressedCSR`` base, or None when
        the service has no overlay.  Persistence and ledger settlement are
        a triggered compaction's."""
        if self.overlay is None:
            return None
        self._apply_edits()
        return self._compact(now)

    def tick(self, now: float) -> list[ServingTicket]:
        """One drain-loop iteration at virtual time ``now``: apply buffered
        edits (the graph steps between flushes, never inside one), refill
        the tenant buckets, re-admit deferred work that now fits, and flush
        the WHOLE queue when the depth trigger or the earliest deadline
        fires.  Returns the tickets completed by this tick."""
        self.stats["ticks"] += 1
        self._apply_edits()
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
        self._apply_edits()
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

    def _estimate_edit_words(self) -> float:
        """Admission-time price of one edit: the next compaction's ω write
        amortized over the observed edits-per-compaction count."""
        return (
            self.cost.omega
            * float(self.engine.graph.compact_write_words)
            / max(self._edits_per_compact, 1.0)
        )

    def _apply_edits(self) -> None:
        """Fold buffered edits into the overlay and step the served graph to
        the new snapshot, at tick and drain boundaries only."""
        if self.overlay is None or not self._edits:
            return
        edits, self._edits = self._edits, []
        self.overlay.apply(edits)
        self.stats["edits_applied"] += len(edits)
        for e in edits:
            self._m_edits.inc(kind=e[0])
        self._set_graph(self.overlay.snapshot())

    def _price_round(self) -> None:
        """The read quantum of the served graph: per-shard block reads over
        the plan's shards, from the prepared graph (each rank's shard pads
        to the same block and exception counts, so every rank prices the
        same), or the graph's own on one device."""
        if self.plan is not None:
            self._round_words = self.plan.edge_read_words_per_round(self.engine.prepared)
        else:
            self._round_words = edgemap_round_read_words(self.engine.graph)

    def _set_graph(self, dg) -> None:
        """Point the wrapped engine (and the per-round word model) at a new
        snapshot; on a process plan each rank places its own shard of it.
        The cohort and engine caches key on the backend name ("DeltaGraph"),
        stable across snapshots."""
        eng = self.engine
        eng.graph = dg
        eng.prepared = dg if self.plan is None else self.plan.prepare(dg)
        self._price_round()
        if self.overlay is not None:
            self._m_patch_edges.set(float(self.overlay.num_patch_edges))
            self._m_tombstones.set(float(self.overlay.num_tombstones))
            self._m_overlay_words.set(float(dg.overlay_small_words))

    def _maybe_compact(self, now: float) -> None:
        """Post-flush compaction check: the trigger gets the sweeps of edge
        reads issued since the last compaction (from the PSAM account) and
        folds the overlay once its surcharge has paid for the ω write.  A
        clean overlay (no patches, no tombstones) never compacts."""
        if self.overlay is None or self.compact_trigger is None:
            return
        if self.overlay.num_patch_edges == 0 and self.overlay.num_tombstones == 0:
            return
        sweeps = (self.cost.large_reads - self._reads_at_compact) / max(self._round_words, 1.0)
        if self.compact_trigger.should_compact(
            self.engine.graph, sweeps_since_compact=sweeps, omega=self.cost.omega
        ):
            self._compact(now)

    def _compact(self, now: float):
        """Fold the overlay into a fresh CompressedCSR base — the only
        large-memory write of the mutable path: charge ``ω × write words``,
        persist the step when configured, settle the edit ledger pro-rata
        against the actual write, fold the realized edits-per-compaction
        into the admission EWMA, and rebase an empty overlay on the new
        base.  On a process plan every rank folds the same overlay (host
        work) and rank 0 alone persists the step; no rank goes on before
        it is published, and a failed write raises on every rank."""
        del now
        c = compact(self.overlay, cost=self.cost, registry=self.registry)
        ckpt_dir, step = self.config.ckpt_dir, self._compact_step
        if ckpt_dir is not None:
            run_on_first_rank(
                self._ranks,
                lambda: save_compacted(ckpt_dir, step, c, keep=self.config.compact_keep),
                f"persisting compaction step {step} to {ckpt_dir}")
        self._compact_step += 1
        self.stats["compactions"] += 1
        ledger, self._edit_ledger = self._edit_ledger, []
        if ledger:
            actual = self.cost.omega * float(_compact_write_words(c))
            share = actual / len(ledger)
            for tenant, est in ledger:
                self.ledgers.ledger(tenant).settle(est, share)
            a = self.config.ewma_alpha
            self._edits_per_compact = (1 - a) * self._edits_per_compact + a * float(len(ledger))
        self.overlay = DeltaOverlay(c)
        self._set_graph(self.overlay.snapshot())
        self._reads_at_compact = self.cost.large_reads
        return c

    def _flush(self, now: float) -> list[ServingTicket]:
        """Drain the full queue: traversal tickets fuse into ≤ max_batch
        cohorts (FIFO), the rest go to the engine; every ticket is settled
        against its tenant's ledger."""
        if self._ranks is not None:
            check_same_digest(
                self._ranks,
                (now, [(t.id, t.op, t.tenant, t.params) for t in self._queue],
                 self._compact_step, self._edit_digest),
                "ServingService flush")
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
        self._maybe_compact(now)
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
        state, weighted = traversal_cohort_init(self.engine.prepared, ops, srcs)
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
                self.engine.cost.charge_edgemap_round(self.engine.graph, B, num_shards=shards)
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
                rows = torch.as_tensor(idx, dtype=torch.int64, device=self.engine.prepared.device)
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
        results = self.engine._drain()  # the flush's digest covered these tickets
        share = (self.engine.cost.large_reads - before) / len(tickets)
        lane_words = self._round_words / self.max_batch
        for h, t in zip(handles, tickets):
            t.result = results[h]
            t.status = "done"
            t.finished_at = now
            t.words += share
            t.rounds += max(1, round(share / lane_words)) if lane_words else 1
        return tickets
