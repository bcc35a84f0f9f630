"""PSAM cost accounting (§3) — analytic work/IO counters on the host.

The PSAM charges unit cost for small-memory ops and large-memory reads, ω
for large-memory writes.  Sage algorithms perform **zero** large-memory
writes.  These counters model the cost of the algorithm as specified (the
paper's Table 1), not a measurement.  Every charge is mirrored into the
metrics registry as ``sage_psam_*_words_total{charge=...}`` counters.
``TenantLedger(s)`` are the serving tier's per-tenant token buckets, priced
in the same edge-read words.  The one sanctioned large-memory write is the
mutable-graph subsystem's batched compaction (``repro_torch.delta.compact``
→ ``charge_large_write``); queries over a delta overlay charge base reads
plus the overlay's small-memory words (``charge_edgemap_overlay``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..obs import get_registry
from .csr import sharded_block_counts


def _compressed_target_words(g, blocks: int) -> int:
    """Words read to stream ``blocks`` compressed target blocks: int32 first
    + uint16 valid count + packed uint16 deltas per block, plus the
    amortized COO exception triples (§5.1.3 / App. D.1)."""
    per_block = -(-(4 + 2 + 2 * g.block_size) // 4)  # bytes → words, rounded up
    exc = 3 * g.n_exceptions * blocks // max(g.num_blocks, 1)
    return per_block * blocks + exc


def _block_read_words(g, blocks: int) -> int:
    """Words of large memory read to stream ``blocks`` edge blocks:
    compressed backends at their compressed footprint (weights ride along
    uncompressed), uncompressed blocks at the flat dst + w words."""
    if hasattr(g, "compressed_bytes"):
        words = _compressed_target_words(g, blocks)
        if getattr(g, "weighted", False):
            words += g.block_size * blocks
        return words
    return 2 * g.block_size * blocks  # dst + w


def is_overlay(g) -> bool:
    """Whether ``g`` is a delta overlay snapshot (``repro_torch.delta``'s
    ``DeltaGraph``), duck-typed on ``overlay_small_words``: core never
    imports delta."""
    return hasattr(g, "overlay_small_words")


def edgemap_round_read_words(g, num_shards: int = 1) -> int:
    """Large-memory words one dense edgeMap round reads over ``num_shards``
    (per-shard block reads, including the empty blocks that pad a
    non-dividing count).  A delta overlay prices as its base: its patch
    blocks and tombstone words are small memory
    (``charge_edgemap_overlay``)."""
    if is_overlay(g):
        g = g.base
    _, padded_total = sharded_block_counts(g.num_blocks, num_shards)
    return _block_read_words(g, padded_total)


@dataclasses.dataclass
class TenantLedger:
    """One tenant's PSAM edge-read account: a token bucket priced in
    large-memory words.

    ``capacity`` is the allowance in words (None = unlimited);
    ``refill_rate`` replenishes ``available`` at that many words per unit of
    service time, capped at ``capacity``.  ``charged`` is the lifetime
    attribution; ``available`` may go negative when a drain's actual cost
    exceeds its admission estimate, and the overdraft is repaid out of later
    refills before new work admits.
    """

    capacity: float | None = None
    refill_rate: float = 0.0
    available: float = 0.0
    charged: float = 0.0
    last_refill: float = 0.0

    def refill(self, now: float) -> None:
        """Advance the token bucket to ``now`` (monotone; no-op backwards)."""
        if now > self.last_refill:
            if self.capacity is not None and self.refill_rate > 0:
                self.available = min(
                    self.capacity,
                    self.available + (now - self.last_refill) * self.refill_rate,
                )
            self.last_refill = now

    def can_admit(self, est_words: float) -> bool:
        """True when ``est_words`` of estimated edge reads fit the allowance."""
        return self.capacity is None or self.available >= est_words

    def reserve(self, est_words: float) -> None:
        """Deduct an admission estimate; settled against actuals at drain."""
        if self.capacity is not None:
            self.available -= est_words

    def settle(self, est_words: float, actual_words: float) -> None:
        """Replace the reserved estimate with the drain's actual attribution:
        refund ``est - actual`` (or charge the shortfall); ``charged``
        accrues the actual."""
        if self.capacity is not None:
            self.available += est_words - actual_words
        self.charged += actual_words


class TenantLedgers:
    """Per-tenant PSAM edge-read ledgers, keyed by tenant name.

    ``budgets`` maps tenant → ``(capacity_words, refill_rate)`` (or a bare
    capacity); tenants not named run unlimited (accounting only)."""

    def __init__(self, budgets: dict | None = None):
        self._ledgers: dict[str, TenantLedger] = {}
        for tenant, spec in (budgets or {}).items():
            cap, rate = spec if isinstance(spec, tuple) else (spec, 0.0)
            self._ledgers[tenant] = TenantLedger(
                capacity=float(cap), refill_rate=float(rate), available=float(cap)
            )

    def ledger(self, tenant: str) -> TenantLedger:
        """This tenant's ledger (created unlimited on first touch)."""
        led = self._ledgers.get(tenant)
        if led is None:
            led = self._ledgers[tenant] = TenantLedger()
        return led

    def refill(self, now: float) -> None:
        """Advance every tenant's token bucket to ``now``."""
        for led in self._ledgers.values():
            led.refill(now)

    def charge(self, tenant: str, words: float) -> None:
        """Attribute ``words`` of edge reads to ``tenant`` (no reservation)."""
        self.ledger(tenant).charged += words

    def items(self):
        """(tenant, ledger) pairs, for reporting."""
        return self._ledgers.items()

    def total_charged(self) -> float:
        """Sum of every tenant's lifetime attribution (conservation checks)."""
        return sum(led.charged for led in self._ledgers.values())


@dataclasses.dataclass
class PSAMCost:
    large_reads: int = 0      # words read from the read-only graph
    large_writes: int = 0     # words written to large memory (Sage: always 0)
    small_ops: int = 0        # small-memory reads+writes
    omega: float = 4.0        # NVRAM write/read cost ratio (paper: ~4x)
    # where charges are mirrored (None = the process-global default)
    registry: Any = dataclasses.field(default=None, repr=False, compare=False)

    def _charge(self, label: str, reads: int = 0, small: int = 0, writes: int = 0):
        """Apply one charge's deltas and mirror them into labeled counters."""
        self.large_reads += reads
        self.small_ops += small
        self.large_writes += writes
        reg = self.registry if self.registry is not None else get_registry()
        if not reg.enabled:
            return
        if reads:
            reg.counter(
                "sage_psam_large_read_words_total",
                "modeled large-memory (NVRAM) words read, by charge kind",
                labels=("charge",),
            ).inc(reads, charge=label)
        if small:
            reg.counter(
                "sage_psam_small_ops_words_total",
                "modeled small-memory (DRAM) words touched, by charge kind",
                labels=("charge",),
            ).inc(small, charge=label)
        if writes:
            reg.counter(
                "sage_psam_large_write_words_total",
                "modeled large-memory words written (Sage: always 0)",
                labels=("charge",),
            ).inc(writes, charge=label)

    def charge_edgemap_dense(self, g):
        """One single-device dense edgeMap round: every block read."""
        self._charge(
            "edgemap_dense", reads=_block_read_words(g, g.num_blocks), small=3 * g.n
        )

    def charge_edgemap_chunked(self, g, active_blocks: int):
        """One EDGEMAPCHUNKED round over ``active_blocks`` frontier blocks."""
        self._charge(
            "edgemap_chunked", reads=_block_read_words(g, active_blocks), small=3 * g.n
        )

    def charge_edgemap_planned(
        self, g, num_shards: int = 1, active_blocks=None, filter_live_blocks=None
    ):
        """One planner-dispatched edgeMap round over ``num_shards`` shards.

        Reads are charged per shard, counting the empty blocks that pad a
        non-dividing block count; the cross-shard combine moves the O(n)
        output once per shard boundary (small memory).  ``active_blocks`` is
        the sparse strategy's total active blocks (None: the dense pass).
        ``filter_live_blocks`` — the live-block count, or the
        ``GraphFilter`` whose ``block_live`` popcount it is — charges only
        the live blocks, rounded up to whole shards, plus the packed filter
        words (one per 32 slots) read once a round."""
        self._charge_batched(g, 1, num_shards=num_shards, active_blocks=active_blocks,
                             filter_live_blocks=filter_live_blocks,
                             label="edgemap_planned")

    def charge_edgemap_batched(self, g, batch: int, num_shards: int = 1,
                               active_blocks=None, filter_live_blocks=None):
        """One BATCHED edgeMap round serving ``batch`` queries: the edge
        blocks are read once for the whole batch (the same reads as
        ``charge_edgemap_planned``); the mutable state costs O(batch·n)
        small-memory words."""
        self._charge_batched(g, batch, num_shards=num_shards, active_blocks=active_blocks,
                             filter_live_blocks=filter_live_blocks,
                             label="edgemap_batched")

    def _charge_batched(self, g, batch: int, *, num_shards: int, active_blocks,
                        filter_live_blocks, label: str):
        """The arithmetic behind the planned and batched charges; ``label``
        names their counter series."""
        _, padded_total = sharded_block_counts(g.num_blocks, num_shards)
        blocks = padded_total if active_blocks is None else active_blocks
        reads = 0
        if filter_live_blocks is not None:
            live = filter_live_blocks
            if hasattr(live, "block_live"):  # a GraphFilter
                live = int(live.block_live.sum())
            else:
                live = int(live)
            per = -(-live // max(num_shards, 1))  # live blocks, whole shards
            blocks = min(blocks, per * num_shards)
            # the filter words stream alongside the blocks they mask
            reads += padded_total * (g.block_size // 32)
        reads += _block_read_words(g, blocks)
        self._charge(label, reads=reads,
                     small=batch * (3 * g.n + (num_shards - 1) * g.n))

    def charge_edgemap_sparse(
        self,
        g,
        live_blocks: int,
        *,
        batch: int = 1,
        num_shards: int = 1,
        tile_blocks: int = 1,
    ):
        """One frontier-sparse STREAMED edgeMap round (``sparse_streamed``):
        large-memory bytes for the streamed (live) blocks only, rounded up
        to whole chunks of ``tile_blocks`` per shard; the compacted live-id
        list and the O(batch·n) vertex state land in small memory."""
        tb = max(tile_blocks, 1)
        per_shard_live = -(-int(live_blocks) // max(num_shards, 1))
        per_shard_streamed = -(-per_shard_live // tb) * tb
        self._charge(
            "edgemap_sparse",
            reads=_block_read_words(g, per_shard_streamed * num_shards),
            small=g.num_blocks + batch * (3 * g.n + (num_shards - 1) * g.n),
        )

    def charge_edgemap_round(self, g, batch: int, num_shards: int = 1):
        """One dense batched edgeMap round over any backend: a delta overlay
        is charged ``charge_edgemap_overlay``, every other graph
        ``charge_edgemap_batched``."""
        if is_overlay(g):
            self.charge_edgemap_overlay(g, batch=batch, num_shards=num_shards)
        else:
            self.charge_edgemap_batched(g, batch, num_shards=num_shards)

    def charge_edgemap_overlay(self, dg, batch: int = 1, num_shards: int = 1):
        """One edgeMap round over a delta overlay (``repro_torch.delta``):
        large-memory reads are the BASE blocks only, at the per-shard padded
        count a round over the base alone would read; the overlay's patch
        blocks and tombstone words (``dg.overlay_small_words``) land in
        small memory beside the O(batch·n) vertex state and the per-shard
        combine."""
        _, base_padded = sharded_block_counts(dg.num_base_blocks, num_shards)
        self._charge(
            "edgemap_overlay",
            reads=_block_read_words(dg.base, base_padded),
            small=dg.overlay_small_words + batch * (3 * dg.n + (num_shards - 1) * dg.n),
        )

    def charge_filter_pack(self, g, touched_blocks: int):
        """One graphFilter pack over ``touched_blocks`` blocks: the edge ids
        its predicate needs are read from large memory; only the filter
        bits and the degrees (small memory) are written."""
        if hasattr(g, "compressed_bytes"):
            reads = _compressed_target_words(g, touched_blocks)
        else:
            reads = touched_blocks * g.block_size
        self._charge(
            "filter_pack",
            reads=reads,
            small=touched_blocks * (g.block_size // 32) + g.n,
        )

    def charge_large_write(self, words: int, label: str = "large_write"):
        """Charge ``words`` of large-memory writes at the ω premium.  No query
        path calls this (Table 1's claim is ``large_writes == 0``); its one
        caller is ``repro_torch.delta.compact``."""
        self._charge(label, writes=int(words))

    def charge_small(self, words: int):
        """Charge ``words`` of small-memory operations."""
        self._charge("small", small=words)

    @property
    def work(self) -> float:
        """PSAM work: reads unit cost, large writes cost ω."""
        return self.large_reads + self.small_ops + self.omega * self.large_writes

    def gbbs_equivalent_work(self, mutated_words: int) -> float:
        """What the same algorithm would cost if, like GBBS, it wrote
        ``mutated_words`` words to large memory (e.g. in-place edge packing)."""
        return self.large_reads + self.small_ops + self.omega * mutated_words
