"""Delta overlay — log-structured mutable graphs under the PSAM.

Sage's semi-asymmetric contract (edges read-only in large memory, O(n)
mutable small memory) is a log-structured storage design: edge insertions
and deletions go into an overlay, queries run over ``base ∪ delta``, and
the overlay folds into a fresh base only in rare, batched compactions
(``repro_torch.delta.compact``, the only large-memory write of this
subsystem).

* :class:`DeltaOverlay` — the host-side edit log.  Deletions of base edges
  become tombstone bits over the base's slots (packed into the
  ``edge_active`` word layout, so bit 31 of a word is slot 31 of its
  32-slot group); insertions become patch edges.  Edit semantics are
  upsert/delete over the directed edge set, exactly what ``build_csr``
  would build from the final edge list.
* :class:`DeltaGraph` — an immutable ``base ∪ delta`` snapshot with the
  graph-backend surface: the base blocks with tombstoned slots masked to
  the sentinel ``n``, then the patch blocks (the same ``F_B`` width, owner
  in ``block_src``), so edgeMap, the filters, the algorithms, the engine
  and the service reduce base and patch through the same monoid in the
  same sweep.  It takes the generic edgeMap path: no streaming decoder (a
  ``sparse_streamed`` round runs plain ``sparse``) and no kernel, as in the
  JAX package.

The base's live slots are looked up through a sorted int64 key array
(``src * n + dst``) with ``searchsorted``, never a per-slot dict, and the
snapshot builds its patch blocks with array code.  The block views a sweep
reads (``block_dst``, ``block_w``, ``edge_valid``, ``edge_src``) are
materialised once per snapshot on the base's device, from the base blocks
the overlay decoded once when it was built: a compressed base is decoded
once an overlay (the base changes only at compaction, which builds a new
overlay), not at every snapshot or access.

PSAM accounting: only the base blocks live in large memory; the patch
blocks and tombstone words are small memory (``overlay_small_words``,
charged by ``PSAMCost.charge_edgemap_overlay``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.compressed import CompressedCSR
from ..core.csr import CSRGraph, sharded_block_counts
from ..core.graph_filter import pack_bits, unpack_word_bits

__all__ = ["DeltaGraph", "DeltaOverlay"]


def _live_words_per_block(block_size: int) -> int:
    """Tombstone-mask words per block: ceil(F_B / 32)."""
    return -(-block_size // 32)


def _next_pow2(k: int) -> int:
    b = 1
    while b < k:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class DeltaGraph:
    """Immutable ``base ∪ delta`` snapshot with the graph-backend surface.

    ``base`` is the read-only graph (``CSRGraph`` or ``CompressedCSR``).
    ``live_words`` is the packed tombstone mask over the base's slots
    (int32 bit-views of the uint32 words; bit set = slot live, only ever
    set on a real base edge).  ``patch_*`` are the inserted edges in dense
    blocks of the base's ``F_B`` width, appended after the base blocks in
    every block view: consumers see ``num_blocks = num_base_blocks + PB``
    blocks.  ``degrees`` / ``m`` describe the live edge set.
    """

    base: CSRGraph | CompressedCSR
    patch_src: torch.Tensor   # int32[PB]      — owner vertex (sentinel n on pads)
    patch_dst: torch.Tensor   # int32[PB, F_B] — targets (sentinel n on pads)
    patch_w: torch.Tensor     # float32[PB, F_B]
    live_words: torch.Tensor  # int32[NB_base, ceil(F_B/32)] — 1 = live base slot
    degrees: torch.Tensor     # int32[n] — live out-degrees
    n: int
    m: int
    num_blocks: int
    num_base_blocks: int
    block_size: int
    weighted: bool
    # the base's decoded (block_dst, block_w), shared by every snapshot of
    # one overlay; None reads them from the base
    base_blocks: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def num_patch_blocks(self) -> int:
        """Patch blocks appended after the base's block range."""
        return self.num_blocks - self.num_base_blocks

    # -- block views, materialised once per snapshot ---------------------
    @functools.cached_property
    def _base_live(self) -> torch.Tensor:
        """bool[NB_base, F_B] — the unpacked tombstone mask."""
        return unpack_word_bits(self.live_words)[:, : self.block_size]

    @functools.cached_property
    def block_src(self) -> torch.Tensor:
        """int32[NB] owner per block: base owners then patch owners."""
        return torch.cat([self.base.block_src, self.patch_src])

    @functools.cached_property
    def _base_block_views(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.base_blocks is not None:
            return self.base_blocks
        return self.base.block_dst, self.base.block_w

    @functools.cached_property
    def block_dst(self) -> torch.Tensor:
        """int32[NB, F_B] targets, tombstoned base slots masked to ``n``."""
        masked = torch.where(self._base_live, self._base_block_views[0], self.n)
        return torch.cat([masked, self.patch_dst])

    @functools.cached_property
    def block_w(self) -> torch.Tensor:
        """float32[NB, F_B] weights (zero on tombstoned and padding slots)."""
        masked = torch.where(self._base_live, self._base_block_views[1], 0.0)
        return torch.cat([masked, self.patch_w])

    @functools.cached_property
    def edge_valid(self) -> torch.Tensor:
        """bool[NB*F_B] — live base slots ++ real patch slots."""
        patch_valid = (self.patch_dst < self.n).reshape(-1)
        return torch.cat([self._base_live.reshape(-1), patch_valid])

    @property
    def edge_dst(self) -> torch.Tensor:
        return self.block_dst.reshape(-1)

    @functools.cached_property
    def edge_src(self) -> torch.Tensor:
        """int32[NB*F_B] — owner per slot, sentinel n on dead slots."""
        src = self.block_src[:, None].expand(self.num_blocks, self.block_size).reshape(-1)
        return torch.where(self.edge_valid, src, self.n)

    @property
    def edge_w(self) -> torch.Tensor:
        return self.block_w.reshape(-1)

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    def out_degree(self, v):
        return self.degrees[v]

    # -- PSAM surface (metadata only) ------------------------------------
    @property
    def overlay_small_words(self) -> int:
        """Small-memory words one full sweep touches beyond the base blocks:
        the patch blocks' dst + w words plus one tombstone word per 32 base
        slots.  Cost-model consumers dispatch on this attribute."""
        return (
            self.num_patch_blocks * 2 * self.block_size
            + self.num_base_blocks * _live_words_per_block(self.block_size)
        )

    @property
    def compact_write_words(self) -> int:
        """Estimated large-memory words ``compact()`` would write now: the
        live edge set re-encoded as a fresh ``CompressedCSR`` (weights
        uncompressed when weighted) — the compaction trigger's estimate."""
        blocks = max(-(-self.m // self.block_size), 1)
        per_block = -(-(4 + 2 + 2 * self.block_size) // 4)
        words = per_block * blocks
        if self.weighted:
            words += self.block_size * blocks
        return words

    # -- sharding --------------------------------------------------------
    def shard(self, num_shards: int) -> list["DeltaGraph"]:
        """Partition base AND patch blocks into ``num_shards`` ranges.

        The base splits through its own ``shard``; ``live_words`` splits
        along the same block ranges with all-dead (zero) padding rows, so
        shard s's tombstone rows line up with shard s's base blocks.  The
        patch blocks range-split on their own, padded with sentinel rows.
        Each shard is a ``DeltaGraph`` over the global vertex space with
        the global ``n``, ``m`` and ``degrees``.
        """
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        FB, n = self.block_size, self.n
        base_shards = self.base.shard(num_shards)
        per_b, padded_b = sharded_block_counts(self.num_base_blocks, num_shards)
        lw = self.live_words
        if padded_b > self.num_base_blocks:
            lw = torch.cat([lw, lw.new_zeros((padded_b - self.num_base_blocks, lw.shape[1]))])
        PB = self.num_patch_blocks
        per_p, padded_p = sharded_block_counts(PB, num_shards)
        psrc, pdst, pw = self.patch_src, self.patch_dst, self.patch_w
        if padded_p > PB:
            pad = padded_p - PB
            psrc = torch.cat([psrc, psrc.new_full((pad,), n)])
            pdst = torch.cat([pdst, pdst.new_full((pad, FB), n)])
            pw = torch.cat([pw, pw.new_zeros((pad, FB))])
        shards = []
        for s in range(num_shards):
            bl, bh = s * per_b, (s + 1) * per_b
            pl, ph = s * per_p, (s + 1) * per_p
            shards.append(
                dataclasses.replace(
                    self,
                    base=base_shards[s],
                    patch_src=psrc[pl:ph],
                    patch_dst=pdst[pl:ph],
                    patch_w=pw[pl:ph],
                    live_words=lw[bl:bh],
                    num_base_blocks=per_b,
                    num_blocks=per_b + per_p,
                    base_blocks=None,
                )
            )
        return shards


class DeltaOverlay:
    """Host-side mutable edit log over a read-only base graph.

    Accepts directed-edge ``insert`` / ``delete`` edits (upsert semantics:
    inserting an existing edge replaces its weight; deleting a missing edge
    is a no-op; self-loops are dropped, as ``build_csr`` drops them) and
    snapshots the current ``base ∪ delta`` as an immutable
    :class:`DeltaGraph` on the base's device.

    Storage: per real base edge its int64 key ``src * n + dst`` (the base's
    real slots, in slot order, which ``build_csr`` leaves in key order), its
    weight and a live bit, on the host; the slot ids and the base's decoded
    blocks on the base's device, for the snapshots; a small dict of patch
    edges.  The base's tensors are never written.

    After any edit script, ``snapshot()`` serves every order-insensitive
    query bit-identically to ``build_csr`` over the final edge set.
    Re-inserting a tombstoned base edge with a *new* weight leaves the slot
    tombstoned and carries the edge on the patch side; the same weight
    (compared as the slot's float32 widened to a Python float, as the JAX
    package compares it) revives the slot.
    """

    def __init__(self, base: CSRGraph | CompressedCSR):
        if not isinstance(base, (CSRGraph, CompressedCSR)):
            raise TypeError(
                f"DeltaOverlay base must be CSRGraph | CompressedCSR, "
                f"got {type(base).__name__}"
            )
        self.base = base
        self.n = n = int(base.n)
        self.block_size = int(base.block_size)
        self.weighted = bool(base.weighted)
        # one decode of a compressed base, shared by every snapshot
        self._base_blocks = (base.block_dst, base.block_w)
        slots = torch.nonzero(base.edge_valid).reshape(-1)
        src = base.block_src[torch.div(slots, self.block_size, rounding_mode="floor")]
        dst = self._base_blocks[0].reshape(-1)[slots]
        keys = src.to(torch.int64) * n + dst.to(torch.int64)
        self._slots_dev = slots
        self._keys = keys.cpu().numpy()
        self._w = base.edge_w[slots].cpu().numpy()
        self._base_deg = torch.bincount(src.to(torch.int64), minlength=n)[:n].cpu().numpy()
        self._live = np.ones(self._keys.shape[0], dtype=bool)
        # build_csr lays the real slots out by (src, dst), each edge once:
        # the slot order is the key order the lookup searches
        if not bool(np.all(self._keys[1:] > self._keys[:-1])):
            raise ValueError("DeltaOverlay base: real slots are not in strictly increasing "
                             "(src, dst) order, as build_csr lays them out")
        self._patch: dict[int, float] = {}
        self.edits_applied = 0

    @property
    def device(self) -> torch.device:
        return self.base.device

    # -- sizes -----------------------------------------------------------
    @property
    def num_patch_edges(self) -> int:
        """Inserted edges currently living on the patch side."""
        return len(self._patch)

    @property
    def num_tombstones(self) -> int:
        """Base slots masked dead (deleted, or re-weighted to the patch)."""
        return int(self._live.size - np.count_nonzero(self._live))

    @property
    def num_live_edges(self) -> int:
        """Edges the current snapshot serves: live base + patch."""
        return int(np.count_nonzero(self._live)) + len(self._patch)

    # -- lookup ----------------------------------------------------------
    def _positions(self, keys: np.ndarray) -> np.ndarray:
        """Each key's position in the base's real-slot arrays, -1 if absent."""
        sk = self._keys
        if not sk.size:
            return np.full(keys.shape, -1)
        i = np.minimum(np.searchsorted(sk, keys), sk.size - 1)
        return np.where(sk[i] == keys, i, -1)

    def _position(self, key: int) -> int:
        return int(self._positions(np.array([key], np.int64))[0])

    # -- edits -----------------------------------------------------------
    def _check(self, u: int, v: int) -> None:
        if not (0 <= u < self.n and 0 <= v < self.n):
            raise ValueError(f"edge ({u}, {v}) out of range for n={self.n}")

    def _insert(self, u, v, w=1.0, pos=None) -> bool:
        u, v = int(u), int(v)
        self._check(u, v)
        self.edits_applied += 1
        if u == v:
            return False
        w = 1.0 if not self.weighted else float(w)
        key = u * self.n + v
        if pos is None:
            pos = self._position(key)
        if pos >= 0 and float(self._w[pos]) == w:
            changed = not bool(self._live[pos]) or key in self._patch
            self._live[pos] = True
            self._patch.pop(key, None)
            return changed
        if pos >= 0:
            # the weight differs from the immutable base slot: tombstone it
            # and carry the edge (with its new weight) on the patch side
            self._live[pos] = False
        changed = self._patch.get(key) != w
        self._patch[key] = w
        return changed

    def _delete(self, u, v, pos=None) -> bool:
        u, v = int(u), int(v)
        self._check(u, v)
        self.edits_applied += 1
        key = u * self.n + v
        existed = self._patch.pop(key, None) is not None
        if pos is None:
            pos = self._position(key)
        if pos >= 0 and self._live[pos]:
            self._live[pos] = False
            existed = True
        return existed

    def insert(self, u: int, v: int, w: float = 1.0) -> bool:
        """Upsert directed edge ``(u, v)``; True if the edge set changed.
        Self-loops are dropped; unweighted bases ignore ``w``."""
        return self._insert(u, v, w)

    def delete(self, u: int, v: int) -> bool:
        """Delete directed edge ``(u, v)``; True if it existed."""
        return self._delete(u, v)

    def _batch_positions(self, edits: list) -> list:
        """The base position of every edit's edge from one ``searchsorted``
        (None where the edit is not a well-formed in-range edit: its own
        call then raises where the JAX package raises)."""
        n = self.n
        keys = np.full(len(edits), -1, np.int64)
        for i, e in enumerate(edits):
            if e[0] in ("insert", "delete") and len(e) >= 3:
                try:
                    u, v = int(e[1]), int(e[2])
                except (TypeError, ValueError):
                    continue
                if 0 <= u < n and 0 <= v < n:
                    keys[i] = u * n + v
        pos = self._positions(keys)
        return [None if k < 0 else int(p) for k, p in zip(keys, pos)]

    def apply(self, edits) -> int:
        """Apply an edit script: iterable of ``("insert", u, v[, w])`` /
        ``("delete", u, v)`` tuples, in order.  The base lookups of the
        whole script are one ``searchsorted``; the edits then apply one by
        one (order matters under upsert).  Returns how many edits changed
        the edge set."""
        edits = list(edits)
        positions = self._batch_positions(edits)
        changed = 0
        for e, pos in zip(edits, positions):
            kind = e[0]
            if kind == "insert":
                changed += bool(self._insert(*e[1:], pos=pos))
            elif kind == "delete":
                changed += bool(self._delete(e[1], e[2], pos=pos))
            else:
                raise ValueError(f"unknown edit kind {kind!r}")
        return changed

    # -- live edge set (host) --------------------------------------------
    def _patch_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Patch keys sorted (= by (src, dst)) and their float32 weights."""
        keys = np.array(sorted(self._patch), dtype=np.int64)
        w = np.array([self._patch[k] for k in keys.tolist()], dtype=np.float64)
        return keys, w.astype(np.float32)

    def live_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The current directed edge set as host ``(src, dst, w)`` arrays:
        live base slots in slot order, then the patch edges sorted — the
        input a from-scratch ``build_csr`` (and ``compact``) consumes."""
        idx = np.flatnonzero(self._live)
        k = self._keys[idx]
        src = (k // self.n).astype(np.int32)
        dst = (k % self.n).astype(np.int32)
        w = self._w[idx]
        if self._patch:
            pk, pw = self._patch_arrays()
            src = np.concatenate([src.astype(np.int64), pk // self.n])
            dst = np.concatenate([dst.astype(np.int64), pk % self.n])
            w = np.concatenate([w.astype(np.float32), pw])
        return src, dst, w

    # -- snapshot --------------------------------------------------------
    def snapshot(self) -> DeltaGraph:
        """Freeze the current ``base ∪ delta`` as a DeltaGraph.

        Patch edges pack per source vertex (sorted by ``(src, dst)``,
        front-packed into ``F_B``-wide blocks, sentinel padding), and the
        patch block count rounds up to a power of two so a growing patch
        changes shapes only at doublings.
        """
        n, FB = self.n, self.block_size
        NB = self.base.num_blocks
        dev = self.base.device
        live = torch.zeros(NB * FB, dtype=torch.bool, device=dev)
        live[self._slots_dev] = torch.from_numpy(self._live).to(dev)
        W = _live_words_per_block(FB)
        mask = live.view(NB, FB)
        if W * 32 != FB:
            mask = torch.nn.functional.pad(mask, (0, W * 32 - FB))
        live_words = pack_bits(mask)

        pk, pw = self._patch_arrays()
        psrc, pdst = pk // n, pk % n
        pdeg = np.bincount(psrc, minlength=n)[:n].astype(np.int64)
        nblk = -(-pdeg // FB)
        used = int(nblk.sum())
        PB_cap = _next_pow2(max(used, 1))
        patch_src = np.full(PB_cap, n, np.int32)
        patch_dst = np.full((PB_cap, FB), n, np.int32)
        patch_w = np.zeros((PB_cap, FB), np.float32)
        if pk.size:
            blk_start = np.cumsum(nblk) - nblk
            run_start = np.cumsum(pdeg) - pdeg
            r = np.arange(pk.size) - run_start[psrc]
            blk = blk_start[psrc] + r // FB
            patch_dst[blk, r % FB] = pdst
            patch_w[blk, r % FB] = pw
            patch_src[:used] = np.repeat(np.arange(n, dtype=np.int32), nblk)
        dead = self._keys[~self._live] // n
        degrees = self._base_deg - np.bincount(dead, minlength=n)[:n] + pdeg
        m = int(np.count_nonzero(self._live)) + int(pk.size)
        return DeltaGraph(
            base=self.base,
            patch_src=torch.from_numpy(patch_src).to(dev),
            patch_dst=torch.from_numpy(patch_dst).to(dev),
            patch_w=torch.from_numpy(patch_w).to(dev),
            live_words=live_words,
            degrees=torch.from_numpy(degrees.astype(np.int32)).to(dev),
            n=n,
            m=m,
            num_blocks=NB + PB_cap,
            num_base_blocks=NB,
            block_size=FB,
            weighted=self.weighted,
            base_blocks=self._base_blocks,
        )
