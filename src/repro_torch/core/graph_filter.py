"""graphFilter (§4.2) — a bit-packed, mutable *view* over the immutable CSR.

The CSR edge arrays (large memory) are never written.  All mutation happens
in this structure, which costs ``m`` bits + O(n) words:

* ``bits``        int32[NB, F_B/32] — one bit per edge slot (1 = active),
  little-endian within each word; int32 is a bit-view of the uint32 words
  of the JAX package, so ``(w >> s) & 1`` reads the same bits
* ``active_deg``  int32[n]          — live degree per vertex
* ``block_live``  derived           — block has ≥1 active edge (the paper's
  empty-block compaction: ``live_block_indices`` lists the live blocks)
* ``dirty``       bool[n]           — vertices whose edges changed this round

``pack_vertices`` (edgeMapPack) clears bits through the ``filter_pack``
kernel on CUDA tensors (its plain version on the CPU): the edge data that
its predicate read is never written.

The filter composes with either backend (``CSRGraph`` or ``CompressedCSR``):
the block size is the compression block size (§4.2.1), so the bits line up
1:1 with decoded compressed blocks.
"""
from __future__ import annotations

import dataclasses

import torch

from ..tuning.defaults import DEFAULT_DENSE_RANGE_BLOCKS
from .backend import dense_block_view
from .csr import block_rows, sharded_block_counts
from .primitives import compact_mask, segment_reduce

WORD = 32


@dataclasses.dataclass(frozen=True)
class GraphFilter:
    bits: torch.Tensor        # int32[NB, F_B//32]
    active_deg: torch.Tensor  # int32[n]
    dirty: torch.Tensor       # bool[n]
    n: int
    num_blocks: int
    block_size: int

    @property
    def num_active_edges(self) -> torch.Tensor:
        return self.active_deg.sum()

    @property
    def block_live(self) -> torch.Tensor:
        return (self.bits != 0).any(dim=-1)

    def shard(self, num_shards: int) -> list["GraphFilter"]:
        """Partition the filter words alongside the edge blocks: the same
        ``ceil(NB / num_shards)`` block-range split as ``CSRGraph.shard``,
        the padded tail rows all zero (padding blocks carry no active edge).
        ``active_deg`` and ``dirty`` stay replicated, like the graph's
        ``degrees``, so shard s's words line up 1:1 with graph shard s."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        per, _ = sharded_block_counts(self.num_blocks, num_shards)
        return [
            dataclasses.replace(self, bits=block_rows(self.bits, s * per, (s + 1) * per, 0),
                                num_blocks=per)
            for s in range(num_shards)
        ]


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def unpack_word_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32[..., W] → bool[..., W*32], little-endian within each word.

    The canonical bit order for every graphFilter consumer (edgeMap, the
    kernels and their plain versions) — change it here and in ``pack_bits``
    together."""
    opened = ((bits.to(torch.int32)[..., :, None] >> _shifts(bits.device)) & 1).bool()
    return opened.reshape(bits.shape[:-1] + (bits.shape[-1] * WORD,))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[NB, F_B] → int32[NB, F_B//32] (bit-view of the uint32 words)."""
    nb, fb = mask.shape
    m3 = mask.reshape(nb, fb // WORD, WORD).to(torch.int64)
    words = (m3 << _shifts(mask.device).to(torch.int64)).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def make_filter(g) -> GraphFilter:
    """makeFilter (§4.2.2): all real edges start active."""
    mask = g.edge_valid.reshape(g.num_blocks, g.block_size)
    return GraphFilter(
        bits=pack_bits(mask),
        active_deg=g.degrees,
        dirty=torch.zeros(g.n, dtype=torch.bool, device=g.degrees.device),
        n=g.n,
        num_blocks=g.num_blocks,
        block_size=g.block_size,
    )


def edge_active_words(edge_active, block_size: int) -> torch.Tensor:
    """Normalize any edge-activity form to packed int32[NB, F_B/32] words.

    Accepts a ``GraphFilter`` (its ``bits``), packed int32 (NB, F_B/32)
    words (passed through), or a bool edge-slot mask, flat [NB*F_B] or
    [NB, F_B] (packed here)."""
    if isinstance(edge_active, GraphFilter):
        return edge_active.bits
    a = edge_active
    if a.dtype == torch.int32:
        if a.dim() != 2 or a.shape[-1] != block_size // WORD:
            raise ValueError(
                f"packed edge_active must be (NB, {block_size // WORD}) int32, "
                f"got {tuple(a.shape)}"
            )
        return a
    if a.dtype == torch.bool:
        return pack_bits(a.reshape(-1, block_size))
    raise TypeError(
        f"edge_active must be a GraphFilter, packed int32 words, or a bool "
        f"slot mask, got dtype {a.dtype}"
    )


def unpack_bits(f: GraphFilter) -> torch.Tensor:
    """bool[NB, F_B] active-edge mask (the dense working view)."""
    return unpack_word_bits(f.bits)


def edge_active_flat(f: GraphFilter) -> torch.Tensor:
    """bool[NB*F_B] — flat edge-slot activity mask."""
    return unpack_bits(f).reshape(-1)


def _recount(g, per_block: torch.Tensor) -> torch.Tensor:
    """active_deg from the per-block popcounts (the ``filter_pack`` kernel's
    counts) via a segment-sum by block owner (PackVertex)."""
    return segment_reduce(per_block, g.block_src, g.n + 1, "sum")[: g.n]


def _deleted_targets(g, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """bool[n]: targets of the slots set in ``old`` words and clear in
    ``new``, found one range of blocks at a time (a compressed graph is
    decoded range by range, exceptions patched)."""
    n = g.n
    hit = torch.zeros(n + 1, dtype=torch.bool, device=old.device)
    R = DEFAULT_DENSE_RANGE_BLOCKS
    for lo in range(0, g.num_blocks, R):
        hi = min(lo + R, g.num_blocks)
        deleted = unpack_word_bits(old[lo:hi] & ~new[lo:hi])
        ids = torch.where(deleted, dense_block_view(g, lo, hi)[0], n).reshape(-1)
        hit.index_fill_(0, ids.long(), True)
    return hit[:n]


def pack_vertices(g, f: GraphFilter, subset_mask: torch.Tensor,
                  keep_pred: torch.Tensor) -> GraphFilter:
    """edgeMapPack (§4.2.2): for vertices in ``subset_mask``, clear bits of
    edges failing ``keep_pred`` (bool[NB*F_B] or bool[NB, F_B]).

    The new words and per-block counts come from the ``filter_pack`` op
    (its kernel on CUDA tensors, the plain version on CPU tensors); this
    adds the dirty tracking: destination vertices of deleted edges."""
    from ..kernels.filter_pack import filter_pack

    new = filter_pack(g, f, subset_mask, keep_pred)
    return dataclasses.replace(new, dirty=f.dirty | _deleted_targets(g, f.bits, new.bits))


def filter_edges(g, f: GraphFilter, keep_pred: torch.Tensor):
    """filterEdges (§4.2): pack every vertex; returns (filter', remaining)."""
    all_v = torch.ones(g.n, dtype=torch.bool, device=f.bits.device)
    f2 = pack_vertices(g, f, all_v, keep_pred)
    return f2, f2.num_active_edges


def filter_edges_pred(g, f: GraphFilter, pred_fn):
    """Convenience: ``pred_fn(src, dst, w) -> keep?`` evaluated on all slots."""
    return filter_edges(g, f, pred_fn(g.edge_src, g.edge_dst, g.edge_w))


def live_block_indices(f: GraphFilter):
    """Compacted indices of non-empty blocks (the paper's block compaction,
    as an O(n)-word index list instead of a physical move): (idx int64[NB]
    padded with NB, count as a Python int)."""
    return compact_mask(f.block_live, fill=f.num_blocks)
