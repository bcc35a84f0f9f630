"""Blocked, read-only CSR graph structure — the PSAM "large memory".

The graph is built once on the host (numpy), moved to its device, and never
written afterwards.  Edges are laid out in fixed-size *blocks* of ``F_B``
slots (the paper's filter block size, §4.2.1); every block belongs to exactly
one source vertex, and a vertex with degree d owns ``ceil(d / F_B)`` blocks.
Padding slots carry the sentinel target ``n`` so that gathers and
segment-reductions can route them to a dead row.

Two views of the same storage: the flat ``edge_src/edge_dst/edge_w`` of
length ``NB * F_B`` and the block view ``block_src[NB]`` plus the flat
arrays reshaped ``(NB, F_B)``.  All mutable per-vertex state is ``O(n)``
words (the PSAM "small memory").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_BLOCK_SIZE = 128  # slots; multiple of 32 so the filter bitset packs into words


def sharded_block_counts(num_blocks: int, num_shards: int) -> tuple[int, int]:
    """(blocks per shard, total blocks incl. padding) for a block-range split.

    Non-dividing counts round *up*: the tail shard pads with empty sentinel
    blocks, it is never truncated."""
    per = -(-num_blocks // max(num_shards, 1))
    return per, per * num_shards


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable blocked-CSR graph (PSAM large memory)."""

    offsets: torch.Tensor        # int32[n+1]   — into flat edge slots (block-padded)
    block_offsets: torch.Tensor  # int32[n+1]   — into blocks
    block_src: torch.Tensor      # int32[NB]    — owner vertex of each block
    edge_src: torch.Tensor       # int32[NB*F_B] (sentinel n on padding)
    edge_dst: torch.Tensor       # int32[NB*F_B] (sentinel n on padding)
    edge_w: torch.Tensor         # float32[NB*F_B]
    degrees: torch.Tensor        # int32[n]     — true degrees
    n: int
    m: int                       # true (unpadded) number of directed edge slots
    num_blocks: int
    block_size: int
    weighted: bool

    @property
    def device(self) -> torch.device:
        return self.block_src.device

    @property
    def block_dst(self) -> torch.Tensor:
        return self.edge_dst.view(self.num_blocks, self.block_size)

    @property
    def block_w(self) -> torch.Tensor:
        return self.edge_w.view(self.num_blocks, self.block_size)

    @property
    def edge_valid(self) -> torch.Tensor:
        """bool[NB*F_B] — True on real (non-padding) edge slots."""
        return self.edge_dst < self.n

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    def out_degree(self, v):
        return self.degrees[v]

    def shard(self, num_shards: int) -> list["CSRGraph"]:
        """Partition the block set into ``num_shards`` contiguous ranges of
        ``ceil(NB / num_shards)`` blocks, on the graph's device.

        A non-dividing block count pads the tail with *empty* blocks (owner
        = sentinel n, all targets n, zero weights), so every shard carries
        the same block count and none is truncated.  Each shard keeps the
        O(n) vertex arrays (``offsets``, ``block_offsets``, ``degrees``) and
        the global ``n`` and ``m``: it is itself a valid backend over the
        global vertex space.  Rows inside the graph are views of its arrays
        (no copy); only a shard that reaches the padding is a new tensor.
        """
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        NB, FB, n = self.num_blocks, self.block_size, self.n
        per, _ = sharded_block_counts(NB, num_shards)
        rows = {
            "block_src": (self.block_src, n),
            "edge_src": (self.edge_src.view(NB, FB), n),
            "edge_dst": (self.edge_dst.view(NB, FB), n),
            "edge_w": (self.edge_w.view(NB, FB), 0.0),
        }
        shards = []
        for s in range(num_shards):
            lo, hi = s * per, (s + 1) * per
            parts = {k: block_rows(a, lo, hi, fill).reshape(-1) for k, (a, fill) in rows.items()}
            shards.append(dataclasses.replace(self, **parts, num_blocks=per))
        return shards


def block_rows(a: torch.Tensor, lo: int, hi: int, fill) -> torch.Tensor:
    """Rows ``lo..hi-1`` of the per-block array ``a`` (NB leading rows), the
    rows past NB filled with ``fill``: a view when none is past NB."""
    NB = a.shape[0]
    if hi <= NB:
        return a[lo:hi]
    pad = torch.full((hi - max(lo, NB),) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a[min(lo, NB):NB], pad])


def csr_host_arrays(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray | None = None,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    symmetrize: bool = False,
) -> tuple[dict[str, np.ndarray], dict]:
    """The blocked-CSR arrays and metadata, computed with numpy on the host.

    ``src``/``dst`` are directed edge endpoints.  With ``symmetrize=True`` the
    reverse edges are added (and exact duplicates removed), matching the
    paper's symmetrized inputs.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if w is None:
        weighted = False
        w = np.ones_like(src, dtype=np.float32)
    else:
        weighted = True
        w = np.asarray(w, dtype=np.float32)

    if symmetrize:
        src, dst, w = (
            np.concatenate([src, dst]),
            np.concatenate([dst, src]),
            np.concatenate([w, w]),
        )
    # drop self loops, dedupe
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst, w = src[uniq], dst[uniq], w[uniq]

    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    m = int(src.shape[0])

    deg = np.bincount(src, minlength=n).astype(np.int64)
    nblk = np.maximum((deg + block_size - 1) // block_size, 0)
    block_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nblk, out=block_offsets[1:])
    num_blocks = max(int(block_offsets[-1]), 1)  # keep shapes non-degenerate
    if int(block_offsets[-1]) == 0:
        block_offsets[-1] = 1  # single dummy block owned by sentinel

    slots = num_blocks * block_size
    edge_src = np.full(slots, n, dtype=np.int32)
    edge_dst = np.full(slots, n, dtype=np.int32)
    edge_w = np.zeros(slots, dtype=np.float32)

    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nblk * block_size, out=offsets[1:])
    # scatter edges into their padded slots
    starts = offsets[src]
    within = np.zeros(m, dtype=np.int64)
    if m:
        # position of each edge within its vertex's run (src-sorted)
        first_of_run = np.concatenate([[True], src[1:] != src[:-1]])
        run_ids = np.cumsum(first_of_run) - 1
        run_starts = np.flatnonzero(first_of_run)
        within = np.arange(m) - run_starts[run_ids]
    pos = starts + within
    edge_src[pos] = src.astype(np.int32)
    edge_dst[pos] = dst.astype(np.int32)
    edge_w[pos] = w

    block_src = np.full(num_blocks, n, dtype=np.int32)
    for_v = np.repeat(np.arange(n, dtype=np.int32), nblk)
    block_src[: for_v.shape[0]] = for_v

    arrays = {
        "offsets": offsets.astype(np.int32),
        "block_offsets": block_offsets.astype(np.int32),
        "block_src": block_src,
        "edge_src": edge_src,
        "edge_dst": edge_dst,
        "edge_w": edge_w,
        "degrees": deg.astype(np.int32),
    }
    meta = {
        "n": int(n),
        "m": m,
        "num_blocks": num_blocks,
        "block_size": int(block_size),
        "weighted": weighted,
    }
    return arrays, meta


def build_csr(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray | None = None,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    symmetrize: bool = False,
    device=None,
) -> CSRGraph:
    """Build a blocked CSR graph on the host and place it on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    arrays, meta = csr_host_arrays(
        n, src, dst, w, block_size=block_size, symmetrize=symmetrize
    )
    return CSRGraph(
        **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}, **meta
    )


def graph_spec(n: int, num_blocks: int, block_size: int, weighted: bool = False) -> CSRGraph:
    """A stand-in ``CSRGraph`` for shape and dtype planning: every tensor lives
    on the ``meta`` device, with the shapes and dtypes of a real graph of
    this size, and no memory is allocated."""
    meta = torch.device("meta")
    slots = num_blocks * block_size

    def spec(size, dtype):
        return torch.empty(size, dtype=dtype, device=meta)

    return CSRGraph(
        offsets=spec((n + 1,), torch.int32),
        block_offsets=spec((n + 1,), torch.int32),
        block_src=spec((num_blocks,), torch.int32),
        edge_src=spec((slots,), torch.int32),
        edge_dst=spec((slots,), torch.int32),
        edge_w=spec((slots,), torch.float32),
        degrees=spec((n,), torch.int32),
        n=n,
        m=slots,
        num_blocks=num_blocks,
        block_size=block_size,
        weighted=weighted,
    )
