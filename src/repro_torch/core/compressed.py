"""Compressed blocked CSR — the Ligra+ byte-code format (§5.1.3) as
fixed-width delta packing.

Per block: the first target (int32) and 16-bit deltas between consecutive
sorted targets; the rare deltas ≥ 2¹⁶ go to a COO exception list and leave
the ``ESCAPE`` code in their slot.  Decoding a block is a cumsum over its
slots — the "decode the whole block to fetch one edge" discipline of the
paper's filter iterator (App. D.1) — and the graphFilter bits apply
unchanged on top of the decoded block.

The deltas stay 2 bytes per slot on the device, stored as an int16 bit-view
of the uint16 codes (the CUDA kernel reads them as ``uint16_t``); decoders
widen one tile at a time with ``.to(torch.int32) & 0xFFFF``, never the whole
graph.  ``valid_count`` is stored the same way.  Weights (when present) do
not delta-compress and are carried uncompressed.
"""
from __future__ import annotations

import dataclasses

import torch

from .csr import CSRGraph, block_rows, sharded_block_counts
from .primitives import take_fill

ESCAPE = 0xFFFF


@dataclasses.dataclass(frozen=True)
class CompressedCSR:
    """Read-only difference-encoded blocked CSR (PSAM large memory)."""

    block_first: torch.Tensor  # int32[NB]       — first target per block
    deltas: torch.Tensor       # int16[NB, FB]   — uint16 codes; deltas[:, 0] = 0
    valid_count: torch.Tensor  # int16[NB]       — real (front-packed) slots
    exc_block: torch.Tensor    # int32[NE]       — exception coordinates
    exc_slot: torch.Tensor     # int32[NE]
    exc_value: torch.Tensor    # int32[NE]       — true delta value
    block_src: torch.Tensor    # int32[NB]
    degrees: torch.Tensor      # int32[n]
    n: int
    m: int
    num_blocks: int
    block_size: int
    n_exceptions: int
    block_weights: torch.Tensor | None = None  # float32[NB, FB] when weighted
    weighted: bool = False
    # the whole-graph exception-density verdict carried by a shard
    exception_dense_hint: bool | None = None

    @property
    def device(self) -> torch.device:
        return self.block_src.device

    @property
    def compressed_bytes(self) -> int:
        return int(
            self.block_first.numel() * 4
            + self.deltas.numel() * 2
            + self.valid_count.numel() * 2
            + self.n_exceptions * 12
        )

    @property
    def uncompressed_bytes(self) -> int:
        return int(self.deltas.numel() * 4)

    @property
    def compression_ratio(self) -> float:
        return self.uncompressed_bytes / max(self.compressed_bytes, 1)

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    def out_degree(self, v):
        return self.degrees[v]

    @property
    def block_dst(self) -> torch.Tensor:
        """Decoded int32[NB, FB] targets (sentinel n on padding slots)."""
        return decode_blocks(self)

    @property
    def block_w(self) -> torch.Tensor:
        if self.block_weights is not None:
            return self.block_weights
        return torch.ones(
            (self.num_blocks, self.block_size), dtype=torch.float32, device=self.device
        )

    @property
    def edge_dst(self) -> torch.Tensor:
        return decode_blocks(self).reshape(-1)

    @property
    def edge_src(self) -> torch.Tensor:
        """int32[NB*F_B] — owner per slot, sentinel n on padding."""
        src = self.block_src[:, None].expand(self.num_blocks, self.block_size).reshape(-1)
        return torch.where(self.edge_valid, src, self.n)

    @property
    def edge_w(self) -> torch.Tensor:
        return self.block_w.reshape(-1)

    @property
    def edge_valid(self) -> torch.Tensor:
        """bool[NB*F_B] — real slots, read off ``valid_count`` (no decode)."""
        lane = torch.arange(self.block_size, device=self.device)
        return (lane[None, :] < _widen(self.valid_count)[:, None]).reshape(-1)

    def shard(self, num_shards: int) -> list["CompressedCSR"]:
        """Partition the compressed block set into ``num_shards`` contiguous
        ranges of ``ceil(NB / num_shards)`` blocks, on the graph's device.

        Compressed blocks decode independently, so a shard is a block-range
        split of the delta stream plus its own exception list: each
        exception goes to the shard that owns its block, its block id
        rebased to that shard's range.  The lists are padded to the longest
        across shards with rows of block id ``per`` (outside every shard),
        which every decoder drops.  A non-dividing block count pads the tail
        with empty blocks (valid count 0, owner n).  ``degrees``, ``n`` and
        ``m`` stay global, and every shard carries the whole graph's
        ``exception_dense`` verdict.  Rows inside the graph are views.
        """
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        NB, n = self.num_blocks, self.n
        per, _ = sharded_block_counts(NB, num_shards)
        rows = {
            "block_first": (self.block_first, 0),
            "deltas": (self.deltas, 0),
            "valid_count": (self.valid_count, 0),
            "block_src": (self.block_src, n),
        }
        if self.block_weights is not None:
            rows["block_weights"] = (self.block_weights, 0.0)
        eb = self.exc_block.long()
        owner = torch.div(eb, per, rounding_mode="floor")
        counts = torch.bincount(owner, minlength=num_shards) if eb.numel() else None
        ne_max = 0 if counts is None else int(counts.max())
        hint = exception_dense(self)
        shards = []
        for s in range(num_shards):
            lo, hi = s * per, (s + 1) * per
            parts = {k: block_rows(a, lo, hi, fill) for k, (a, fill) in rows.items()}
            sel = owner == s
            k = int(counts[s]) if counts is not None else 0
            exc = []
            for arr, fill, shift in ((self.exc_block, per, lo), (self.exc_slot, 0, 0),
                                     (self.exc_value, 0, 0)):
                out = torch.full((ne_max,), fill, dtype=torch.int32, device=self.device)
                out[:k] = arr[sel] - shift
                exc.append(out)
            shards.append(dataclasses.replace(
                self, **parts, exc_block=exc[0], exc_slot=exc[1], exc_value=exc[2],
                num_blocks=per, n_exceptions=ne_max, exception_dense_hint=hint,
            ))
        return shards


def _widen(codes: torch.Tensor) -> torch.Tensor:
    """uint16 codes held as an int16 bit-view → int32 values 0..65535."""
    return codes.to(torch.int32) & 0xFFFF


def _to_codes(values: torch.Tensor) -> torch.Tensor:
    """int values 0..65535 → their int16 bit-view."""
    return torch.where(values >= 2**15, values - 2**16, values).to(torch.int16)


def compress(g: CSRGraph) -> CompressedCSR:
    """Encoder (runs once at load, like the paper's preprocessing), on the
    graph's device.

    Padding slots (sentinel n in the CSR) are encoded as *repeats of the
    last real target* — delta 0 — and validity is carried structurally as a
    per-block count (slots are front-packed by build_csr), so the exception
    list stays tied to true ≥2¹⁶ adjacency gaps.  Weighted graphs keep their
    weights uncompressed alongside the delta-packed targets.
    """
    NB, FB = g.num_blocks, g.block_size
    dev = g.device
    dst = g.edge_dst.view(NB, FB).to(torch.int64)
    vc = (dst < g.n).sum(dim=1)  # front-packed real slots
    rows = torch.arange(NB, device=dev)
    last = torch.where(vc > 0, dst[rows, (vc - 1).clamp(min=0)], 0)
    lane = torch.arange(FB, device=dev)[None, :]
    dst_enc = torch.where(lane < vc[:, None], dst, last[:, None])
    del dst
    first = dst_enc[:, 0].to(torch.int32)
    raw = torch.zeros_like(dst_enc)
    raw[:, 1:] = dst_enc[:, 1:] - dst_enc[:, :-1]
    del dst_enc
    over = (raw >= ESCAPE) | (raw < 0)
    deltas = _to_codes(torch.where(over, ESCAPE, raw))
    eb, es = torch.nonzero(over, as_tuple=True)
    exc_value = raw[eb, es].to(torch.int32)
    return CompressedCSR(
        block_first=first,
        deltas=deltas,
        valid_count=_to_codes(vc),
        exc_block=eb.to(torch.int32),
        exc_slot=es.to(torch.int32),
        exc_value=exc_value,
        block_src=g.block_src,
        degrees=g.degrees,
        n=g.n,
        m=g.m,
        num_blocks=NB,
        block_size=FB,
        n_exceptions=int(eb.shape[0]),
        block_weights=g.block_w if g.weighted else None,
        weighted=g.weighted,
    )


def _cumsum_decode(c: CompressedCSR, d, first, vc) -> torch.Tensor:
    """Patched int32 deltas (C, FB) → targets, sentinel n past valid_count."""
    d[:, 0] = 0
    raw = first[:, None] + torch.cumsum(d, dim=1, dtype=torch.int32)
    lane = torch.arange(c.block_size, device=d.device)
    return torch.where(lane[None, :] < vc[:, None], raw, c.n)


def _patch_exceptions(c: CompressedCSR, d: torch.Tensor, rows: torch.Tensor):
    """Write each exception's true delta into row ``rows[e]`` of ``d``; rows
    equal to ``len(d)`` are dropped (the exception's block is not in ``d``)."""
    C = d.shape[0]
    ext = torch.cat([d, d.new_zeros(1, d.shape[1])])
    ext.index_put_((rows, c.exc_slot.long()), c.exc_value)
    return ext[:C]


def decode_block_range(c: CompressedCSR, lo: int, hi: int) -> torch.Tensor:
    """Decode blocks ``lo..hi-1`` → int32[hi-lo, FB], exceptions patched.

    The dense pass walks the graph in such ranges, so no more than one
    range of targets is ever held at int32 width."""
    d = _widen(c.deltas[lo:hi])
    if c.n_exceptions:
        rows = c.exc_block.long() - lo
        rows = torch.where((rows >= 0) & (rows < hi - lo), rows, hi - lo)
        d = _patch_exceptions(c, d, rows)
    return _cumsum_decode(c, d, c.block_first[lo:hi], _widen(c.valid_count[lo:hi]))


def decode_blocks(c: CompressedCSR) -> torch.Tensor:
    """Decode ALL blocks → int32[NB, FB], bit-identical to the CSR's
    ``block_dst`` (padding slots come back as the sentinel n)."""
    return decode_block_range(c, 0, c.num_blocks)


def rows_for_ids(ids: torch.Tensor, blocks: torch.Tensor, num_blocks: int):
    """For each entry of ``blocks``, the row of ``ids`` holding that block,
    or ``len(ids)`` when no row does (the caller drops those).

    ``ids`` rows are unique real block ids plus out-of-range pad.  The
    lookup goes through an O(NB) block → row map, so it costs O(NB + len)
    instead of the O(len(ids) · len(blocks)) compare of a match matrix."""
    C = ids.shape[0]
    ids = ids.long()
    rowmap = torch.full((num_blocks + 1,), C, dtype=torch.int64, device=ids.device)
    oob = (ids < 0) | (ids >= num_blocks)
    rowmap[torch.where(oob, num_blocks, ids)] = torch.arange(C, device=ids.device)
    rowmap[num_blocks] = C
    blocks = blocks.long()
    inr = (blocks >= 0) & (blocks < num_blocks)
    return rowmap[torch.where(inr, blocks, num_blocks)]


def decode_block_tile(c: CompressedCSR, bids: torch.Tensor) -> torch.Tensor:
    """Decode a tile of blocks → int32[C, FB] (the chunk-loop path, §4.1).

    Ids out of range (the chunk fill ``num_blocks``) decode to all-sentinel
    rows.  Real ids must be unique (chunk tiles are compacted indices).
    Exceptions route to their tile row through ``rows_for_ids``, so the
    patch costs O(NB + NE) per tile, whatever the exception density.
    """
    bids = bids.long()
    d = _widen(take_fill(c.deltas, bids, 0))
    if c.n_exceptions:
        d = _patch_exceptions(c, d, rows_for_ids(bids, c.exc_block, c.num_blocks))
    first = take_fill(c.block_first, bids, c.n)
    vc = _widen(take_fill(c.valid_count, bids, 0))
    return _cumsum_decode(c, d, first, vc)


def decode_block(c: CompressedCSR, bid: int) -> torch.Tensor:
    """Decode a single block (the filter-iterator path, App. D.1)."""
    return decode_block_tile(c, torch.tensor([bid], device=c.device))[0]


def exception_dense(c: CompressedCSR) -> bool:
    """Metadata-only test: is the exception list too dense for the per-tile
    COO patch of the streamed kernel to stay a rare path?"""
    if c.exception_dense_hint is not None:
        return c.exception_dense_hint
    return c.n_exceptions > max(16, min(c.num_blocks // 4, 4096))


def edgemap_sum_compressed(c: CompressedCSR, x: torch.Tensor, *, edge_active=None):
    """``out[v] = Σ x[u]`` over the decoded active edges (v, u): a
    PageRank-style aggregation straight off the compressed representation,
    with optional graphFilter bits (``edge_active``: a ``GraphFilter``,
    packed int32 words or a bool slot mask).  Unweighted, even on a weighted
    graph.  On the card it is one launch of the block SpMV kernel
    (``compressed_block_spmv``), the exception blocks patched exactly; the
    CPU runs its plain version.  The sums are float32 whatever ``x``'s dtype:
    an integer ``x`` is promoted first, as the reference package sums it."""
    # lazy import: kernels depend on core, never the other way around
    from ..kernels.compressed_spmv.ops import compressed_spmv_vertex

    if not x.is_floating_point():
        x = x.to(torch.float32)
    return compressed_spmv_vertex(c, x, edge_active=edge_active, weighted=False)
