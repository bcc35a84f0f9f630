"""Parallel primitives (§2 of the paper): scan, compact, reduce-by-key,
histogram, identities, and the bit tricks over packed words.

These operate on the PSAM *small memory*: every output here is O(n) words.
Packed words are int32 bit-views of the JAX package's uint32 words.
"""
from __future__ import annotations

import numpy as np
import torch

INF_I32 = 2**31 - 1

_NP_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.bool: np.bool_,
}


def exclusive_scan(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix sum in ``x``'s dtype: returns (exclusive prefix sums, total)."""
    inc = torch.cumsum(x, dim=0, dtype=x.dtype)
    total = inc[-1] if x.shape[0] else torch.zeros((), dtype=x.dtype, device=x.device)
    return inc - x, total


def compact_mask(mask: torch.Tensor, *, fill: int | None = None):
    """Filter primitive: indices where ``mask`` is True, front-packed.

    Returns (idx int64[len(mask)] padded with ``fill`` (default len(mask)),
    count as a Python int).  Reading the count is one host sync.
    """
    size = mask.shape[0]
    fill = size if fill is None else fill
    hit = torch.nonzero(mask).reshape(-1)
    k = int(hit.shape[0])
    idx = torch.full((size,), fill, dtype=torch.int64, device=mask.device)
    idx[:k] = hit
    return idx, k


def take_fill(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr[idx]`` along dim 0, with ``fill`` wherever idx is out of range."""
    L = arr.shape[0]
    idx = idx.long()
    oob = (idx < 0) | (idx >= L)
    rows = arr[torch.where(oob, 0, idx)] if L else arr.new_empty(idx.shape + arr.shape[1:])
    sel = oob.reshape(oob.shape + (1,) * (rows.dim() - oob.dim()))
    # a Python scalar, not a device tensor: building one would be a blocking copy
    return torch.where(sel, fill, rows)


def monoid_identity(monoid: str, dtype: torch.dtype):
    """Identity element as a host numpy scalar of the matching dtype."""
    np_dtype = np.dtype(_NP_DTYPES[dtype])
    if monoid == "sum":
        return np_dtype.type(0)
    if monoid == "min":
        if np.issubdtype(np_dtype, np.integer):
            return np_dtype.type(np.iinfo(np_dtype).max)
        return np_dtype.type(np.inf)
    if monoid == "max":
        if np.issubdtype(np_dtype, np.integer):
            return np_dtype.type(np.iinfo(np_dtype).min)
        return np_dtype.type(-np.inf)
    if monoid == "or":
        return np.bool_(False)
    raise ValueError(monoid)


def segment_reduce(vals: torch.Tensor, ids: torch.Tensor, num_segments: int, monoid: str):
    """Reduce-by-key with a named monoid; ids == num_segments-1 may be a
    sentinel row (the caller drops it).  Every segment starts from the
    monoid identity, so empty segments hold the identity, as in JAX."""
    ids = ids.long()
    shape = (num_segments,) + tuple(vals.shape[1:])
    if monoid == "or":
        hits = torch.zeros(shape, dtype=torch.int32, device=vals.device)
        return hits.index_add_(0, ids, vals.to(torch.int32)) > 0
    if monoid == "sum":
        return torch.zeros(shape, dtype=vals.dtype, device=vals.device).index_add_(
            0, ids, vals
        )
    if monoid in ("min", "max"):
        ident = monoid_identity(monoid, vals.dtype)
        out = torch.full(shape, ident.item(), dtype=vals.dtype, device=vals.device)
        index = ids.reshape((-1,) + (1,) * (vals.dim() - 1)).expand(vals.shape)
        return out.scatter_reduce_(
            0, index, vals, reduce="amin" if monoid == "min" else "amax",
            include_self=True,
        )
    raise ValueError(f"unknown monoid {monoid}")


def histogram(ids: torch.Tensor, num_bins: int, weights=None) -> torch.Tensor:
    """Dense histogram (the paper's §4.3.4 dense-histogram routine): the sum
    of ``weights`` (int32 ones by default) per bin; ids outside
    [0, num_bins) are dropped, as JAX's ``segment_sum`` drops them."""
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < num_bins), ids, num_bins)
    return segment_reduce(weights, ids, num_bins + 1, "sum")[:num_bins]


def lowest_set_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of each 32-bit word (0 where x == 0), int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    iso = x & ((~x + 1) & 0xFFFFFFFF)    # isolate the lowest bit
    # log2 of a power of two via popcount(iso - 1)
    return popcount32(iso - (iso != 0).to(torch.int64))


def mex_from_forbidden(words: torch.Tensor) -> torch.Tensor:
    """Minimum excludant: the smallest bit index not set, over 32-bit words
    ``(..., W)`` (little-endian bit blocks); 32·W when every bit is set.
    Returns int32[...]."""
    W = words.shape[-1]
    free = ~words.to(torch.int64) & 0xFFFFFFFF   # a set bit is an available color
    has_free = free != 0
    low = lowest_set_bit(free)
    first_word = torch.argmax(has_free.to(torch.int32), dim=-1)
    picked = torch.gather(low, -1, first_word[..., None])[..., 0]
    mex = first_word.to(torch.int32) * 32 + picked
    return torch.where(has_free.any(dim=-1), mex, 32 * W).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit-views), as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
