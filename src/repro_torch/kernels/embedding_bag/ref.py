"""Plain PyTorch version of the EmbeddingBag kernel.

``embedding_bag_ref`` has the signature of the kernel wrapper
(``embedding_bag.embedding_bag_sums``) and of the JAX package's oracle, and
computes the same function with ordinary tensor ops: the CPU route runs
it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

It repeats the kernel's arithmetic: the weights are rounded to the table's
dtype, each slot's product and the running sum are float32, added slot by
slot in order, and the sum is rounded once to the table's dtype.

``embedding_bag_backward_ref`` is the plain version of the backward kernel
(kernel 5'): the gradient of the bag sums with respect to a float32 table,
each row's contributions summed in the association the kernel uses
(``backward_plan``, ``BACKWARD_CHUNK``), so the card holds the kernel to it
bit for bit.  It is ``backward_plan`` (the plain version of the kernel's
preparation) and then ``backward_sums_ref`` (of its sums, given the plan).

``bag_case``, ``bag_of_one_case``, ``bag_grad_case``, ``bf16_ulps`` and
``same_bits`` are what the card tests and ``chip_smoke.py`` share to hold
the kernels to these versions: the inputs, with padding and out-of-range
ids (and a -0.0, or a hot row) planted, the bfloat16 distance and
bit-for-bit equality.
"""
from __future__ import annotations

import numpy as np
import torch


def embedding_bag_ref(table, indices, weights=None):
    """``table`` (V, D), ``indices`` (B, L) integer ids, ``weights`` (B, L)
    or None (every weight 1) → (B, D) weighted bag sums in ``table.dtype``.

    A slot is valid when ``0 <= id < V``; any other id is padding and adds
    exactly 0: neither its row nor its weight reaches the sum (a NaN weight
    on a padding slot leaves the sum finite)."""
    V, D = table.shape
    B, L = indices.shape
    valid = (indices >= 0) & (indices < V)
    safe = torch.where(valid, indices, 0).long()
    w = None if weights is None else weights.to(table.dtype).float()
    acc = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    for s in range(L):
        term = table[safe[:, s]].float()
        if w is not None:
            term = term * w[:, s, None]
        acc = acc + torch.where(valid[:, s, None], term, 0.0)
    return acc.to(table.dtype)


BACKWARD_CHUNK = 1024  # contributions a partial sum of the backward takes, in order


def backward_plan(indices, V: int, chunk: int = BACKWARD_CHUNK):
    """The grouping the backward sums by, shared by the kernel and the plain
    version: ``(order, row_start, chunk_base)``, int32 on ``indices``' device.

    ``order`` lists the flat slots ``b * L + s`` stably sorted by id, the
    padding slots (ids outside ``[0, V)``) last; row ``v``'s slots are
    ``order[row_start[v]:row_start[v + 1]]``, in slot order.  A row of more
    than ``chunk`` slots is cut into chunks of ``chunk`` from its first slot,
    and its chunks are numbered ``chunk_base[v] .. chunk_base[v + 1] - 1``;
    a row of at most ``chunk`` slots has none (``chunk_base`` is the
    exclusive prefix sum of the chunk counts, ``chunk_base[V]`` the total).
    The slots are numbered in int32: ``B * L >= 2**31`` raises ``ValueError``."""
    if indices.numel() >= 2 ** 31:
        raise ValueError(f"the EmbeddingBag backward numbers its slots in int32: "
                         f"{indices.numel()} slots is too many")
    flat = indices.reshape(-1)
    key = torch.where((flat >= 0) & (flat < V), flat, V).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(V + 1, dtype=torch.int32, device=flat.device)
    row_start = torch.searchsorted(sorted_key, bounds, out_int32=True)
    count = row_start[1:] - row_start[:-1]
    chunks = torch.where(count > chunk, (count + chunk - 1) // chunk, 0)
    chunk_base = torch.zeros(V + 1, dtype=torch.int32, device=flat.device)
    chunk_base[1:] = torch.cumsum(chunks, 0, dtype=torch.int32)
    return order.to(torch.int32), row_start, chunk_base


def _prefix_sizes(sizes: torch.Tensor) -> list[int]:
    """For ``k = 0, 1, ...``: how many of ``sizes`` exceed ``k`` (host ints)."""
    if sizes.numel() == 0:
        return []
    hist = torch.bincount(sizes.long().cpu())
    return (sizes.numel() - torch.cumsum(hist, 0))[:-1].tolist()


def embedding_bag_backward_ref(grad_out, indices, V: int, weights=None, *,
                               chunk: int = BACKWARD_CHUNK):
    """The gradient of ``embedding_bag_ref(table, indices, weights)`` with
    respect to a (V, D) float32 table, given ``grad_out`` (B, D): row ``v``
    is the sum of ``w[b, s] * grad_out[b]`` over the slots with id ``v``
    (``w`` 1 without weights), in float32; padding and out-of-range ids add
    nothing, untouched rows are exact zeros.

    The association is the backward kernel's: a row's contributions are
    added in slot order, from 0, in chunks of ``chunk`` (``backward_plan``);
    the row is the sum of its chunks' partial sums, in order, from 0.  A row
    of at most ``chunk`` slots is one chunk, so its sum is the plain slot
    order's (0 + a partial sum is that sum: a sum that starts at +0.0 is
    never -0.0)."""
    order, row_start, _ = backward_plan(indices, V, chunk)
    return backward_sums_ref(grad_out, order, row_start, indices.shape[1], weights, chunk=chunk)


def backward_sums_ref(grad_out, order, row_start, L: int, weights=None, *,
                      chunk: int = BACKWARD_CHUNK):
    """The sums of ``embedding_bag_backward_ref`` given its grouping
    (``order``, ``row_start`` of ``backward_plan`` for a (B, L) lookup of a
    table of ``row_start.numel() - 1`` rows): (V, D) float32, in the
    association documented there."""
    D = grad_out.shape[1]
    V = row_start.numel() - 1
    dev = grad_out.device
    count = (row_start[1:] - row_start[:-1]).long()
    slots = order[:int(row_start[V])].long()
    contrib = grad_out.float()[slots // L]
    if weights is not None:
        contrib = contrib * weights.reshape(-1).float()[slots][:, None]
    # every touched row's chunks, numbered row by row: (row, first slot, length)
    nseg = (count + chunk - 1) // chunk
    seg_first = torch.cumsum(nseg, 0) - nseg
    seg_row = torch.repeat_interleave(torch.arange(V, device=dev), nseg)
    seg_j = torch.arange(seg_row.numel(), device=dev) - seg_first[seg_row]
    seg_start = row_start[seg_row].long() + seg_j * chunk
    seg_len = torch.clamp(count[seg_row] - seg_j * chunk, max=chunk)
    # level 1: each chunk's slots in order; the chunks longest first, so the
    # chunks that have an o-th slot are a prefix
    by_len = torch.argsort(seg_len, descending=True, stable=True)
    partials = torch.zeros((seg_row.numel(), D), dtype=torch.float32, device=dev)
    for o, n in enumerate(_prefix_sizes(seg_len)):
        segs = by_len[:n]
        partials[segs] += contrib[seg_start[segs] + o]
    # level 2: each row's partials in order, the rows with most chunks first
    by_nseg = torch.argsort(nseg, descending=True, stable=True)
    out = torch.zeros((V, D), dtype=torch.float32, device=dev)
    for j, n in enumerate(_prefix_sizes(nseg)):
        rows = by_nseg[:n]
        out[rows] += partials[seg_first[rows] + j]
    return out


def bag_case(V, D, B, L, dtype=torch.float32, seed=0, device="cpu"):
    """A normal (V, D) table of ``dtype``, (B, L) int32 ids in [-1, V) with
    -1, -7, V and V+3 planted at random slots, and normal (B, L) weights of
    ``dtype`` with a NaN on one padding slot; drawn with numpy from
    ``seed``, then placed on ``device``."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(dtype)
    idx = rng.integers(-1, V, (B, L)).astype(np.int32)
    slots = rng.choice(B * L, min(5, B * L), replace=False)
    idx.flat[slots] = [-1, -7, V, V + 3, -1][:len(slots)]
    w = rng.standard_normal((B, L)).astype(np.float32)
    w.flat[slots[-1]] = np.nan
    return (table.to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(w).to(dtype).to(device))


def bag_of_one_case(V, D, B, dtype=torch.float32, seed=0, device="cpu"):
    """Bags of one, as ``take_rows`` makes them: a normal (V, D) table of
    ``dtype`` with -0.0 in every third element of the first bag's row,
    (B, 1) int32 ids in [0, V) with -1, -7, V and V+3 planted after the
    first bag (as many as fit), and normal (B, 1) weights of ``dtype`` with
    a NaN on the last planted slot; drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, 1)).astype(np.int32)
    planted = [-1, -7, V, V + 3][: max(B - 1, 0)]
    slots = 1 + rng.choice(B - 1, len(planted), replace=False) if planted else []
    idx[slots, 0] = planted
    table[idx[0, 0], ::3] = -0.0
    w = rng.standard_normal((B, 1)).astype(np.float32)
    if planted:
        w[slots[-1], 0] = np.nan
    return (torch.from_numpy(table).to(dtype).to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(w).to(dtype).to(device))


def bag_grad_case(V, D, B, L, seed=0, *, hot=0.0, weighted=False, device="cpu"):
    """Inputs of the backward kernel: normal float32 ``grad_out`` (B, D),
    (B, L) int32 ids in [0, V) with -1, -7, V and V+3 planted (duplicates
    throughout), a share ``hot`` of the slots set to id 1 (a row longer
    than ``BACKWARD_CHUNK`` when ``hot * B * L`` exceeds it), and normal
    (B, L) float32 weights or None; drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    flat = idx.reshape(-1)
    if hot:
        flat[rng.choice(flat.size, int(hot * flat.size), replace=False)] = 1
    planted = [-1, -7, V, V + 3][:flat.size]
    flat[rng.choice(flat.size, len(planted), replace=False)] = planted
    w = rng.standard_normal((B, L)).astype(np.float32) if weighted else None
    return (torch.from_numpy(g).to(device), torch.from_numpy(idx).to(device),
            None if w is None else torch.from_numpy(w).to(device))


def same_bits(got, want) -> bool:
    """Bit for bit equal, so -0.0 differs from +0.0 (``torch.equal`` does not
    tell them apart) and a NaN equals the same NaN."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[want.dtype]
    return bool(torch.equal(got.contiguous().view(view), want.contiguous().view(view)))


def bf16_ulps(got, want):
    """bfloat16 distance of ``got`` from ``want`` in units in the last
    place, element by element (0 for equal values, 1 for neighbours)."""
    def key(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -32768 - b, b)

    return (key(got) - key(want)).abs()
