"""GNN message-passing primitives: the PSAM edgeMap applied to features.

The edge index arrays are the immutable large-memory structure (padded with
the sentinel node id ``n``); per-node features are the O(n·d) small-memory
state.  Message passing is a gather over the edge list and a segment
reduce into the vertices, as in the JAX package (``jnp.take`` and
``jax.ops.segment_*``), here ``index_select`` and ``index_add`` /
``scatter_reduce`` over ``n + 1`` segments whose last one is dropped.

The JAX semantics are kept for every integer index:

* ``gather_src`` is ``jnp.take(mode="fill")``: ids in [-n, -1] wrap, every
  other id outside [0, n) gives a row of ``fill``;
* the ``scatter_*`` reductions drop every segment id outside [0, n)
  (``jax.ops.segment_*`` over ``n + 1`` segments, the last one sliced off);
* an empty segment of ``scatter_max`` / ``scatter_min`` is -inf / +inf
  clamped to ``neutral`` (-1e30 / 1e30), and a max or min's gradient is
  split evenly among the elements that tie for it;
* ``jnp.maximum`` becomes ``torch.maximum`` (both split the gradient of a
  tie in half), never ``clamp_min``.

On the card the sums are atomic adds (their order varies from run to run);
max and min are exact.

On a process mesh each rank holds the whole node state and one range of
the edge list (``EdgeSlice``): every reduction takes ``part=``, runs over
the rank's edges into all ``n`` segments, then combines across the ranks
through the slice's callbacks (written in ``distributed/gnn.py``): sums an
all-reduce whose backward all-reduces the gradient, max and min an
all-reduce MAX / MIN whose backward splits the gradient among the elements
that tie for the global extremum, counts an all-reduce with no gradient.
``part=None`` runs the one-device operations unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class EdgeSlice:
    """One rank's range ``[lo, hi)`` of an edge list (DimeNet's: its
    triplet list) split over ``parts`` ranks, and the combines across them
    (``distributed.gnn.edge_slice`` makes it):

    * ``sum(t)``: ``t`` summed over the ranks, a new tensor; its backward
      sums the incoming gradient over the ranks;
    * ``extremum(vals, seg, local, reduce)``: ``local``, this rank's
      ``"amax"`` / ``"amin"`` of ``vals`` by segment ``seg``, combined over
      the ranks; its backward gives ``vals`` the gradient split evenly among
      the elements, on every rank, that tie for the global extremum;
    * ``reduce(t, op)``: ``t`` reduced in place by ``"sum"`` or ``"max"``
      over the ranks, with no gradient."""

    lo: int
    hi: int
    parts: int
    sum: Callable
    extremum: Callable
    reduce: Callable

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's range of the leading axis of ``t``."""
        return t[self.lo:self.hi]


def gather_src(x: torch.Tensor, src: torch.Tensor, fill=0.0) -> torch.Tensor:
    """The rows of ``x`` by ``src``: ``jnp.take(x, src, axis=0, mode="fill",
    fill_value=fill)``.  Ids in [-n, -1] count from the end; every other id
    outside [0, n), the sentinel ``n`` among them, gives a row of ``fill``.
    One ``index_select`` over ``x`` with a row of ``fill`` appended."""
    n = x.shape[0]
    i = src.long()
    i = torch.where(i < 0, i + n, i)
    i = torch.where((i >= 0) & (i < n), i, n)
    xp = torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), fill)])
    return xp.index_select(0, i)


def _segments(dst: torch.Tensor, n: int) -> torch.Tensor:
    """int64 segment ids with every id outside [0, n) sent to ``n``."""
    d = dst.long()
    return torch.where((d >= 0) & (d < n), d, n)


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)`` for a constant ``c``: a tie's gradient split in
    half, as JAX does (``clamp_min`` would pass all of it)."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.minimum(x, c)`` for a constant ``c``."""
    return torch.minimum(x, torch.full((), c, dtype=x.dtype, device=x.device))


class _SegmentSum(torch.autograd.Function):
    """``index_add`` into n + 1 zero rows whose backward is one
    ``index_select`` of the incoming gradient.  Autograd's own ``index_add``
    keeps its (E, ...) source alive until the backward (15.8 GB a layer of
    GIN at ogb_products); this keeps only the (E,) segment ids."""

    @staticmethod
    def forward(ctx, vals, seg, rows):
        ctx.save_for_backward(seg)
        return vals.new_zeros((rows,) + tuple(vals.shape[1:])).index_add_(0, seg, vals)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        return grad.index_select(0, seg), None, None


def scatter_sum(vals: torch.Tensor, dst: torch.Tensor, n: int,
                part: EdgeSlice | None = None) -> torch.Tensor:
    """``segment_sum(vals, dst, n + 1)[:n]``: (n, ...) sums by destination;
    with ``part`` the rank's sums combined over the ranks."""
    out = _SegmentSum.apply(vals, _segments(dst, n), n + 1)[:n]
    return out if part is None else part.sum(out)


def scatter_mean(vals, dst, n, *, deg=None, part: EdgeSlice | None = None):
    s = scatter_sum(vals, dst, n, part)
    if deg is None:
        deg = degrees(dst, n, part)
    d = maximum(deg, 1.0)
    return s / d.reshape((-1,) + (1,) * (vals.ndim - 1))


def _scatter_extremal(vals, dst, n, reduce: str) -> torch.Tensor:
    """(n + 1, ...) ``amax`` / ``amin`` by destination, an empty segment
    -inf / +inf (the reduction's identity, as ``jax.ops.segment_max``)."""
    init = float("-inf") if reduce == "amax" else float("inf")
    idx = _segments(dst, n).reshape((-1,) + (1,) * (vals.ndim - 1)).expand(vals.shape)
    out = vals.new_full((n + 1,) + tuple(vals.shape[1:]), init)
    return out.scatter_reduce(0, idx, vals, reduce, include_self=False)


def _extremal(vals, dst, n, reduce: str, part: EdgeSlice | None) -> torch.Tensor:
    """(n, ...) ``amax`` / ``amin`` by destination, over every rank's edges
    with ``part``."""
    if part is None:
        return _scatter_extremal(vals, dst, n, reduce)[:n]
    local = _scatter_extremal(vals.detach(), dst, n, reduce)
    return part.extremum(vals, _segments(dst, n), local, reduce)[:n]


def scatter_max(vals, dst, n, *, neutral=-1e30, part: EdgeSlice | None = None):
    return maximum(_extremal(vals, dst, n, "amax", part), neutral)


def scatter_min(vals, dst, n, *, neutral=1e30, part: EdgeSlice | None = None):
    return minimum(_extremal(vals, dst, n, "amin", part), neutral)


def scatter_std(vals, dst, n, *, deg=None, eps=1e-5, part: EdgeSlice | None = None):
    mu = scatter_mean(vals, dst, n, deg=deg, part=part)
    mu2 = scatter_mean(vals * vals, dst, n, deg=deg, part=part)
    return torch.sqrt(maximum(mu2 - mu * mu, 0.0) + eps)


def degrees(dst: torch.Tensor, n: int, part: EdgeSlice | None = None) -> torch.Tensor:
    """(n,) float32 in-degrees; with ``part`` every rank's counted (whole
    floats below 2^24: the all-reduce is exact)."""
    d = scatter_sum(torch.ones(dst.shape, dtype=torch.float32, device=dst.device), dst, n)
    return d if part is None else part.reduce(d, "sum")


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor, n: int,
                    part: EdgeSlice | None = None) -> torch.Tensor:
    """Edge-softmax by destination (Equiformer's attention).  The max is
    detached (JAX's ``stop_gradient``); ``jnp.take``'s default fill for an
    id out of range is NaN.  With ``part`` the max is every rank's (an
    all-reduce MAX, no gradient) and the denominator a combined sum."""
    mx = _scatter_extremal(scores.detach(), dst, n, "amax")[:n]
    if part is not None:
        mx = part.reduce(mx, "max")
    near = torch.minimum(dst.long(), torch.tensor(n - 1, device=dst.device))
    mx = gather_src(mx, near, float("nan"))
    ex = torch.exp(scores - mx)
    den = gather_src(scatter_sum(ex, dst, n, part), near, float("nan"))
    return ex / maximum(den, 1e-30)
