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
"""
from __future__ import annotations

import torch


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


def scatter_sum(vals: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """``segment_sum(vals, dst, n + 1)[:n]``: (n, ...) sums by destination."""
    return _SegmentSum.apply(vals, _segments(dst, n), n + 1)[:n]


def scatter_mean(vals, dst, n, *, deg=None):
    s = scatter_sum(vals, dst, n)
    if deg is None:
        deg = scatter_sum(torch.ones(vals.shape[:1], dtype=torch.float32, device=vals.device),
                          dst, n)
    d = maximum(deg, 1.0)
    return s / d.reshape((-1,) + (1,) * (vals.ndim - 1))


def _scatter_extremal(vals, dst, n, reduce: str) -> torch.Tensor:
    """(n + 1, ...) ``amax`` / ``amin`` by destination, an empty segment
    -inf / +inf (the reduction's identity, as ``jax.ops.segment_max``)."""
    init = float("-inf") if reduce == "amax" else float("inf")
    idx = _segments(dst, n).reshape((-1,) + (1,) * (vals.ndim - 1)).expand(vals.shape)
    out = vals.new_full((n + 1,) + tuple(vals.shape[1:]), init)
    return out.scatter_reduce(0, idx, vals, reduce, include_self=False)


def scatter_max(vals, dst, n, *, neutral=-1e30):
    return maximum(_scatter_extremal(vals, dst, n, "amax")[:n], neutral)


def scatter_min(vals, dst, n, *, neutral=1e30):
    return minimum(_scatter_extremal(vals, dst, n, "amin")[:n], neutral)


def scatter_std(vals, dst, n, *, deg=None, eps=1e-5):
    mu = scatter_mean(vals, dst, n, deg=deg)
    mu2 = scatter_mean(vals * vals, dst, n, deg=deg)
    return torch.sqrt(maximum(mu2 - mu * mu, 0.0) + eps)


def degrees(dst: torch.Tensor, n: int) -> torch.Tensor:
    return scatter_sum(torch.ones(dst.shape, dtype=torch.float32, device=dst.device), dst, n)


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Edge-softmax by destination (Equiformer's attention).  The max is
    detached (JAX's ``stop_gradient``); ``jnp.take``'s default fill for an
    id out of range is NaN."""
    mx = _scatter_extremal(scores, dst, n, "amax")[:n]
    near = torch.minimum(dst.long(), torch.tensor(n - 1, device=dst.device))
    mx = gather_src(mx, near, float("nan"))
    ex = torch.exp(scores - mx.detach())
    den = gather_src(scatter_sum(ex, dst, n), near, float("nan"))
    return ex / maximum(den, 1e-30)
