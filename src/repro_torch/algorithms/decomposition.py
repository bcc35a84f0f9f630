"""Connectivity problems (§4.3.2) — LDD and connectivity.

``ldd`` is the Miller–Peng–Xu low-diameter decomposition with quantized
shifts: a BFS from every center at once, with min-cluster-id tie-breaks, in
which vertex v wakes as a center at round ⌊δ_max − δ_v⌋ if still
unclustered.  ``connectivity`` seeds the min-label fixpoint with LDD's
clusters and canonicalizes each component to its min vertex id, so its
labels do not depend on the shifts drawn.

The loops are Python loops over a host-read predicate, one read a round;
each counts its rounds in ``sage_algorithm_rounds_total{algorithm="ldd"}``
and ``{algorithm="min_label_prop"}``.
"""
from __future__ import annotations

import torch

from ..core.backend import GraphLike
from ..core.edgemap import edgemap_reduce
from ..core.primitives import segment_reduce
from .covering import count_round

UNVISITED = -1


def ldd_shift(n: int, beta: float, generator: torch.Generator) -> torch.Tensor:
    """The per-vertex shifts δ_v ~ Exp(β), float32[n] on ``generator``'s
    device, clamped at 2·ln(n+1)/β."""
    e = torch.empty(n, dtype=torch.float32, device=generator.device)
    e.exponential_(generator=generator)
    shift = e / beta
    cap = torch.tensor(float(n + 1), dtype=torch.float32).log() * 2.0 / beta
    return torch.minimum(shift, cap.to(shift.device))


def ldd(
    g: GraphLike,
    beta: float,
    generator: torch.Generator | None = None,
    *,
    shift: torch.Tensor | None = None,
    mode: str = "auto",
    plan=None,
):
    """(O(β), O(log n / β)) decomposition.  Returns cluster int32[n]
    (cluster id == center vertex id).

    The shifts are drawn from ``generator`` (``ldd_shift``), or passed as
    ``shift`` (float32[n], already divided by β and clamped); the clusters
    are a function of the shifts alone.
    """
    n, dev = g.n, g.device
    if plan is not None:
        g = plan.prepare(g)
    if shift is None:
        if generator is None:
            raise ValueError("ldd needs a generator or a shift")
        shift = ldd_shift(n, beta, generator)
    shift = torch.as_tensor(shift, dtype=torch.float32).to(dev)
    if shift.shape != (n,):
        raise ValueError(f"shift must be float32[{n}], got {tuple(shift.shape)}")
    start_round = torch.floor(shift.max() - shift).to(torch.int32)
    max_round = int(start_round.max())
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    cluster = torch.full((n,), UNVISITED, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    r = 0
    # every vertex self-starts by max_round; + n rounds of expansion
    while r < max_round + n + 2 and bool(frontier.any() | (cluster == UNVISITED).any()):
        cand, touched = edgemap_reduce(g, frontier, cluster, monoid="min", mode=mode,
                                       plan=plan)
        newly = touched & (cluster == UNVISITED)
        cluster = torch.where(newly, cand, cluster)
        wake = (cluster == UNVISITED) & (start_round <= r)
        cluster = torch.where(wake, ids, cluster)
        frontier = newly | wake
        r += 1
        count_round("ldd")
    return cluster


def _min_label_prop(
    g: GraphLike,
    labels0: torch.Tensor,
    *,
    edge_active=None,
    vertex_mask: torch.Tensor | None = None,
    plan=None,
):
    """Hook-and-compress min-label fixpoint; labels must be vertex ids.

    Every round is a dense pass (all vertices push), then two pointer
    jumps."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    full_mask = (torch.ones(n, dtype=torch.bool, device=g.device)
                 if vertex_mask is None else vertex_mask)
    labels = labels0
    while True:
        nbr, _ = edgemap_reduce(g, full_mask, labels, monoid="min",
                                edge_active=edge_active, mode="dense", plan=plan)
        new = torch.minimum(labels, nbr)
        if vertex_mask is not None:
            new = torch.where(full_mask, new, labels)
        new = new[new.long()]  # compress (pointer jump)
        new = new[new.long()]
        changed = bool((new != labels).any())
        labels = new
        count_round("min_label_prop")
        if not changed:
            return labels


def connectivity(
    g: GraphLike,
    generator: torch.Generator | None = None,
    *,
    use_ldd: bool = True,
    shift: torch.Tensor | None = None,
    plan=None,
):
    """Connected components; label = min vertex id of the component.

    With ``use_ldd`` and a ``generator`` (or an LDD ``shift``), one LDD with
    β = 0.2 seeds the labels with cluster ids; otherwise every vertex starts
    as its own label.  The labels equal whatever the seed."""
    n = g.n
    if plan is not None:
        g = plan.prepare(g)
    if use_ldd and (generator is not None or shift is not None):
        labels0 = ldd(g, 0.2, generator, shift=shift, plan=plan)
    else:
        labels0 = torch.arange(n, dtype=torch.int32, device=g.device)
    labels = _min_label_prop(g, labels0, plan=plan)
    # canonicalize: component representative = min vertex id
    rep = segment_reduce(torch.arange(n, dtype=torch.int32, device=g.device), labels, n,
                         "min")
    return rep[labels.long()]

