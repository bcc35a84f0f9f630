"""Fanout neighbour sampler (GraphSAGE-style), which the ``minibatch_lg``
shape needs (232,965 nodes / 114.6M edges, batch 1024, fanout 15-10).

Host-side numpy over a CSR, as in the JAX package, whose output it equals
array for array for the same ``np.random.Generator``: the draws are the same
``rng.choice`` calls in the same order.  The local remap of the sampled
edges is one ``np.searchsorted`` over the sorted node list (the JAX package
walks a dict).  Fixed-shape padded arrays:

  nodes             : seeds and sampled frontier nodes, sorted, padded with -1
                      (a caller that gathers features by them must fill the
                      padding, not wrap it)
  edge_src/edge_dst : sampled edges as local indices into ``nodes``, padded
                      with the sentinel ``len(nodes)``
"""
from __future__ import annotations

import numpy as np


def sample_fanout(
    offsets: np.ndarray,
    targets: np.ndarray,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    *,
    rng: np.random.Generator | None = None,
):
    """Returns (nodes, edge_src_local, edge_dst_local, n_real_nodes,
    n_real_edges), padded to the static maximum implied by fanouts."""
    rng = rng or np.random.default_rng(0)
    seeds = np.asarray(seeds, dtype=np.int64)
    layers = [seeds]
    edges_s, edges_d = [], []
    frontier = seeds
    for f in fanouts:
        samp_src, samp_dst = [], []
        for v in frontier:
            beg, end = int(offsets[v]), int(offsets[v + 1])
            deg = end - beg
            if deg == 0:
                continue
            take = min(f, deg)
            picks = rng.choice(deg, size=take, replace=False)
            samp_src.append(np.full(take, v))
            samp_dst.append(targets[beg + picks])
        if samp_src:
            s = np.concatenate(samp_src)
            d = np.concatenate(samp_dst)
        else:
            s = d = np.zeros(0, dtype=np.int64)
        edges_s.append(s)
        edges_d.append(d)
        frontier = np.unique(d)
        layers.append(frontier)

    nodes = np.unique(np.concatenate(layers))
    es = np.concatenate(edges_s) if edges_s else np.zeros(0, np.int64)
    ed = np.concatenate(edges_d) if edges_d else np.zeros(0, np.int64)
    es_l = np.searchsorted(nodes, es).astype(np.int32)  # every sampled id is in nodes
    ed_l = np.searchsorted(nodes, ed).astype(np.int32)

    # pad to static shapes
    max_nodes, max_edges = padded_sizes(len(seeds), fanouts)
    n_real, e_real = len(nodes), len(es_l)
    nodes_p = np.full(max_nodes, -1, np.int64)
    nodes_p[:n_real] = nodes
    src_p = np.full(max_edges, max_nodes, np.int32)  # sentinel = max_nodes
    dst_p = np.full(max_edges, max_nodes, np.int32)
    src_p[:e_real] = es_l
    dst_p[:e_real] = ed_l
    return nodes_p, src_p, dst_p, n_real, e_real


def padded_sizes(n_seeds: int, fanouts: tuple[int, ...]) -> tuple[int, int]:
    """Static maxima: nodes = Σ layer sizes; edges = Σ frontier·fanout."""
    nodes = n_seeds
    frontier = n_seeds
    edges = 0
    for f in fanouts:
        edges += frontier * f
        frontier = frontier * f
        nodes += frontier
    return nodes, edges
