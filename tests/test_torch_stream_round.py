"""Port parity for the fused ``sparse_streamed`` round (BFS's and wBFS's edgeMap).

On the card a round of min over int32 with the identity map or wBFS's
saturating add is one launch of ``compressed_stream_round``; everywhere else
it is the chunk loop, which is the fused round's plain version.  Here, on
the CPU, both plain routes go through the same inputs as the JAX package's
``edgemap_chunked(..., streamed=True)`` and
``edgemap_chunked_batched_streamed``, and must equal them bit for bit, on
``out`` and ``touched``: the chunk loop as the CPU runs it, and the fused
round's wrapper (its plain version on the CPU) with the route forced.
The inputs are made with numpy from a seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro_torch.core.edgemap as port_edgemap
from repro.algorithms.traversal import _cohort_relax as jrelax
from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core.edgemap import _identity_map as jidentity
from repro.core.edgemap import edgemap_chunked as jchunked
from repro.core.edgemap import edgemap_chunked_batched_streamed as jbatched
from repro.data import rmat_graph as jrmat_graph
from repro_torch.algorithms.traversal import _relax
from repro_torch.core import exception_dense
from repro_torch.core.edgemap import (
    _identity_map,
    edgemap_chunked,
    edgemap_chunked_batched_streamed,
    stream_round_route,
)
from repro_torch.core.primitives import INF_I32
from torch_parity import port_graph, to_np

MAPS = {"identity": (_identity_map, jidentity), "sat_add_i32": (_relax, jrelax)}
FORMS = {"single": None, "batch of 1": 1, "batch of 8": 8}


def _exception_graph():
    """n > 2^16 and few edges: sorted targets of a few hubs lie more than
    2^16 apart, so their blocks hold ESCAPE deltas; weights are not whole."""
    rng = np.random.default_rng(7)
    n = (1 << 17) + 3
    hubs = rng.choice(n, 12, replace=False)
    src = np.concatenate([np.repeat(hubs, 6), rng.integers(0, n, 600)])
    far = np.concatenate([rng.choice(n, 6, replace=False) for _ in hubs])
    dst = np.concatenate([far, rng.integers(0, n, 600)])
    w = rng.uniform(0.5, 9.5, src.shape[0]).astype(np.float32)
    return jbuild_csr(n, src, dst, w, block_size=32, symmetrize=True)


GRAPHS = {
    "rmat weighted F_B=32": lambda: jcompress(
        jrmat_graph(256, 2048, weighted=True, seed=3, block_size=32)),
    "rmat unweighted F_B=64": lambda: jcompress(
        jrmat_graph(512, 4096, weighted=False, seed=5, block_size=64)),
    "exceptions": lambda: jcompress(_exception_graph()),
}
_CACHE = {}


def _graph(name):
    if name not in _CACHE:
        jg = GRAPHS[name]()
        _CACHE[name] = (jg, port_graph(jg))
    return _CACHE[name]


def _inputs(jg, B, seed):
    """Frontier, int32 state (with values at and near the saturation point,
    and at INF), an edge-slot mask and mixed map lanes."""
    rng = np.random.default_rng(seed)
    n, rows = jg.n, 1 if B is None else B
    frontier = rng.random((rows, n)) < 0.08
    deg = np.asarray(jg.degrees)
    frontier[:, np.argsort(deg)[-3:]] = True         # the hubs: their blocks are live
    # and the owners of the blocks that hold ESCAPE deltas
    frontier[:, np.asarray(jg.block_src)[np.asarray(jg.exc_block)]] = True
    x = rng.integers(0, 5000, (rows, n)).astype(np.int32)
    x[rng.random((rows, n)) < 0.05] = INF_I32
    x[rng.random((rows, n)) < 0.05] = INF_I32 - (1 << 24) - rng.integers(-3, 4)
    active = rng.random(jg.num_blocks * jg.block_size) < 0.7
    lanes = rng.random(rows) < 0.5
    lanes[0] = True
    if B is None:
        return frontier[0], x[0], active, None
    return frontier, x, active, lanes


def _jax_round(jg, frontier, x, map_name, active, lanes):
    kw = dict(monoid="min", map_fn=MAPS[map_name][1],
              edge_active=None if active is None else jnp.asarray(active))
    if frontier.ndim == 1:
        return jchunked(jg, jnp.asarray(frontier), jnp.asarray(x), streamed=True, **kw)
    return jbatched(jg, jnp.asarray(frontier), jnp.asarray(x), map_lanes=jnp.asarray(lanes),
                    **kw)


def _port_round(g, frontier, x, map_fn, active, lanes):
    kw = dict(monoid="min", map_fn=map_fn,
              edge_active=None if active is None else torch.from_numpy(active))
    if frontier.ndim == 1:
        return edgemap_chunked(g, torch.from_numpy(frontier), torch.from_numpy(x),
                               streamed=True, **kw)
    return edgemap_chunked_batched_streamed(g, torch.from_numpy(frontier), torch.from_numpy(x),
                                            map_lanes=torch.from_numpy(lanes), **kw)


def test_exception_graph_streams_with_exceptions():
    _, g = _graph("exceptions")
    assert g.n > 1 << 16 and g.n_exceptions > 0 and not exception_dense(g)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("map_name", sorted(MAPS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_routes_equal_jax(graph, map_name, masked, form, monkeypatch):
    jg, g = _graph(graph)
    frontier, x, active, lanes = _inputs(jg, FORMS[form], seed=len(graph) + len(form))
    active = active if masked else None
    want_out, want_touched = _jax_round(jg, frontier, x, map_name, active, lanes)
    assert np.asarray(want_touched).any()

    map_fn = MAPS[map_name][0]
    assert stream_round_route(g.device, "min", map_fn, torch.int32) == "chunks"
    got = _port_round(g, frontier, x, map_fn, active, lanes)          # the chunk loop
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want_out))
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want_touched))

    # the fused round's wrapper, which runs its plain version on the CPU
    monkeypatch.setattr(port_edgemap, "stream_round_route", lambda *args: "fused")
    fused = _port_round(g, frontier, x, map_fn, active, lanes)
    np.testing.assert_array_equal(to_np(fused[0]), np.asarray(want_out))
    np.testing.assert_array_equal(to_np(fused[1]), np.asarray(want_touched))


def _untagged(xs, w):
    return _relax(xs, w)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("monoid", ["min", "max", "sum"])
@pytest.mark.parametrize("map_name", ["identity", "sat_add_i32", "untagged"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_route_is_a_function_of_device_monoid_map_and_dtype(device, monoid, map_name, dtype):
    map_fn = _untagged if map_name == "untagged" else MAPS[map_name][0]
    fused = device == "cuda" and monoid == "min" and dtype == torch.int32 \
        and map_name != "untagged"
    want = "fused" if fused else "chunks"
    assert stream_round_route(torch.device(device), monoid, map_fn, dtype) == want
    assert stream_round_route(device, monoid, map_fn, dtype) == want


@pytest.mark.parametrize("form", ["single", "batch of 8"])
def test_untagged_map_runs_the_chunk_loop(form, monkeypatch):
    """With the tensors' route taken for the card's, a tagged map makes one
    fused call a round; the same map untagged runs the chunk loop, and the
    two agree."""
    import repro_torch.kernels.compressed_spmv.ops as ops
    from repro_torch.kernels import compressed_stream_round_ref

    jg, g = _graph("exceptions")
    frontier, x, active, lanes = _inputs(jg, FORMS[form], seed=11)
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs["map_kind"])
        return compressed_stream_round_ref(*args, **kwargs)

    monkeypatch.setattr(port_edgemap, "kernel_route", lambda device: "cuda")
    monkeypatch.setattr(ops, "compressed_stream_round", counted)
    fused = _port_round(g, frontier, x, _relax, active, lanes)
    assert calls == ["sat_add_i32"]
    chunks = _port_round(g, frontier, x, _untagged, active, lanes)
    assert calls == ["sat_add_i32"]
    assert torch.equal(fused[0], chunks[0]) and torch.equal(fused[1], chunks[1])
    np.testing.assert_array_equal(to_np(chunks[0]),
                                  np.asarray(_jax_round(jg, frontier, x, "sat_add_i32",
                                                        active, lanes)[0]))
