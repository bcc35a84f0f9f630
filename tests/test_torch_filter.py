"""Port parity for the graphFilter packing path and the filter algorithms.

Kernel 4 (``filter_pack``) in its plain version and through its CPU route,
``pack_vertices`` / ``filter_edges`` / ``live_block_indices``, the filter
carry-over and the PSAM charge, then the eight algorithms of
``covering.py`` and ``substructure.py``, each against the JAX package on
the same graph (built there, carried over as numpy arrays).  Every
comparison is exact: filter words, ``active_deg``, ``dirty``, partners,
cover, MIS, colors, coreness, densest mask and density, triangle count.
MIS and set cover are given the JAX package's ``jax.random.permutation``.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.algorithms as J
from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import make_filter as jmake_filter
from repro.core.graph_filter import GraphFilter as JGraphFilter
from repro.core.graph_filter import edge_active_flat as jedge_active_flat
from repro.core.graph_filter import filter_edges as jfilter_edges
from repro.core.graph_filter import filter_edges_pred as jfilter_edges_pred
from repro.core.graph_filter import live_block_indices as jlive_block_indices
from repro.core.graph_filter import pack_vertices as jpack_vertices
from repro.core.psam import PSAMCost as JPSAMCost
from repro.data import rmat_graph as jrmat_graph
from repro.kernels.filter_pack import filter_pack as jfilter_pack
from repro.kernels.filter_pack import filter_pack_ref as jfilter_pack_ref
from repro.kernels.filter_pack.filter_pack import filter_pack_pallas
import repro_torch.algorithms as T
from repro_torch.core import (
    PSAMCost,
    edge_active_flat,
    filter_edges,
    filter_edges_pred,
    filter_from_reference_arrays,
    filter_to_reference_arrays,
    live_block_indices,
    make_filter,
    pack_vertices,
)
from repro_torch.kernels import filter_pack, filter_pack_ref, filter_pack_words
from repro_torch.obs import Registry
from torch_parity import CPU, port_graph, to_np, words_u32


def _wide_graph():
    """Compressed with a few ≥2¹⁶ exceptions: vertices 0..9 reach both
    ends of 70,000 ids, the rest is a dense little core."""
    rng = np.random.default_rng(4)
    src = np.concatenate([np.repeat(np.arange(10), 6), rng.integers(1, 40, 240)])
    dst = np.concatenate([np.where(np.arange(60) % 2 == 0, rng.integers(10, 40, 60),
                                   rng.integers(69000, 70000, 60)),
                          rng.integers(0, 40, 240)])
    return jcompress(jbuild_csr(70000, src, dst, block_size=32, symmetrize=True))


GRAPHS = {
    "csr32": lambda: jrmat_graph(256, 2048, seed=5, block_size=32),
    "compressed64": lambda: jcompress(jrmat_graph(300, 2400, weighted=True, seed=6,
                                                  block_size=64)),
    "csr128": lambda: jrmat_graph(512, 4096, seed=7, block_size=128),
    "exceptions": _wide_graph,
}
_CACHE = {}


def _graph(name):
    if name not in _CACHE:
        jg = GRAPHS[name]()
        _CACHE[name] = (jg, port_graph(jg))
    return _CACHE[name]


def _port_filter(jf):
    arrays = {k: np.asarray(getattr(jf, k)) for k in ("bits", "active_deg", "dirty")}
    meta = {k: getattr(jf, k) for k in ("n", "num_blocks", "block_size")}
    return filter_from_reference_arrays(arrays, meta, CPU)


def _assert_filter_equal(f, jf):
    np.testing.assert_array_equal(words_u32(f.bits), np.asarray(jf.bits))
    np.testing.assert_array_equal(to_np(f.active_deg), np.asarray(jf.active_deg))
    np.testing.assert_array_equal(to_np(f.dirty), np.asarray(jf.dirty))
    assert (f.n, f.num_blocks, f.block_size) == (jf.n, jf.num_blocks, jf.block_size)


# ----------------------------------------------------------------------
# kernel 4 against the Pallas kernel (interpret) and the JAX oracle
# ----------------------------------------------------------------------
def _pack_inputs(nb, fb, seed, subset="random", keep="random"):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, (nb, fb // 32), dtype=np.uint64).astype(np.uint32)
    bits[:, 0] |= np.uint32(1 << 31)       # words with bit 31 set
    bits[0, :] = np.uint32(0xFFFFFFFF)
    keep_m = {"random": rng.random((nb, fb)) < 0.5,
              "none": np.zeros((nb, fb), bool)}[keep]
    sub = {"random": rng.random(nb) < 0.6, "none": np.zeros(nb, bool),
           "all": np.ones(nb, bool)}[subset]
    return bits, keep_m, sub


@pytest.mark.parametrize("nb,fb,pallas_tile", [(8, 32, 2), (46, 32, 8), (17, 64, 4),
                                               (13, 128, 8)])
@pytest.mark.parametrize("subset,keep", [("random", "random"), ("none", "random"),
                                         ("all", "random"), ("all", "none")])
def test_filter_pack_matches_pallas_and_oracle(nb, fb, pallas_tile, subset, keep):
    bits, keep_m, sub = _pack_inputs(nb, fb, nb * fb, subset, keep)
    jb, jk, js = jnp.asarray(bits), jnp.asarray(keep_m), jnp.asarray(sub)
    want_bits, want_cnt = filter_pack_pallas(jb, jk, js, tile_blocks=pallas_tile,
                                              interpret=True)
    oracle_bits, oracle_cnt = jfilter_pack_ref(jb, jk, js)
    np.testing.assert_array_equal(np.asarray(want_bits), np.asarray(oracle_bits))
    tb, tk, ts = torch.from_numpy(bits.view(np.int32)), torch.from_numpy(keep_m), \
        torch.from_numpy(sub)
    for got_bits, got_cnt in (filter_pack_ref(tb, tk, ts),
                              filter_pack_words(tb, tk, ts)):
        assert got_bits.dtype == torch.int32 and got_cnt.dtype == torch.int32
        np.testing.assert_array_equal(words_u32(got_bits), np.asarray(want_bits))
        np.testing.assert_array_equal(to_np(got_cnt), np.asarray(want_cnt))
        np.testing.assert_array_equal(to_np(got_cnt), np.asarray(oracle_cnt))


def test_cpu_route_never_reaches_the_build(monkeypatch):
    from repro_torch.kernels import build

    mod = importlib.import_module("repro_torch.kernels.filter_pack.filter_pack")

    def refuse(*a, **k):
        raise AssertionError("the CPU route reached the kernel build")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(mod, "load_library", refuse)
    before = filter_pack_words.launches
    bits, keep_m, sub = _pack_inputs(9, 64, 1)
    filter_pack_words(torch.from_numpy(bits.view(np.int32)), torch.from_numpy(keep_m),
                      torch.from_numpy(sub))
    _, g = _graph("csr32")
    f = make_filter(g)
    pack_vertices(g, f, torch.ones(g.n, dtype=torch.bool), g.edge_dst % 2 == 0)
    assert filter_pack_words.launches == before


# ----------------------------------------------------------------------
# pack_vertices, filter_edges, live blocks, the op, the carry-over
# ----------------------------------------------------------------------
def _predicates(jg):
    """A keep predicate and a partial subset, from a numpy seed."""
    rng = np.random.default_rng(jg.num_blocks)
    keep = rng.random(jg.num_blocks * jg.block_size) < 0.7
    subset = rng.random(jg.n) < 0.5
    return keep, subset


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pack_vertices_and_filter_edges_match(name):
    jg, g = _graph(name)
    keep, subset = _predicates(jg)
    # a first pack, so that the filter carried over has dirty vertices
    jf = jpack_vertices(jg, jmake_filter(jg), jnp.ones(jg.n, bool),
                        jnp.asarray(keep) | ~jg.edge_valid)
    f = _port_filter(jf)
    assert bool(np.asarray(jf.dirty).any())
    keep2 = np.roll(keep, 7)
    want = jpack_vertices(jg, jf, jnp.asarray(subset), jnp.asarray(keep2))
    got = pack_vertices(g, f, torch.from_numpy(subset), torch.from_numpy(keep2))
    _assert_filter_equal(got, want)
    assert int(got.num_active_edges) == int(want.num_active_edges)
    np.testing.assert_array_equal(to_np(edge_active_flat(got)),
                                  np.asarray(jedge_active_flat(want)))
    np.testing.assert_array_equal(to_np(got.block_live), np.asarray(want.block_live))
    # the op leaves dirty as it was
    jop = jfilter_pack(jg, jf, jnp.asarray(subset), jnp.asarray(keep2), interpret=True)
    op = filter_pack(g, f, torch.from_numpy(subset), torch.from_numpy(keep2))
    _assert_filter_equal(op, jop)
    assert torch.equal(op.dirty, f.dirty)
    # filterEdges over every vertex, by mask and by predicate
    jf2, jrem = jfilter_edges(jg, jf, jnp.asarray(keep2).reshape(jg.num_blocks, -1))
    f2, rem = filter_edges(g, f, torch.from_numpy(keep2).reshape(g.num_blocks, -1))
    _assert_filter_equal(f2, jf2)
    assert int(rem) == int(jrem)

    def jpred(s, d, w):
        return (s + d) % 3 != 0

    jf3, jrem3 = jfilter_edges_pred(jg, jf, jpred)
    f3, rem3 = filter_edges_pred(g, f, jpred)
    _assert_filter_equal(f3, jf3)
    assert int(rem3) == int(jrem3)
    jidx, jcount = jlive_block_indices(jf3)
    idx, count = live_block_indices(f3)
    assert count == int(jcount)
    np.testing.assert_array_equal(to_np(idx), np.asarray(jidx))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_filter_carry_over_round_trip(name):
    jg, g = _graph(name)
    keep, subset = _predicates(jg)
    jf = jpack_vertices(jg, jmake_filter(jg), jnp.asarray(subset), jnp.asarray(keep))
    f = _port_filter(jf)
    _assert_filter_equal(f, jf)
    arrays, meta = filter_to_reference_arrays(f)
    assert arrays["bits"].dtype == np.uint32
    back = JGraphFilter(**{k: jnp.asarray(v) for k, v in arrays.items()}, **meta)
    for k in ("bits", "active_deg", "dirty"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(jf, k)))
    _assert_filter_equal(make_filter(g), jmake_filter(jg))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_charge_filter_pack_matches(name):
    jg, g = _graph(name)
    want, got = JPSAMCost(), PSAMCost(registry=Registry())
    for blocks in (0, 1, jg.num_blocks):
        want.charge_filter_pack(jg, blocks)
        got.charge_filter_pack(g, blocks)
    assert (got.large_reads, got.small_ops, got.large_writes) == (
        want.large_reads, want.small_ops, want.large_writes)
    assert got.large_writes == 0
    c = got.registry.get("sage_psam_large_read_words_total")
    assert c.value(charge="filter_pack") == got.large_reads


# ----------------------------------------------------------------------
# the eight algorithms against the JAX package
# ----------------------------------------------------------------------
KEY = jax.random.PRNGKey(3)


def _perm(n):
    return torch.from_numpy(np.array(jax.random.permutation(KEY, jnp.arange(n, dtype=jnp.int32))))


def _sets(n):
    return np.arange(n) < n // 3


ALGORITHMS = {
    "mis": (lambda jg: J.mis(jg, KEY), lambda g: T.mis(g, priorities=_perm(g.n))),
    "maximal_matching": (lambda jg: J.maximal_matching(jg, KEY), T.maximal_matching),
    "coloring": (J.coloring, T.coloring),
    "set_cover": (lambda jg: J.set_cover(jg, jnp.asarray(_sets(jg.n)), KEY),
                  lambda g: T.set_cover(g, torch.from_numpy(_sets(g.n)),
                                        priorities=_perm(g.n))),
    "kcore": (J.kcore, T.kcore),
    "densest_subgraph": (J.densest_subgraph, T.densest_subgraph),
    "triangle_count": (J.triangle_count, T.triangle_count),
    "orientation_filter": (J.orientation_filter, T.orientation_filter),
}


def _assert_same(got, want):
    if isinstance(want, tuple):
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, JGraphFilter):
        _assert_filter_equal(got, want)
    elif isinstance(want, int):
        assert got == want
    else:
        w = np.asarray(want)
        g = to_np(got)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert g.tobytes() == w.tobytes()   # float32 bit for bit


@pytest.mark.parametrize("algorithm", list(ALGORITHMS))
@pytest.mark.parametrize("name", ["csr32", "compressed64", "csr128"])
def test_algorithm_matches_reference(algorithm, name):
    jg, g = _graph(name)
    jfn, fn = ALGORITHMS[algorithm]
    _assert_same(fn(g), jfn(jg))


@pytest.mark.parametrize("algorithm", ["maximal_matching", "set_cover", "coloring"])
def test_filter_algorithms_on_exception_graph(algorithm):
    jg, g = _graph("exceptions")
    assert jg.n_exceptions > 0
    jfn, fn = ALGORITHMS[algorithm]
    before = filter_pack_words.launches
    _assert_same(fn(g), jfn(jg))
    assert filter_pack_words.launches == before  # the CPU route launches nothing


def test_mis_and_set_cover_draw_from_a_generator():
    _, g = _graph("csr32")
    a = T.mis(g, torch.Generator().manual_seed(1))
    b = T.mis(g, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and bool(a.any())
    sets = torch.from_numpy(_sets(g.n))
    c = T.set_cover(g, sets, torch.Generator().manual_seed(2))
    assert not bool((c & ~sets).any())
    with pytest.raises(ValueError, match="priorities"):
        T.mis(g, priorities=torch.arange(g.n - 1))
