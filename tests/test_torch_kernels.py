"""Port parity for the graph kernels: the frontier-sparse and the whole-graph
compressed-block kernels, the uncompressed-block kernel, and their ops.

On the CPU a kernel wrapper runs its plain PyTorch version, which is held
here to the JAX package's Pallas kernel (``interpret=True``) and to its
plain-jnp oracle.  decode and int32 sums are compared exactly; float sums
within rtol 1e-5, because PyTorch and XLA add the slots of a block in
different orders.  The CUDA kernels themselves are held to the plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import make_filter as jmake_filter
from repro.data import rmat_graph as jrmat_graph
from repro.kernels import compressed_chunked_stream_tile as jstream_tile
from repro.kernels import compressed_spmv_vertex as jcompressed_spmv_vertex
from repro.kernels import compressed_spmv_vertex_batched as jcompressed_spmv_vertex_batched
from repro.kernels import spmv_vertex as jspmv_vertex
from repro.kernels import spmv_vertex_batched as jspmv_vertex_batched
from repro.kernels.compressed_spmv.compressed_spmv import (
    compressed_block_spmv_pallas,
    compressed_chunked_spmv_pallas,
)
from repro.kernels.compressed_spmv.ref import compressed_block_spmv_ref as jblock_oracle
from repro.kernels.compressed_spmv.ref import compressed_chunked_spmv_ref as joracle
from repro.kernels.edge_block_spmv.edge_block_spmv import edge_block_spmv_pallas
from repro.kernels.edge_block_spmv.ref import edge_block_spmv_ref as jedge_oracle
from repro.kernels.edge_block_spmv.ref import spmv_vertex_ref as jspmv_oracle
from repro_torch.core import build_csr, make_filter
from repro_torch.kernels import (
    compressed_block_spmv,
    compressed_chunked_spmv,
    compressed_chunked_spmv_ref,
    compressed_chunked_stream_tile,
    compressed_spmv_vertex,
    compressed_spmv_vertex_batched,
    compressed_spmv_vertex_chunked,
    compressed_spmv_vertex_ref,
    edge_block_spmv,
    real_slot_counts,
    spmv_vertex,
    spmv_vertex_batched,
    spmv_vertex_ref,
)
from torch_parity import port_graph, to_np

SUM_RTOL = 1e-5  # float sums: the slots of a block are added in another order


def _wide_graph(weighted):
    """Exception blocks: several ≥2¹⁶ gaps, a few blocks of 32 slots."""
    rng = np.random.default_rng(1)
    src = np.concatenate([np.zeros(40, np.int64), np.ones(6, np.int64),
                          rng.integers(2, 64, 120)])
    dst = np.concatenate([np.sort(rng.choice(70000, 40, replace=False)),
                          [3, 5, 66000, 66001, 69000, 69999], rng.integers(0, 64, 120)])
    w = rng.integers(1, 9, src.shape[0]).astype(np.float32) if weighted else None
    return jbuild_csr(70000, src, dst, w, block_size=32)


def _graphs():
    return {
        "rmat32": lambda w: jrmat_graph(256, 2048, weighted=w, seed=3, block_size=32),
        "rmat64": lambda w: jrmat_graph(512, 4096, weighted=w, seed=8, block_size=64),
        "wide": _wide_graph,
    }


GRAPHS = _graphs()


def _setup(name, weighted, seed=0):
    jc = jcompress(GRAPHS[name](weighted))
    c = port_graph(jc)
    rng = np.random.default_rng(seed)
    NB, FB = c.num_blocks, c.block_size
    live = rng.permutation(NB)[: max(1, (2 * NB) // 3)]
    ids = np.concatenate([live, [NB, NB + 7]]).astype(np.int32)   # padded chunk
    active = rng.integers(0, 2**32, (NB, FB // 32), dtype=np.uint32)
    return jc, c, ids, active


def _t_words(a):
    return torch.from_numpy(a.view(np.int32).copy())


CASES = [  # (graph, weighted, with edge_active)
    ("rmat32", False, False), ("rmat32", True, True), ("rmat64", True, False),
    ("rmat64", False, True), ("wide", True, True), ("wide", False, False),
]


@pytest.mark.parametrize("name,weighted,with_active", CASES)
def test_decode_matches_pallas_interpret(name, weighted, with_active):
    jc, c, ids, active = _setup(name, weighted)
    act_j = jnp.asarray(active) if with_active else None
    act_t = _t_words(active) if with_active else None
    want_d, want_w = compressed_chunked_spmv_pallas(
        None, jnp.asarray(ids), jc.block_first, jc.deltas, jc.valid_count, None, act_j,
        jc.block_weights if weighted else None, n=jc.n, emit="decode", interpret=True,
    )
    got_d, got_w = compressed_chunked_spmv(
        None, torch.from_numpy(ids), c.block_first, c.deltas, c.valid_count, None, act_t,
        c.block_weights, n=c.n, emit="decode",
    )
    np.testing.assert_array_equal(to_np(got_d), np.asarray(want_d))
    np.testing.assert_array_equal(to_np(got_w), np.asarray(want_w))  # pad rows: 0.0
    if weighted:
        assert (to_np(got_w)[-2:] == 0.0).all()


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("name,weighted,with_active", CASES[:4])
def test_sums_match_pallas_interpret(name, weighted, with_active, batch):
    jc, c, ids, active = _setup(name, weighted, seed=2)
    rng = np.random.default_rng(5)
    x = rng.random((batch, c.n) if batch else c.n).astype(np.float32)
    bits_j = jmake_filter(jc).bits
    act_j = jnp.asarray(active) if with_active else None
    want = compressed_chunked_spmv_pallas(
        jnp.asarray(x), jnp.asarray(ids), jc.block_first, jc.deltas, jc.valid_count,
        bits_j, act_j, jc.block_weights if weighted else None, n=jc.n, emit="sums",
        interpret=True,
    )
    got = compressed_chunked_spmv(
        torch.from_numpy(x), torch.from_numpy(ids), c.block_first, c.deltas,
        c.valid_count, make_filter(c).bits, _t_words(active) if with_active else None,
        c.block_weights, n=c.n, emit="sums",
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=SUM_RTOL, atol=1e-6)


def test_int_sums_are_exact():
    jc, c, ids, active = _setup("rmat32", False, seed=4)
    x = np.random.default_rng(0).integers(-50, 50, (2, c.n)).astype(np.int32)
    want = compressed_chunked_spmv_pallas(
        jnp.asarray(x), jnp.asarray(ids), jc.block_first, jc.deltas, jc.valid_count,
        jmake_filter(jc).bits, jnp.asarray(active), n=jc.n, emit="sums", interpret=True,
    )
    got = compressed_chunked_spmv_ref(
        torch.from_numpy(x), torch.from_numpy(ids), c.block_first, c.deltas,
        c.valid_count, make_filter(c).bits, _t_words(active), n=c.n, emit="sums",
    )
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("weighted,with_active", [(False, False), (True, True)])
def test_stream_tile_patches_exceptions(weighted, with_active):
    jc, c, ids, active = _setup("wide", weighted, seed=6)
    assert c.n_exceptions > 0
    ids = np.concatenate([np.arange(c.num_blocks), [c.num_blocks]]).astype(np.int32)
    want_d, want_w = jstream_tile(
        jc, jnp.asarray(ids), jnp.asarray(active) if with_active else None, interpret=True
    )
    got_d, got_w = compressed_chunked_stream_tile(
        c, torch.from_numpy(ids), _t_words(active) if with_active else None
    )
    np.testing.assert_array_equal(to_np(got_d), np.asarray(want_d))
    np.testing.assert_array_equal(to_np(got_w), np.asarray(want_w))


@pytest.mark.parametrize("name,weighted", [("rmat32", True), ("wide", True), ("rmat64", False)])
@pytest.mark.parametrize("batch", [None, 2])
def test_vertex_chunked_matches_oracle(name, weighted, batch):
    jc, c, _, active = _setup(name, weighted, seed=7)
    rng = np.random.default_rng(9)
    frontier = rng.random(c.n) < 0.3
    x = rng.random((batch, c.n) if batch else c.n).astype(np.float32)
    want = joracle(jc, jnp.asarray(x), jnp.asarray(frontier), jmake_filter(jc).bits,
                   jc.block_weights if weighted else None, jnp.asarray(active))
    got = compressed_spmv_vertex_chunked(
        c, torch.from_numpy(x), torch.from_numpy(frontier), edge_active=_t_words(active),
    )
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=SUM_RTOL, atol=1e-5)


def test_exception_dense_vertex_chunked_matches_oracle():
    """Past the exception limit the exact plain decode replaces the kernel."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, 400, 3000)  # ~8 targets over 2^20 ids: wide gaps
    dst = rng.integers(0, 1 << 20, 3000)
    jc = jcompress(jbuild_csr(1 << 20, src, dst, block_size=32))
    c = port_graph(jc)
    assert c.n_exceptions > 16 and c.n_exceptions > c.num_blocks // 4
    frontier = np.zeros(c.n, bool)
    frontier[:20] = True
    x = rng.random(c.n).astype(np.float32)
    want = joracle(jc, jnp.asarray(x), jnp.asarray(frontier), jmake_filter(jc).bits)
    got = compressed_spmv_vertex_chunked(c, torch.from_numpy(x), torch.from_numpy(frontier))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=SUM_RTOL, atol=1e-5)


# ----------------------------------------------------------------------
# The whole-graph kernels: compressed_block_spmv and edge_block_spmv
# ----------------------------------------------------------------------
WHOLE_CASES = [  # (graph, weighted, with edge_active, batch, tile_blocks)
    ("rmat32", False, False, None, 4), ("rmat32", True, True, 3, 8),
    ("rmat64", True, False, 2, 16), ("rmat64", False, True, None, 8),
    ("wide", True, True, None, 16), ("wide", False, False, 2, 4),
]


def _whole_inputs(name, weighted, with_active, batch, dtype=np.float32, seed=11):
    jg = GRAPHS[name](weighted)
    rng = np.random.default_rng(seed)
    NB, FB = jg.num_blocks, jg.block_size
    active = rng.integers(0, 2**32, (NB, FB // 32), dtype=np.uint32) if with_active else None
    shape = (batch, jg.n) if batch else (jg.n,)
    if dtype == np.int32:
        x = rng.integers(-50, 50, shape).astype(np.int32)
    else:
        x = rng.random(shape).astype(np.float32)
    return jg, active, x


def _jax_x(x, weighted):
    """The JAX package's input for the port's ``x``: int32 state against
    float weights is summed in float32 and truncated to int32 by the port,
    while the Pallas kernels refuse it, so JAX gets the same values as
    float32 (exact for these small integers) and the sums must be equal."""
    return jnp.asarray(x.astype(np.float32) if x.dtype == np.int32 and weighted else x)


def _close(got, want, exact):
    assert tuple(got.shape) == tuple(np.shape(want))
    if exact:
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    else:
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=SUM_RTOL, atol=1e-6)


def _opt(a, conv):
    return None if a is None else conv(a)


@pytest.mark.parametrize("name,weighted,with_active,batch,tb", WHOLE_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_block_spmv_matches_pallas_interpret(name, weighted, with_active, batch, tb, dtype):
    """The plain version of kernel 2 against the Pallas kernel, ESCAPE blocks
    decoded wrong on purpose by both; against the exact oracle where the
    graph has no exceptions."""
    jg, active, x = _whole_inputs(name, weighted, with_active, batch, dtype)
    jc = jcompress(jg)
    c = port_graph(jc)
    if name == "wide":
        assert c.n_exceptions > 0 and c.num_blocks % tb  # a ragged last tile
    bits_j, bits_t = jmake_filter(jc).bits, make_filter(c).bits
    w_j = jc.block_weights if weighted else None
    want = compressed_block_spmv_pallas(
        _jax_x(x, weighted), jc.block_first, jc.deltas, jc.valid_count, bits_j,
        _opt(active, jnp.asarray), w_j, n=jc.n, tile_blocks=tb, interpret=True,
    )
    got = compressed_block_spmv(
        torch.from_numpy(x), c.block_first, c.deltas, c.valid_count, bits_t,
        _opt(active, _t_words), c.block_weights, n=c.n, tile_blocks=tb,
    )
    _close(got, want, dtype == np.int32)
    if not c.n_exceptions:
        want = jblock_oracle(jc, _jax_x(x, weighted), bits_j, w_j, _opt(active, jnp.asarray))
        _close(got, want, dtype == np.int32)


def _planted_past_count(jc):
    """``jc`` with every slot at or past its block's valid count holding an
    ESCAPE delta (0xFFFF) and, when weighted, a NaN weight."""
    vc = np.asarray(jc.valid_count).astype(np.int64)
    past = np.arange(jc.block_size)[None, :] >= vc[:, None]
    assert past.any()
    deltas = jnp.asarray(np.where(past, np.uint16(0xFFFF), np.asarray(jc.deltas)))
    if jc.block_weights is None:
        return dataclasses.replace(jc, deltas=deltas)
    w = np.where(past, np.float32(np.nan), np.asarray(jc.block_weights))
    return dataclasses.replace(jc, deltas=deltas, block_weights=jnp.asarray(w))


@pytest.mark.parametrize("name,weighted,with_active,batch,tb", WHOLE_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_block_spmv_ignores_slots_past_valid_count(name, weighted, with_active, batch, tb,
                                                   dtype):
    """Kernel 2's plain version and the Pallas kernel give the sums of the
    clean graph whatever lies past each block's valid count: garbage deltas
    (0xFFFF) and NaN weights there reach no sum."""
    jg, active, x = _whole_inputs(name, weighted, with_active, batch, dtype, seed=12)
    jc = jcompress(jg)
    jp = _planted_past_count(jc)
    c, cp = port_graph(jc), port_graph(jp)
    bits_j, bits_t = jmake_filter(jc).bits, make_filter(c).bits
    act_t = _opt(active, _t_words)
    want = compressed_block_spmv_pallas(
        _jax_x(x, weighted), jp.block_first, jp.deltas, jp.valid_count, bits_j,
        _opt(active, jnp.asarray), jp.block_weights, n=jp.n, tile_blocks=tb, interpret=True,
    )
    got = compressed_block_spmv(torch.from_numpy(x), cp.block_first, cp.deltas,
                                cp.valid_count, bits_t, act_t, cp.block_weights, n=cp.n,
                                tile_blocks=tb)
    clean = compressed_block_spmv(torch.from_numpy(x), c.block_first, c.deltas, c.valid_count,
                                  bits_t, act_t, c.block_weights, n=c.n, tile_blocks=tb)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want, dtype == np.int32)
    _close(got, to_np(clean), True)


@pytest.mark.parametrize("name,weighted,with_active,batch,tb", WHOLE_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("owners", [False, True])
def test_edge_block_spmv_matches_pallas_interpret(name, weighted, with_active, batch, tb,
                                                  dtype, owners):
    jg, active, x = _whole_inputs(name, weighted, with_active, batch, dtype)
    g = port_graph(jg)
    bits_j, bits_t = jmake_filter(jg).bits, make_filter(g).bits
    act_j, act_t = _opt(active, jnp.asarray), _opt(active, _t_words)
    xj = _jax_x(x, True)  # the uncompressed kernel always multiplies by block_w
    want = edge_block_spmv_pallas(xj, jg.block_dst, jg.block_w, bits_j, act_j,
                                  n=jg.n, tile_blocks=tb, interpret=True)
    own = (g.block_src, g.block_offsets, g.degrees) if owners else None
    got = edge_block_spmv(torch.from_numpy(x), g.block_dst, g.block_w, bits_t, act_t, n=g.n,
                          tile_blocks=tb, owners=own)
    _close(got, want, dtype == np.int32)
    _close(got, jedge_oracle(xj, jg.block_dst, jg.block_w, bits_j, act_j, n=jg.n),
           dtype == np.int32)
    want = jspmv_oracle(xj, jg.block_dst, jg.block_w, bits_j, jg.block_src, act_j,
                        n=jg.n)
    _close(spmv_vertex_ref(torch.from_numpy(x), g.block_dst, g.block_w, bits_t, g.block_src,
                           act_t, n=g.n), want, dtype == np.int32)


def _dense_exception_graph(weighted):
    """Every block holds a ≥2¹⁶ gap: far past the exception limit."""
    rng = np.random.default_rng(3)
    v = np.arange(300)
    src = np.concatenate([v, v])
    dst = np.concatenate([1000 + v, 67000 + v])
    w = rng.integers(1, 9, src.shape[0]).astype(np.float32) if weighted else None
    return jbuild_csr(70000, src, dst, w, block_size=32)


OPS_CASES = [  # (graph, weighted, with edge_active, batch)
    ("rmat32", True, False, None), ("rmat64", False, True, 3),
    ("wide", True, True, 2), ("wide", False, False, None),
    ("dense_exc", True, True, None), ("dense_exc", False, False, 2),
]


@pytest.mark.parametrize("name,weighted,with_active,batch", OPS_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_compressed_spmv_vertex_matches_jax(name, weighted, with_active, batch, dtype):
    """The patched whole-graph op: exceptions under the limit are patched,
    an exception-dense graph takes the exact plain decode, as in JAX."""
    if name == "dense_exc":
        jg = _dense_exception_graph(weighted)
        rng = np.random.default_rng(4)
        active = (rng.integers(0, 2**32, (jg.num_blocks, 1), dtype=np.uint32)
                  if with_active else None)
        shape = (batch, jg.n) if batch else (jg.n,)
        x = (rng.integers(-50, 50, shape).astype(np.int32) if dtype == np.int32
             else rng.random(shape).astype(np.float32))
    else:
        jg, active, x = _whole_inputs(name, weighted, with_active, batch, dtype, seed=5)
    jc = jcompress(jg)
    c = port_graph(jc)
    if name == "dense_exc":
        assert c.n_exceptions > max(16, c.num_blocks // 4)
    elif name == "wide":
        assert 0 < c.n_exceptions <= 16
    jfn = jcompressed_spmv_vertex_batched if batch else jcompressed_spmv_vertex
    fn = compressed_spmv_vertex_batched if batch else compressed_spmv_vertex
    want = jfn(jc, _jax_x(x, weighted), edge_active=_opt(active, jnp.asarray), interpret=True)
    got = fn(c, torch.from_numpy(x), edge_active=_opt(active, _t_words))
    _close(got, want, dtype == np.int32)
    oracle = compressed_spmv_vertex_ref(c, torch.from_numpy(x), make_filter(c).bits,
                                        c.block_weights, _opt(active, _t_words))
    _close(oracle, want, dtype == np.int32)


@pytest.mark.parametrize("name,weighted,with_active,batch", OPS_CASES[:4])
@pytest.mark.parametrize("with_filter", [False, True])
def test_spmv_vertex_matches_jax(name, weighted, with_active, batch, with_filter):
    """The op passes the owner arrays to the kernel, and no filter words
    when it is given no filter; with one, its words.  Both equal JAX."""
    jg, active, x = _whole_inputs(name, weighted, with_active, batch, np.int32, seed=6)
    g = port_graph(jg)
    jfn = jspmv_vertex_batched if batch else jspmv_vertex
    fn = spmv_vertex_batched if batch else spmv_vertex
    jf, f = (jmake_filter(jg), make_filter(g)) if with_filter else (None, None)
    want = jfn(jg, _jax_x(x, True), jf, edge_active=_opt(active, jnp.asarray), interpret=True)
    got = fn(g, torch.from_numpy(x), f, edge_active=_opt(active, _t_words))
    _close(got, want, True)
    xf = np.random.default_rng(7).random(x.shape).astype(np.float32)
    want = jfn(jg, jnp.asarray(xf), interpret=True, tile_blocks=16)
    _close(fn(g, torch.from_numpy(xf), tile_blocks=16), want, False)
    if batch:  # every lane equals its own single-query run
        for q in range(batch):
            np.testing.assert_array_equal(
                to_np(got[q]), to_np(spmv_vertex(g, torch.from_numpy(x[q]),
                                                 edge_active=_opt(active, _t_words))))


def _count_graph(source, fb):
    """An R-MAT graph at block size ``fb`` with, planted beside it, vertex
    700 of degree exactly 2·fb, vertex 701 of degree fb + 1 and isolated
    vertices 702..799: built by the JAX package and carried over, or built
    by the port."""
    rng = np.random.default_rng(fb)
    n = 800
    src = np.concatenate([rng.integers(0, 600, 6000), np.full(2 * fb, 700),
                          np.full(fb + 1, 701)])
    dst = np.concatenate([rng.integers(0, 600, 6000), np.arange(2 * fb), np.arange(fb + 1)])
    if source == "jax":
        return port_graph(jbuild_csr(n, src, dst, block_size=fb))
    return build_csr(n, src, dst, block_size=fb, device="cpu")


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("fb", [32, 64, 128, "edgeless"])
def test_real_slot_counts_are_the_real_slots(source, fb):
    """The count kernel 3 derives from ``block_src``, ``block_offsets`` and
    ``degrees`` is ``(block_dst < n).sum(1)``: every slot before it real,
    every slot from it on the sentinel n."""
    if fb == "edgeless":
        e = np.zeros(0, np.int64)
        g = (port_graph(jbuild_csr(5, e, e, block_size=32)) if source == "jax"
             else build_csr(5, e, e, block_size=32, device="cpu"))
        assert g.num_blocks == 1 and int(g.block_src[0]) == g.n  # the dummy block
    else:
        g = _count_graph(source, fb)
        deg = to_np(g.degrees)
        assert deg[700] == 2 * fb and deg[701] == fb + 1 and (deg[702:] == 0).all()
        assert (deg[:600] > 0).all() and (deg[:600] % fb == 0).sum() == 0
    cnt = real_slot_counts(g.block_src, g.block_offsets, g.degrees, n=g.n,
                           block_size=g.block_size)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(to_np(cnt), to_np((g.block_dst < g.n).sum(1)))
    slot = torch.arange(g.block_size)[None, :]
    before = slot < cnt[:, None].long()
    assert bool((g.block_dst[before] < g.n).all())
    assert bool((g.block_dst[~before] == g.n).all())
    if fb != "edgeless":
        full = to_np(g.block_offsets)[700]
        assert to_np(cnt)[full:full + 2].tolist() == [fb, fb]          # degree 2·fb
        full = to_np(g.block_offsets)[701]
        assert to_np(cnt)[full:full + 2].tolist() == [fb, 1]           # degree fb + 1


def test_whole_graph_kernels_reject_bad_tiles():
    jc, c, _, _ = _setup("rmat32", False)
    x = torch.zeros(c.n)
    for tb in (0, 33):
        with pytest.raises(ValueError, match="tile_blocks"):
            compressed_block_spmv(x, c.block_first, c.deltas, c.valid_count, None, n=c.n,
                                  tile_blocks=tb)


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    source = tmp_path / "k.cu"
    source.write_text("// a kernel")
    assert build.resource_usage(source) == {}
    build._library_path(source).with_suffix(".ptxas").write_text(
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers, 8 bytes cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n")
    assert build.resource_usage(source) == {"_Z1aPf": (32, 8), "_Z1bPf": (40, 0)}
