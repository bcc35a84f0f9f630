"""Port parity for the frontier-sparse compressed-block kernel.

On the CPU the kernel wrapper runs its plain PyTorch version, which is held
here to the JAX package's Pallas kernel (``interpret=True``) and to its
plain-jnp oracle.  decode is compared exactly; float sums within rtol 1e-5,
because PyTorch and XLA add the slots of a block in different orders.  The
CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import make_filter as jmake_filter
from repro.data import rmat_graph as jrmat_graph
from repro.kernels import compressed_chunked_stream_tile as jstream_tile
from repro.kernels.compressed_spmv.compressed_spmv import compressed_chunked_spmv_pallas
from repro.kernels.compressed_spmv.ref import compressed_chunked_spmv_ref as joracle
from repro_torch.core import compress, make_filter
from repro_torch.kernels import (
    compressed_chunked_spmv,
    compressed_chunked_spmv_ref,
    compressed_chunked_stream_tile,
    compressed_spmv_vertex_chunked,
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
