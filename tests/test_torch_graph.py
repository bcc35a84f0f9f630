"""Port parity for graph construction, compression, filters and the
converter, plus the guards of the port's package boundary.

Every comparison here is exact: the arrays are integers, bit-views or
weights copied without arithmetic.
"""
import importlib
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import build_csr as jbuild_csr
from repro.core import compress as jcompress
from repro.core import make_filter as jmake_filter
from repro.core.compressed import decode_block_tile as jdecode_block_tile
from repro.core.compressed import decode_blocks as jdecode_blocks
from repro.core.compressed import exception_dense as jexception_dense
from repro.data import rmat_graph as jrmat_graph
from repro.data.rmat import rmat_edges as jrmat_edges
from repro_torch.core import (
    build_csr,
    compress,
    decode_block_tile,
    decode_blocks,
    exception_dense,
    from_reference_arrays,
    make_filter,
    pack_bits,
    to_reference_arrays,
    unpack_word_bits,
)
from repro_torch.data import rmat_graph, rmat_edges
from torch_parity import CPU, port_graph, to_np, words_u32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CSR_FIELDS = ("offsets", "block_offsets", "block_src", "edge_src", "edge_dst", "edge_w",
              "degrees")
CMP_FIELDS = ("block_first", "deltas", "valid_count", "exc_block", "exc_slot",
              "exc_value", "block_src", "degrees")


def _wide_edges():
    """A graph whose encoding needs the ≥2¹⁶-delta COO exception path."""
    src = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.int64)
    dst = np.array([1, 2, 66000, 66001, 69998, 69999, 3, 69000], np.int64)
    return 70000, src, dst


def _edge_cases():
    """(n, src, dst, w, block_size) graphs covering padding, weights and
    exceptions, each small enough for an exact array comparison."""
    rng = np.random.default_rng(3)
    n, s, d = _wide_edges()
    w = np.arange(1, 9, dtype=np.float32)
    return {
        "rmat": (256, *jrmat_edges(256, 2048, seed=1), None, 32),
        "rmat_w64": (512, *jrmat_edges(512, 4096, seed=2), rng.integers(1, 9, 4096)
                     .astype(np.float32), 64),
        "two_edges_70000": (70000, np.array([0, 0]), np.array([1, 69999]), None, 32),
        "wide_weighted": (n, s, d, w, 32),
        "empty": (5, np.zeros(0, np.int64), np.zeros(0, np.int64), None, 32),
    }


CASES = _edge_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_csr_and_compress_arrays_match(case):
    n, src, dst, w, fb = CASES[case]
    jg = jbuild_csr(n, src, dst, w, block_size=fb, symmetrize=True)
    g = build_csr(n, src, dst, w, block_size=fb, symmetrize=True, device=CPU)
    kind, arrays, meta = to_reference_arrays(g)
    assert kind == "csr"
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jg, f)), err_msg=f)
        assert arrays[f].dtype == np.asarray(getattr(jg, f)).dtype, f
    assert meta == {k: getattr(jg, k) for k in meta}

    jc, c = jcompress(jg), compress(g)
    kind, arrays, meta = to_reference_arrays(c)
    assert kind == "compressed"
    for f in CMP_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jc, f)), err_msg=f)
        assert arrays[f].dtype == np.asarray(getattr(jc, f)).dtype, f
    if jg.weighted:
        np.testing.assert_array_equal(arrays["block_weights"], np.asarray(jc.block_weights))
    else:
        assert c.block_weights is None and jc.block_weights is None
    assert meta == {k: getattr(jc, k) for k in meta}
    assert c.compressed_bytes == jc.compressed_bytes
    assert exception_dense(c) == jexception_dense(jc)
    np.testing.assert_array_equal(to_np(decode_blocks(c)), np.asarray(jdecode_blocks(jc)))
    np.testing.assert_array_equal(to_np(c.edge_valid), np.asarray(jc.edge_valid))
    np.testing.assert_array_equal(to_np(c.edge_src), np.asarray(jc.edge_src))


def test_exception_graph_under_the_limit():
    """The wide graph takes the exception path without being exception-dense."""
    n, s, d = _wide_edges()
    c = compress(build_csr(n, s, d, block_size=32, device=CPU))
    assert 0 < c.n_exceptions <= 16 and not exception_dense(c)


@pytest.mark.parametrize("case", ["rmat", "wide_weighted"])
def test_decode_block_tile_with_pad_matches(case):
    n, src, dst, w, fb = CASES[case]
    jc = jcompress(jbuild_csr(n, src, dst, w, block_size=fb, symmetrize=True))
    c = port_graph(jc)
    NB = c.num_blocks
    rng = np.random.default_rng(0)
    ids = np.concatenate([rng.permutation(NB)[: max(1, NB // 2)], [NB, NB, NB + 3]])
    got = decode_block_tile(c, torch.as_tensor(ids))
    want = jdecode_block_tile(jc, jnp.asarray(ids, jnp.int32))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_rmat_edge_lists_and_graph_match():
    for n, m, seed in ((256, 1024, 0), (1024, 4096, 5)):
        js, jd = jrmat_edges(n, m, seed=seed)
        s, d = rmat_edges(n, m, seed=seed)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(d, jd)
    jg = jrmat_graph(256, 2048, weighted=True, seed=4, block_size=64)
    g = rmat_graph(256, 2048, weighted=True, seed=4, block_size=64, device=CPU)
    _, arrays, _ = to_reference_arrays(g)
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jg, f)), err_msg=f)


@pytest.mark.parametrize("compressed", [False, True])
def test_converter_round_trip(compressed):
    n, src, dst, w, fb = CASES["wide_weighted"]
    jg = jbuild_csr(n, src, dst, w, block_size=fb)
    jg = jcompress(jg) if compressed else jg
    g = port_graph(jg)
    kind, arrays, meta = to_reference_arrays(g)
    assert kind == ("compressed" if compressed else "csr")
    for f, a in arrays.items():
        ref = getattr(jg, f)
        np.testing.assert_array_equal(a, np.asarray(ref), err_msg=f)
        assert a.dtype == np.asarray(ref).dtype, f
    again = from_reference_arrays(kind, arrays, meta, CPU)
    for f, a in to_reference_arrays(again)[1].items():
        np.testing.assert_array_equal(a, arrays[f], err_msg=f)
    if compressed:
        assert g.deltas.dtype == torch.int16 and g.deltas.element_size() == 2


@pytest.mark.parametrize("fb", [32, 64])
def test_filter_words_match(fb):
    jg = jrmat_graph(256, 2048, seed=6, block_size=fb)
    jf = jmake_filter(jcompress(jg))
    f = make_filter(compress(port_graph(jg)))
    np.testing.assert_array_equal(words_u32(f.bits), np.asarray(jf.bits))
    np.testing.assert_array_equal(to_np(f.active_deg), np.asarray(jf.active_deg))
    rng = np.random.default_rng(fb)
    mask = torch.as_tensor(rng.random((7, fb)) < 0.5)
    assert torch.equal(unpack_word_bits(pack_bits(mask)), mask)


# ----------------------------------------------------------------------
# Guards of the package boundary
# ----------------------------------------------------------------------
def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k in ('jax', 'repro') or "
        "k.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('repro_torch')))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"}, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(r.stdout.split())
    assert len(loaded) > 20
    assert {
        "repro_torch.kernels.edge_block_spmv.ops",
        "repro_torch.kernels.compressed_spmv.ops",
        "repro_torch.tuning.measure",
        "repro_torch.tuning.table",
        "repro_torch.tuning.__main__",
        "repro_torch.kernels.filter_pack.ops",
        "repro_torch.algorithms.covering",
        "repro_torch.algorithms.substructure",
    } <= loaded


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_csr(4, np.array([0]), np.array([1]), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_csr(4, np.array([0]), np.array([1]))  # the default is the card


def test_cpu_tensor_never_reaches_the_build(monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels.compressed_spmv import compressed_spmv as mod

    def refuse(*a, **k):
        raise AssertionError("the CPU route reached the kernel build")

    # the package exports a function of the module's name: take the module
    emod = importlib.import_module("repro_torch.kernels.edge_block_spmv.edge_block_spmv")

    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(mod, "load_library", refuse)
    monkeypatch.setattr(emod, "load_library", refuse)
    g = rmat_graph(64, 256, seed=0, block_size=32, device=CPU)
    c = compress(g)
    counts = (mod.compressed_chunked_spmv.launches, mod.compressed_block_spmv.launches,
              emod.edge_block_spmv.launches)
    ids = torch.arange(3, dtype=torch.int32)
    dst, w = mod.compressed_chunked_spmv(
        None, ids, c.block_first, c.deltas, c.valid_count, n=c.n, emit="decode"
    )
    assert dst.shape == (3, 32) and w.shape == (3, 32)
    x = torch.rand(2, c.n)
    assert mod.compressed_block_spmv(x, c.block_first, c.deltas, c.valid_count, None,
                                     n=c.n).shape == (c.num_blocks, 2)
    assert emod.edge_block_spmv(x, g.block_dst, g.block_w, None, n=g.n).shape == (
        g.num_blocks, 2)
    assert (mod.compressed_chunked_spmv.launches, mod.compressed_block_spmv.launches,
            emod.edge_block_spmv.launches) == counts
