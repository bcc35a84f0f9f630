"""Port parity for SASRec's serving path: the EmbeddingBag kernel's CPU
route, ``take_rows``, SASRec's ``encode``/``serve_scores``/top-100 step/
``retrieval_scores`` at the smoke config, and the synthetic recsys data,
against the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU; SASRec's weights are the JAX package's ``init`` carried over with
``sasrec_params_from_reference``.  Tolerances, and why:

* float32, the same arithmetic in another order (XLA's and PyTorch's sums
  and products): rtol/atol 1e-5, for the bag sums and through SASRec's two
  blocks and catalog product alike.
* bfloat16 bag sums: the JAX kernel multiplies and sums in bfloat16, the
  port in float32 rounded once: 3e-2, the JAX sweep's own tolerance.
* ``take_rows`` against ``jnp.take(mode="fill")``: exactly (a row times 1).
* top-100 indices exactly, except at a near-tie: where the port picks
  another item, the JAX package's own score of that item must lie within
  twice the tolerance of its value at that rank.
"""
import dataclasses
import hashlib
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import sasrec as jconfig
from repro.data.recsys import make_sasrec_batch_fn as jmake_batch_fn
from repro.kernels.embedding_bag import embedding_bag as jembedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref as jembedding_bag_ref
from repro.models import sasrec as jsasrec
from repro_torch.configs import sasrec as config
from repro_torch.core.convert import sasrec_params_from_reference
from repro_torch.data import make_candidates, make_sasrec_batch_fn
from repro_torch.kernels import (
    bag_case,
    embedding_bag,
    embedding_bag_ref,
    embedding_bag_sums,
    take_rows,
)
from repro_torch.kernels.embedding_bag.embedding_bag import vector_bytes
from repro_torch.launch import assert_topk_agrees, sasrec_retrieval_step, sasrec_serve_step
from repro_torch.models import sasrec

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 3e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (V, D, B, L): the JAX sweep's three, SASRec's width, and rows of one element
BAG_SHAPES = [(50, 8, 16, 4), (100, 16, 37, 5), (200, 32, 64, 9), (300, 50, 20, 7),
              (64, 1, 33, 3)]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bag_case(V, D, B, L, seed):
    """``bag_case``'s float32 draws as numpy arrays, for both packages."""
    return tuple(t.numpy() for t in bag_case(V, D, B, L, torch.float32, seed))


# ---------------------------------------------------------------- kernel 5
@pytest.mark.parametrize("V,D,B,L", BAG_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_jax(V, D, B, L, dtype, mode):
    """The CPU route against the Pallas kernel (interpret mode on the CPU)."""
    table, idx, w = _bag_case(V, D, B, L, V + B)
    want = jembedding_bag(jnp.asarray(table).astype(JDT[dtype]), jnp.asarray(idx),
                          jnp.asarray(w).astype(JDT[dtype]), mode=mode)
    got = embedding_bag(torch.from_numpy(table).to(TDT[dtype]), torch.from_numpy(idx),
                        torch.from_numpy(w).to(TDT[dtype]), mode=mode)
    assert got.dtype == TDT[dtype] and got.shape == (B, D)
    assert np.isfinite(_np(got)).all()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("V,D,B,L", BAG_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_ref_matches_jax_ref(V, D, B, L, dtype):
    table, idx, w = _bag_case(V, D, B, L, 7 * V + B)
    want = jembedding_bag_ref(jnp.asarray(table).astype(JDT[dtype]), jnp.asarray(idx),
                              jnp.asarray(w).astype(JDT[dtype]))
    got = embedding_bag_ref(torch.from_numpy(table).to(TDT[dtype]), torch.from_numpy(idx),
                            torch.from_numpy(w).to(TDT[dtype]))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_embedding_bag_padding_adds_exactly_zero():
    """Padding slots and out-of-range ids add nothing, even with a NaN or
    an infinite weight; a bag of nothing but padding is zero; the mean
    counts the ids >= 0 (an id >= V adds nothing but counts)."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[1, -1, -7, 4], [-1, -1, -1, -1], [2, 9, 3, -2]], dtype=torch.int32)
    w = torch.tensor([[2.0, float("nan"), float("inf"), float("nan")], [1.0] * 4,
                      [1.0, float("nan"), 0.5, 1.0]])
    got = embedding_bag(table, idx, w)
    assert torch.equal(got, torch.stack([2 * table[1], torch.zeros(3),
                                         table[2] + 0.5 * table[3]]))
    mean = embedding_bag(table, idx, w, mode="mean")
    assert torch.equal(mean, got / torch.tensor([[2.0], [1.0], [3.0]]))
    assert torch.equal(embedding_bag(table, idx),
                       torch.tensor([[3.0, 4, 5], [0, 0, 0], [15, 17, 19]]))
    with pytest.raises(ValueError):
        embedding_bag(table, idx, mode="max")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bags_of_one_are_the_rows_exactly(dtype):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((97, 50)).astype(np.float32)).to(TDT[dtype])
    ids = torch.from_numpy(rng.integers(0, 97, (301, 1)).astype(np.int32))
    want = table[ids[:, 0].long()]
    assert torch.equal(embedding_bag_sums(table, ids, torch.ones(301, 1)), want)
    assert torch.equal(embedding_bag_sums(table, ids), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_matches_jnp_take(dtype):
    """Ids in each of the four ranges: [-V, -1] wraps, [0, V) reads, and
    below -V or from V on gives a zero row; exactly ``jnp.take``'s rows."""
    V = 6
    rng = np.random.default_rng(11)
    table = rng.standard_normal((V, 5)).astype(np.float32)
    ids = np.array([[-V - 3, -V - 1, -V, -V + 1, -1, 0],
                    [1, V - 1, V, V + 1, 4 * V, -3]], np.int32)
    want = jnp.take(jnp.asarray(table).astype(JDT[dtype]), jnp.asarray(ids), axis=0,
                    mode="fill", fill_value=0)
    got = take_rows(torch.from_numpy(table).to(TDT[dtype]), torch.from_numpy(ids))
    assert got.shape == (2, 6, 5) and got.dtype == TDT[dtype]
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(take_rows(torch.from_numpy(table).to(TDT[dtype]),
                                 torch.from_numpy(ids).long()), got)


def test_take_rows_int64_ids_out_of_int32_range_give_zero_rows():
    table = torch.arange(1.0, 13.0).reshape(4, 3)
    ids = torch.tensor([2**33, 2**32 + 1, -2**33, 3, -2**32 - 1])
    got = take_rows(table, ids)
    assert torch.equal(got, torch.stack([torch.zeros(3)] * 3 + [table[3], torch.zeros(3)]))


def test_vector_bytes_follow_the_row_and_the_addresses():
    assert vector_bytes(200, 4, 0, 512) == 8      # SASRec, float32
    assert vector_bytes(100, 2, 0, 512) == 4      # SASRec, bfloat16
    assert vector_bytes(256, 4, 0, 512) == 16     # kernels_micro's D=64
    assert vector_bytes(132, 4, 0, 512) == 4      # D=33, float32
    assert vector_bytes(66, 2, 0, 512) == 2       # D=33, bfloat16
    assert vector_bytes(256, 4, 8, 512) == 8      # a table view at an 8-byte offset
    with pytest.raises(ValueError):
        vector_bytes(8, 4, 2, 0)


def test_cpu_route_launches_nothing(monkeypatch):
    # the package exports a function of the module's name: take the module
    emod = importlib.import_module("repro_torch.kernels.embedding_bag.embedding_bag")

    def refuse(*a, **k):
        raise AssertionError("the CPU route reached the kernel build")

    monkeypatch.setattr(emod, "load_library", refuse)
    before = embedding_bag_sums.launches
    take_rows(torch.ones(4, 3), torch.tensor([[0, 5]]))
    embedding_bag(torch.ones(4, 3), torch.tensor([[0, -1]], dtype=torch.int32), mode="mean")
    assert embedding_bag_sums.launches == before


# ---------------------------------------------------------------- SASRec
def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke():
    cfg = config.smoke_config()
    jparams = jsasrec.init(jax.random.PRNGKey(0), jconfig.smoke_config())
    params = sasrec_params_from_reference(_numpy_tree(jparams), cfg, device=CPU)
    return cfg, jparams, params


def _batches():
    """SASRec batches as (JAX arrays, port tensors): ``smoke_batch(0)`` of
    both packages, and a JAX ``make_sasrec_batch_fn`` batch (padded
    prefixes) carried over."""
    jb = jconfig.smoke_batch(0)
    jb2 = jmake_batch_fn(jconfig.smoke_config().vocab, 4, 10)(3)
    jb2 = {**jb2, "candidates": jb["candidates"]}
    port2 = {k: torch.from_numpy(np.array(v)) for k, v in jb2.items()}
    return {"smoke_batch": (jb, config.smoke_batch(0, device=CPU)),
            "padded": (jb2, port2)}


@pytest.mark.parametrize("source", ["smoke_batch", "padded"])
def test_encode_matches_jax(smoke, source):
    cfg, jparams, params = smoke
    jb, b = _batches()[source]
    want = jsasrec.encode(jparams, jb["seq"], jconfig.smoke_config())
    got = sasrec.encode(params, b["seq"], cfg)
    assert got.shape == (4, cfg.seq_len, cfg.embed_dim)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("source", ["smoke_batch", "padded"])
def test_serve_scores_match_jax(smoke, source):
    cfg, jparams, params = smoke
    jb, b = _batches()[source]
    want = jsasrec.serve_scores(jparams, jb, jconfig.smoke_config())
    got = sasrec.serve_scores(params, b, cfg)
    assert got.shape == (4, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("source", ["smoke_batch", "padded"])
def test_serve_step_top100_matches_jax(smoke, source):
    cfg, jparams, params = smoke
    jb, b = _batches()[source]
    jscores = jsasrec.serve_scores(jparams, jb, jconfig.smoke_config())
    wv, wi = jax.lax.top_k(jscores, 100)
    got = sasrec_serve_step(params, b, cfg)
    assert got["values"].shape == (4, 100) and got["indices"].dtype == torch.int32
    want = {"values": torch.from_numpy(np.array(wv)), "indices": torch.from_numpy(np.array(wi))}
    assert_topk_agrees(got, want, torch.from_numpy(np.array(jscores)), F32_TOL)


def test_topk_check_rejects_a_swap_away_from_a_tie():
    scores = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0]])
    want = {"values": torch.tensor([[4.0, 3.0]]), "indices": torch.tensor([[0, 1]])}
    assert assert_topk_agrees(want, want, scores, F32_TOL) == 0
    near = scores.clone()
    near[0, 2] = 3.0 + F32_TOL  # item 2 ties item 1 within twice the tolerance
    swapped = {"values": want["values"], "indices": torch.tensor([[0, 2]])}
    assert assert_topk_agrees(swapped, want, near, F32_TOL) == 1
    with pytest.raises(AssertionError, match="near-tie"):
        assert_topk_agrees(swapped, want, scores, F32_TOL)
    with pytest.raises(AssertionError, match="twice"):
        assert_topk_agrees({"values": want["values"], "indices": torch.tensor([[0, 0]])},
                           {"values": want["values"], "indices": torch.tensor([[0, 0]])},
                           scores, F32_TOL)
    with pytest.raises(AssertionError):
        assert_topk_agrees({"values": torch.tensor([[4.0, 2.9]]), "indices": want["indices"]},
                           want, scores, F32_TOL)


def test_retrieval_scores_match_jax(smoke):
    cfg, jparams, params = smoke
    jb, b = _batches()["smoke_batch"]
    want = jsasrec.retrieval_scores(jparams, jb, jconfig.smoke_config())
    got = sasrec_retrieval_step(params, b, cfg)
    assert got.shape == b["candidates"].shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("source", ["smoke_batch", "padded"])
def test_retrieval_equals_full_catalog_at_the_same_items(smoke, source):
    cfg, _, params = smoke
    _, b = _batches()[source]
    full = sasrec.serve_scores(params, b, cfg)
    got = sasrec.retrieval_scores(params, b, cfg)
    want = torch.gather(full, 1, b["candidates"].long())
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_item_table_is_never_written(smoke):
    cfg, _, params = smoke
    _, b = _batches()["padded"]
    digest = hashlib.sha256(params["item_emb"].numpy().tobytes()).hexdigest()
    sasrec_serve_step(params, b, cfg)
    sasrec_retrieval_step(params, b, cfg)
    assert hashlib.sha256(params["item_emb"].numpy().tobytes()).hexdigest() == digest


def test_init_tree_matches_jax():
    cfg = config.smoke_config()
    jtree = jax.eval_shape(lambda: jsasrec.init(jax.random.PRNGKey(0), jconfig.smoke_config()))
    params = sasrec.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jtree)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    again = sasrec.init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert torch.equal(params["item_emb"], again["item_emb"])
    assert torch.equal(params["blocks"][1]["ln1_s"], torch.ones(cfg.embed_dim))
    assert 0.015 < float(params["item_emb"].std()) < 0.025


def test_params_from_reference_checks_the_tree(smoke):
    cfg, jparams, _ = smoke
    tree = _numpy_tree(jparams)
    with pytest.raises(ValueError, match="leaves"):
        sasrec_params_from_reference({k: v for k, v in tree.items() if k != "pos_emb"}, cfg,
                                     device=CPU)
    with pytest.raises(ValueError, match="blocks"):
        sasrec_params_from_reference({**tree, "blocks": tree["blocks"][:1]}, cfg, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        sasrec_params_from_reference({**tree, "item_emb": tree["item_emb"][:-1]}, cfg,
                                     device=CPU)
    with pytest.raises(TypeError, match="float32"):
        sasrec_params_from_reference({**tree, "pos_emb": tree["pos_emb"].astype(np.float64)},
                                     cfg, device=CPU)


def test_configs_match_jax():
    assert dataclasses.asdict(config.full_config()) == dataclasses.asdict(
        jconfig.full_config())
    assert dataclasses.asdict(config.smoke_config()) == dataclasses.asdict(
        jconfig.smoke_config())
    assert (config.VOCAB, config.N_CAND) == (jconfig.VOCAB, jconfig.N_CAND)
    cells = jconfig.cells()
    for name, shape in config.SHAPES.items():
        assert cells[name].kind == shape["kind"]
        assert cells[name].batch_specs["seq"].shape[0] == shape["batch"]
        if "n_candidates" in shape:
            assert cells[name].batch_specs["candidates"].shape == (1, shape["n_candidates"])


def test_smoke_batch_matches_jax():
    jb, b = jconfig.smoke_batch(5), config.smoke_batch(5, device=CPU)
    assert set(jb) == set(b)
    for k in jb:
        assert b[k].dtype == torch.int32
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------- data
def _check_batch(batch, vocab, batch_size, seq_len):
    seq, pos, neg = (np.asarray(batch[k]) for k in ("seq", "pos", "neg"))
    for a in (seq, pos, neg):
        assert a.shape == (batch_size, seq_len) and a.dtype == np.int32
    live = seq > 0
    cut = seq_len - live.sum(axis=1)
    # the padding is a prefix of each row, shorter than seq_len // 2
    assert np.array_equal(live, np.arange(seq_len)[None, :] >= cut[:, None])
    assert (cut < seq_len // 2).all()
    assert ((seq[live] >= 1) & (seq[live] < vocab)).all()
    assert ((neg[live] >= 1) & (neg[live] < vocab)).all()
    assert np.array_equal(pos[live], (seq[live].astype(np.int64) * 31 + 7) % (vocab - 1) + 1)
    assert not pos[~live].any() and not neg[~live].any()


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("step", [0, 1, 7])
def test_batch_fn_invariants(package, step):
    vocab, bsz, L = 1000, 64, 50
    if package == "port":
        batch = make_sasrec_batch_fn(vocab, bsz, L, device=CPU)(step)
        batch = {k: v.numpy() for k, v in batch.items()}
    else:
        batch = jmake_batch_fn(vocab, bsz, L)(step)
    _check_batch(batch, vocab, bsz, L)


def test_batch_fn_is_seeded_by_step_and_candidates_in_range():
    make = make_sasrec_batch_fn(1000, 8, 20, device=CPU)
    assert torch.equal(make(2)["seq"], make(2)["seq"])
    assert not torch.equal(make(2)["seq"], make(3)["seq"])
    cand = make_candidates(torch.Generator().manual_seed(0), 2, 5000, 300, device=CPU)
    assert cand.shape == (2, 5000) and cand.dtype == torch.int32
    assert int(cand.min()) == 0 and int(cand.max()) == 299


def test_candidates_refuse_a_generator_on_another_device():
    with pytest.raises(ValueError, match="generator"):
        make_candidates(torch.Generator(), 1, 8, 10, device="meta")


# ---------------------------------------------------------------- device
@pytest.mark.parametrize("entry", ["init", "smoke_batch", "batch_fn", "candidates",
                                   "from_reference"])
def test_entry_points_default_to_the_card(smoke, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, jparams, _ = smoke
    calls = {
        "init": lambda: sasrec.init(cfg, generator=torch.Generator()),
        "smoke_batch": lambda: config.smoke_batch(0),
        "batch_fn": lambda: make_sasrec_batch_fn(10, 2, 4),
        "candidates": lambda: make_candidates(torch.Generator(), 1, 8, 10),
        "from_reference": lambda: sasrec_params_from_reference(_numpy_tree(jparams), cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
