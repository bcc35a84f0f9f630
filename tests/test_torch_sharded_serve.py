"""Port parity for the serving cells on a process mesh: KV caches sharded
along ``cache_seq`` (kernel 6's log-sum-exp and ``merge_attention``), the
SASRec catalog sharded by rows (``sharded_rows``, ``merge_topk``), the
sharded prefill, decode, serve and retrieval steps and ``build_step``'s
serving fns, one rank a process under gloo on the CPU.

One spawn of 4 ranks (``tests/sharded_serve_ranks.py`` is the rank side,
which imports no JAX) runs every multi-rank case; the JAX package's
one-device references are computed while it runs, each function jitted
once a config.  The models are ``tests/test_distributed.py``'s tiny LM
(its vocabulary raised from 101 to 128 rows, so that the logits' columns
and the embedding's rows split over ``model``), deepseek's MLA
``smoke_config()`` and SASRec's ``smoke_config()``, their weights carried
from JAX's ``init`` through ``core/convert.py``.  Tolerances, and why:

* ``decode_attention_ref(return_lse=True)`` on 2 and 4 row ranges of one
  cache (some empty at short lengths), merged: within ``MERGE_TOL`` (1e-6,
  float32) of the whole-cache call, the same sums regrouped; ``pos = 0``
  gives 0 and -inf exactly, and the output without ``return_lse`` is
  unchanged bit for bit.
* Logits and cache rows: within ``TOL`` (rtol = atol = 1e-5, as
  ``tests/test_torch_lm.py`` holds the port's float32 LM to JAX) of JAX's
  ``prefill`` / ``decode_step`` on one device; the merged partials regroup
  the softmax's sums, a float32 rounding.  Rows a rank's slice does not yet
  hold are exactly 0: only the owner of a position writes it.
* SASRec ``serve``: the values within ``TOL`` of JAX's ``lax.top_k``, the
  indices through ``assert_topk_agrees``; ``retrieval``: the rank's block
  within ``TOL`` of JAX's scores.
* ``sharded_rows``: bit for bit ``take_rows`` on the whole table (a row
  plus zero rows), at every block edge, id 0, and ids outside [0, V).

A rank still running after ``SPAWN_LIMIT_S`` is killed and the tests fail.
"""
import dataclasses
import multiprocessing
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_lite_16b as jdeepseek
from repro.configs import sasrec as jsasrec_config
from repro.models import sasrec as jsasrec
from repro.models import transformer_lm as jlm
from repro_torch.configs import sasrec as sasrec_config
from repro_torch.core.convert import sasrec_params_from_reference
from repro_torch.distributed.serving import local_rows
from repro_torch.kernels import decode_attention, decode_attention_ref, take_rows
from repro_torch.launch import assert_topk_agrees
from sharded_serve_ranks import rank_main
from torch_parity import numpy_tree, write_payload

MERGE_TOL = 1e-6
TOL = 1e-5
SPAWN_LIMIT_S = 120   # ranks still running after this are killed: a hung rank fails
TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
            d_ff=64, vocab=128, dtype="float32", kv_block=8)
PROMPT, MAX_SEQ, STEPS = 6, 16, 4   # decode positions 6..9 cross the ranges' edges
TOP_K = 100


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return numpy_tree(tree)


def _lm_case(jcfg, batch, seed):
    rng = np.random.default_rng(seed)
    params = jax.jit(jlm.init, static_argnums=(1,))(jax.random.PRNGKey(seed), jcfg)
    prompts = rng.integers(0, jcfg.vocab, (batch, PROMPT)).astype(np.int32)
    steps = [rng.integers(0, jcfg.vocab, (batch, 1)).astype(np.int32) for _ in range(STEPS)]
    return {"params": _tree_np(params), "prompts": prompts, "steps": steps,
            "max_seq": MAX_SEQ}, params


def _payload():
    rng = np.random.default_rng(0)
    attn = {"q": rng.normal(size=(3, 4, 8)).astype(np.float32),
            "k": rng.normal(size=(3, 16, 2, 8)).astype(np.float32),
            "v": rng.normal(size=(3, 16, 2, 8)).astype(np.float32),
            "pos": np.array([1, 7, 16], np.int32)}
    lm_case, jp_lm = _lm_case(jlm.LMConfig(**TINY), 4, 1)
    lm_case["cfg"] = TINY
    mla_cfg = jdeepseek.smoke_config()
    mla_case, jp_mla = _lm_case(mla_cfg, 2, 2)
    scfg = jsasrec_config.smoke_config()
    jp_s = jsasrec.init(jax.random.PRNGKey(3), scfg)
    V, half = scfg.vocab, scfg.vocab // 2
    cands = rng.integers(1, V, (2, 64)).astype(np.int32)
    cands[0, :8] = [0, half - 1, half, V - 1, -1, -V, V, -V - 1]
    ids = np.array([[0, 1, half - 1, half, half + 1, V - 1],
                    [-1, -half, -half - 1, -V, -V - 1, V], [V + 5, 3 * V, 7, 0, 0, 0]],
                   np.int32)
    sasrec_case = {"params": _tree_np(jp_s),
                   "serve_seq": rng.integers(0, V, (8, scfg.seq_len)).astype(np.int32),
                   "ret_seq": rng.integers(0, V, (2, scfg.seq_len)).astype(np.int32),
                   "candidates": cands, "ids": ids}
    payload = {"attn": attn, "lm": lm_case, "mla": mla_case, "sasrec": sasrec_case}
    return payload, {"lm": (jlm.LMConfig(**TINY), jp_lm), "mla": (mla_cfg, jp_mla),
                     "sasrec": (scfg, jp_s)}


def _jax_lm(jcfg, params, case):
    """JAX's one-device prefill into ``MAX_SEQ`` positions and its decode
    steps: (prefill logits, prefill caches, each step's logits, caches)."""
    prefill = jax.jit(jlm.prefill, static_argnums=(2,), static_argnames=("max_seq",))
    decode = jax.jit(jlm.decode_step, static_argnums=(4,))
    logits, caches = prefill(params, jnp.asarray(case["prompts"]), jcfg, max_seq=MAX_SEQ)
    out = {"prefill": np.asarray(logits), "prefill_caches": jax.tree.map(np.asarray, caches)}
    steps = []
    for i, tok in enumerate(case["steps"]):
        lg, caches = decode(params, caches, jnp.asarray(tok), jnp.int32(PROMPT + i), jcfg)
        steps.append(np.asarray(lg))
    out["steps"], out["caches"] = steps, jax.tree.map(np.asarray, caches)
    return out


def _jax_sasrec(scfg, params, case):
    serve = jax.jit(jsasrec.serve_scores, static_argnums=(2,))
    scores = serve(params, {"seq": jnp.asarray(case["serve_seq"])}, scfg)
    values, indices = jax.lax.top_k(scores, TOP_K)
    ret = jax.jit(jsasrec.retrieval_scores, static_argnums=(2,))(
        params, {"seq": jnp.asarray(case["ret_seq"]),
                 "candidates": jnp.asarray(case["candidates"])}, scfg)
    return {"scores": np.asarray(scores), "values": np.asarray(values),
            "indices": np.asarray(indices), "retrieval": np.asarray(ret)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(every rank's results, JAX's one-device references, the payload)."""
    tmp = tmp_path_factory.mktemp("sharded_serve")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 4, str(tmp / "init"),
                                                 str(tmp / "payload.pkl"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        payload, jax_models = _payload()
        write_payload(tmp / "payload.pkl", payload)
        want = {name: _jax_lm(*jax_models[name], payload[name]) for name in ("lm", "mla")}
        want["sasrec"] = _jax_sasrec(*jax_models["sasrec"], payload["sasrec"])
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = sorted(tmp.glob("rank*.err"))
    assert not errs, errs[0].read_text()
    assert not hung, f"ranks {hung} still running after {SPAWN_LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return ranks, want, payload


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL, err_msg=what)


def _cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _cache_leaves(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _held_slices(got, want, rows, seq, filled, what):
    """Each cache leaf's slice (L, B_r, hi - lo, ...) within ``TOL`` of the
    JAX cache's rows and batch rows, and exactly 0 at positions >= filled."""
    (b0, b1), (lo, hi) = rows, seq
    got, want = _cache_leaves(got), _cache_leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == (w.shape[0], b1 - b0, hi - lo) + w.shape[3:], (what, k, g.shape)
        _close(g, w[:, b0:b1, lo:hi], f"{what} {k}")
        assert not np.any(g[:, :, max(filled - lo, 0):]), f"{what} {k}: a row past {filled}"


# ---------------------------------------------------------------- one process
def test_lse_and_the_empty_sequence():
    """``return_lse=True``: lse equals ``logsumexp`` of the masked scaled
    scores, the output equals the call without it bit for bit (float32),
    and a sequence at ``pos = 0`` gives 0 and -inf exactly; the wrapper
    takes the plain version on the CPU."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(3, 6, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, 11, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, 11, 2, 8)).astype(np.float32))
    pos = torch.tensor([0, 4, 11], dtype=torch.int32)
    out, lse = decode_attention(q, k, v, pos, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (3, 6)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(lse[0], torch.full((6,), -torch.inf))
    plain = decode_attention_ref(q, k, v, pos)
    assert torch.equal(out[1:], plain[1:])
    s = torch.einsum("bghd,bsgd->bghs", q.reshape(3, 2, 3, 8), k) / np.sqrt(8)
    for b in (1, 2):
        want = torch.logsumexp(s[b, ..., :int(pos[b])], dim=-1).reshape(6)
        torch.testing.assert_close(lse[b], want, rtol=0, atol=MERGE_TOL)
    bf = decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos, return_lse=True)[0]
    assert bf.dtype == torch.float32


def test_local_rows_never_wraps_into_the_block():
    """An id below a block, shifted by ``-lo``, would wrap into the block
    through ``take_rows``' negative ids: ``local_rows`` gives it a zero
    row.  Owned ids (and negative global ids that wrap onto owned rows)
    come back exactly."""
    table = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) + 1
    block, lo = table[4:], 4
    ids = torch.tensor([0, 1, 3, 4, 7, 8, -1, -4, -5, -9])
    got = local_rows(block, ids, lo, 8)
    want = take_rows(table, ids)
    own = torch.tensor([False, False, False, True, True, False, True, True, False, False])
    assert torch.equal(got[own], want[own])
    assert torch.equal(got[~own], torch.zeros_like(got[~own]))


# ---------------------------------------------------------------- the merge
@pytest.mark.parametrize("mesh", ["(4, 1)", "(2, 2)"])
def test_merged_ranges_equal_the_whole_cache(spawned, mesh):
    """Every rank's merge of ``decode_attention_ref(return_lse=True)`` over
    its mesh's ranges within ``MERGE_TOL`` of the whole-cache call; at
    ``pos = 1`` every range but the first is empty (lse -inf)."""
    ranks, _, payload = spawned
    a = payload["attn"]
    want = decode_attention_ref(*(torch.from_numpy(a[n]) for n in ("q", "k", "v", "pos")))
    for r in range(4):
        got = ranks[r]["merge"][mesh]
        np.testing.assert_allclose(got["merged"], want.numpy(), rtol=0, atol=MERGE_TOL)
        if got["range"][0] >= 1:
            assert np.all(got["lse"][0] == -np.inf)


# ---------------------------------------------------------------- the LM
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_build_step_prefill_on_two_two(spawned, rank):
    """``build_step``'s prefill fn on (2, 2) from blocks: the rank's batch
    rows and vocab columns of the last position's logits within ``TOL`` of
    JAX's prefill, its cache blocks (the prompt's 6 positions over
    ``model``) the JAX cache's rows."""
    ranks, want, _ = spawned
    d, m = ranks[rank]["coords"]["(2, 2)"]
    got = ranks[rank]["lm (2, 2)"]["prefill"]
    rows, cols, seq = (2 * d, 2 * d + 2), (64 * m, 64 * m + 64), (3 * m, 3 * m + 3)
    _close(got["logits"], want["lm"]["prefill"][rows[0]:rows[1], cols[0]:cols[1]], "logits")
    _held_slices(got["caches"], want["lm"]["prefill_caches"], rows, seq, PROMPT, "prefill")


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_build_step_decode_on_two_two(spawned, rank):
    """``build_step``'s decode fn on (2, 2) (``LM_DECODE_RULES``), 4 steps
    over caches of 16 positions (8 a rank, positions 6-9 cross the edge):
    each step's logits block within ``TOL`` of JAX's ``decode_step``, the
    cache blocks the JAX cache's rows, 0 past position 9."""
    ranks, want, _ = spawned
    d, m = ranks[rank]["coords"]["(2, 2)"]
    got = ranks[rank]["lm (2, 2)"]
    rows, cols, seq = (2 * d, 2 * d + 2), (64 * m, 64 * m + 64), (8 * m, 8 * m + 8)
    _held_slices(got["prefill16"], want["lm"]["prefill_caches"], rows, seq, PROMPT, "prefill")
    for i, lg in enumerate(got["decode"]["logits"]):
        _close(lg, want["lm"]["steps"][i][rows[0]:rows[1], cols[0]:cols[1]], f"step {i}")
    _held_slices(got["decode"]["caches"], want["lm"]["caches"], rows, seq, PROMPT + STEPS,
                 "decode")


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_long_decode_on_four_one(spawned, rank):
    """The tiny LM on (4, 1) under ``LM_DECODE_LONG_RULES``: the batch
    replicated, 4 positions a rank; rank 3 holds no row and merges as the
    identity.  Logits (all columns) and cache slices held to JAX."""
    ranks, want, _ = spawned
    got = ranks[rank]["lm (4, 1)"]
    assert got["rows"] == (0, 4) and got["seq"] == (4 * rank, 4 * rank + 4)
    assert got["vocab"] == (0, TINY["vocab"])
    _close(got["prefill"]["logits"], want["lm"]["prefill"], "prefill logits")
    _held_slices(got["prefill"]["caches"], want["lm"]["prefill_caches"], got["rows"],
                 got["seq"], PROMPT, "prefill")
    for i, lg in enumerate(got["logits"]):
        _close(lg, want["lm"]["steps"][i], f"step {i}")
    _held_slices(got["caches"], want["lm"]["caches"], got["rows"], got["seq"], PROMPT + STEPS,
                 "decode")


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_mla_decode_on_one_two(spawned, rank):
    """deepseek's MLA smoke config (a dense layer, two MoE layers) on its
    pair's (1, 2) mesh: prefill and 4 decode steps, ``partial_attention``
    over K and V materialised from the slice's valid rows; logits blocks
    and latent cache slices held to JAX."""
    ranks, want, _ = spawned
    got = ranks[rank]["mla (1, 2)"]
    m = rank % 2
    cols = (64 * m, 64 * m + 64)
    assert got["seq"] == (8 * m, 8 * m + 8) and got["vocab"] == cols
    _close(got["prefill"]["logits"], want["mla"]["prefill"][:, cols[0]:cols[1]], "prefill")
    _held_slices(got["prefill"]["caches"], want["mla"]["prefill_caches"], got["rows"],
                 got["seq"], PROMPT, "prefill")
    for i, lg in enumerate(got["logits"]):
        _close(lg, want["mla"]["steps"][i][:, cols[0]:cols[1]], f"step {i}")
    _held_slices(got["caches"], want["mla"]["caches"], got["rows"], got["seq"],
                 PROMPT + STEPS, "decode")


# ---------------------------------------------------------------- SASRec
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_serve_on_two_two(spawned, rank):
    """``build_step``'s serve fn on (2, 2) under ``RECSYS_RULES``: the rank
    holds 256 of the 512 item rows; its 4 users' top 100 of the whole
    catalog (a local top 100 a rank, ``merge_topk`` over ``model``): values
    within ``TOL`` of JAX's ``lax.top_k``, indices through
    ``assert_topk_agrees`` on JAX's scores."""
    ranks, want, _ = spawned
    got = ranks[rank]["sasrec (2, 2)"]
    d, _ = ranks[rank]["coords"]["(2, 2)"]
    assert got["block_rows"] == (256, 16)
    w = want["sasrec"]
    rows = slice(4 * d, 4 * d + 4)
    assert got["serve"]["indices"].dtype == np.int32
    assert_topk_agrees({k: torch.from_numpy(v) for k, v in got["serve"].items()},
                       {"values": torch.from_numpy(w["values"][rows]),
                        "indices": torch.from_numpy(w["indices"][rows])},
                       torch.from_numpy(w["scores"][rows]), TOL, f"rank {rank}")


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_retrieval_on_two_two(spawned, rank):
    """``build_step``'s retrieval fn on (2, 2) under
    ``RECSYS_RETRIEVAL_RULES``: candidates over (data, model), 16 a rank,
    ids at the block edges, negative and out of range among them; the
    rank's block within ``TOL`` of JAX's scores."""
    ranks, want, _ = spawned
    got = ranks[rank]["sasrec (2, 2)"]["retrieval"]
    assert got.shape == (2, 16)
    _close(got, want["sasrec"]["retrieval"][:, 16 * rank:16 * rank + 16], f"rank {rank}")


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_sharded_rows_is_take_rows(spawned, rank):
    """``sharded_rows`` over the (2, 2) mesh's ``model`` axis, each rank
    with its 256 rows: bit for bit ``take_rows`` on the whole table, at the
    block edges, id 0, wrapped negative ids and ids outside [-V, V)."""
    ranks, _, payload = spawned
    cfg = sasrec_config.smoke_config()
    table = sasrec_params_from_reference(payload["sasrec"]["params"], cfg, "cpu")["item_emb"]
    want = take_rows(table, torch.from_numpy(payload["sasrec"]["ids"]))
    got = torch.from_numpy(ranks[rank]["sasrec (2, 2)"]["rows"])
    assert got.dtype == want.dtype and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


def test_mesh_coordinates(spawned):
    """The ranks' coordinates: (2, 2) row-major, (4, 1) along ``data``."""
    ranks = spawned[0]
    assert [r["coords"]["(2, 2)"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["coords"]["(4, 1)"] for r in ranks] == [(r, 0) for r in range(4)]


def test_tiny_lm_config_matches_the_distributed_test():
    """The tiny LM is ``tests/test_distributed.py``'s but for its
    vocabulary (101 does not split over ``model``)."""
    from test_distributed import CFG

    assert dataclasses.replace(CFG, vocab=TINY["vocab"]) == jlm.LMConfig(**TINY)
