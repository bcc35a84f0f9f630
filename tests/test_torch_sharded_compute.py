"""Port parity for LM training with sharded compute on a process mesh:
``Trainer(mesh=, rules=LM_RULES)`` one rank a process under gloo on the
CPU, where a rank computes on its blocks (FSDP over ``data`` one layer at a
time, heads, ff and vocab tensor-parallel over ``model``).

One spawn of 4 ranks (``tests/sharded_compute_ranks.py`` is the rank side,
which imports no JAX): ranks 0-1 on (1, 2) and ranks 2-3 on (2, 1) at
once, then all four on (2, 2) and on the ``("pod", "data", "model")``
meshes (2, 2, 1) and (2, 1, 2), where ``pod`` splits the batch and no
leaf, so a gradient reduce-scattered over ``data`` is also summed over
``pod``.  The JAX package's one-device ``Trainer`` runs while they do.  The models are the smoke configs of qwen2-1.5b (GQA
with qkv biases), deepseek-v2-lite-16b (MLA, a dense layer, then MoE with a
shared expert) and dbrx-132b (MoE with GQA), in float32, their weights and
AdamW state carried over from JAX's ``init``.  Tolerances, and why:

* parameters after 2 steps within ``ATOL`` (2e-5,
  ``tests/test_distributed.py``'s accumulation tolerance) of JAX's
  one-device ``Trainer`` at the same ``accum`` and of the port's (every
  run): the gradients are summed in another order (the ranks' partials,
  the reduce-scatters);
* losses and gradient norms within 1e-5 relative, for the same reason;
* every rank's gathered parameters and AdamW state bit for bit the same:
  a leaf replicated over an axis is computed alike on every rank of it.

The (2, 1) run at ``accum`` 3 over 6 rows gives each rank an empty piece
of one microbatch, which must still take part in its collectives; a rank
still running after ``SPAWN_LIMIT_S`` is killed and the tests fail.
"""
import dataclasses
import multiprocessing
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.configs import get_arch as jget_arch
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import Trainer as JTrainer
from repro.models import transformer_lm as jlm
from repro_torch.configs import get_arch
from repro_torch.core import ProcessMesh
from repro_torch.distributed import LM_RULES
from repro_torch.launch import train_layout
from repro_torch.models import transformer_lm as lm
from repro_torch.nn.attention import gqa_attention
from repro_torch.nn.mlp import swiglu
from repro_torch.nn.moe import moe_ffn
from repro_torch.nn.norms import rms_norm
from repro_torch.nn.rotary import apply_rope
from sharded_compute_ranks import rank_main
from torch_parity import numpy_tree, write_payload

ATOL = 2e-5          # tests/test_distributed.py's accumulation tolerance
RTOL = 1e-5          # losses and gradient norms
SPAWN_LIMIT_S = 150  # ranks still running after this are killed: a hung rank fails
STEPS = 2
ARCHS = {"qwen2": "qwen2-1.5b", "deepseek": "deepseek-v2-lite-16b", "dbrx": "dbrx-132b"}
ONE = [(name, 1, "b4") for name in ARCHS]
EMPTY_PIECE = ("deepseek", 3, "b6")   # on (2, 1): each rank has an empty piece
CASES = {(1, 2): ONE, (2, 1): ONE + [EMPTY_PIECE], (2, 2): ONE + [("dbrx", 2, "b4")],
         (2, 2, 1): ONE, (2, 1, 2): [("qwen2", 1, "b4"), ("dbrx", 1, "b4")]}
FITS = sorted({case for cases in CASES.values() for case in cases})
RUNS = [(shape, name, accum) for shape, cases in CASES.items() for name, accum, _ in cases]
IDS = [f"{'x'.join(map(str, s))}-{n}-accum{a}" for s, n, a in RUNS]


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return numpy_tree(tree)


def _batches(rows, vocab):
    """``STEPS`` batches of ``rows`` x 16 tokens, the targets the next
    token, masked unevenly: row 0 keeps 2 of 16, row 1 keeps 8, row 4 keeps
    5, so the ranks of a (2, 1) mesh hold different counts."""
    rng = np.random.default_rng(rows)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (rows, 16)).astype(np.int32)
        tgt = np.roll(toks, -1, axis=1)
        tgt[0, 2:] = -1
        tgt[1, 8:] = -1
        if rows > 4:
            tgt[4, :11] = -1
        out.append({"tokens": toks, "targets": tgt})
    return out


def _payload():
    models, jax_state = {}, {}
    for name, arch in ARCHS.items():
        jcfg = jget_arch(arch).smoke_config()
        jp = jax.jit(jlm.init, static_argnums=(1,))(jax.random.PRNGKey(0), jcfg)
        models[name] = {"cfg": dataclasses.asdict(jcfg), "params": _tree_np(jp),
                        "opt": _tree_np(joptim.adamw_init(jp)),
                        "b4": _batches(4, jcfg.vocab), "b6": _batches(6, jcfg.vocab)}
        jax_state[name] = (jcfg, jp)
    return {"steps": STEPS, "cases": CASES, "models": models}, jax_state


def _jax_fit(jcfg, jp, batches, accum=1):
    tr = JTrainer(jlm, jcfg, train_cfg=JTrainConfig(steps=STEPS, warmup=1, accum=accum,
                                                    log_every=1))
    p, _, hist = tr.fit(lambda s: {k: jnp.asarray(v) for k, v in batches[s].items()},
                        params=jax.tree.map(jnp.array, jp), opt_state=joptim.adamw_init(jp))
    return {"params": _tree_np(p), "losses": [h["loss"] for h in hist],
            "norms": [h["grad_norm"] for h in hist]}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(every rank's results, JAX's one-device runs by (name, accum))."""
    tmp = tmp_path_factory.mktemp("sharded_compute")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 4, str(tmp / "init"),
                                                 str(tmp / "payload.pkl"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        payload, jax_state = _payload()
        write_payload(tmp / "payload.pkl", payload)
        want = {(name, accum): _jax_fit(*jax_state[name], payload["models"][name][key], accum)
                for name, accum, key in FITS}
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
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)], want


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _ranks_of(shape):
    return {(1, 2): [0, 1], (2, 1): [2, 3]}.get(shape, [0, 1, 2, 3])


def _held(run, want):
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(run["norms"], want["norms"], rtol=RTOL)
    got, exp = _leaves(run["params"]), _leaves(want["params"])
    assert set(got) == set(exp)
    for k, w in exp.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("shape,name,accum", RUNS, ids=IDS)
def test_matches_jax(spawned, shape, name, accum):
    """Every rank's gathered parameters after 2 steps within ``ATOL`` of
    JAX's one-device ``Trainer`` at the same ``accum``; losses and gradient
    norms within ``RTOL``."""
    ranks, want = spawned
    for r in _ranks_of(shape):
        _held(ranks[r][shape][(name, accum)]["sharded"], want[(name, accum)])


@pytest.mark.parametrize("shape,name,accum", RUNS, ids=IDS)
def test_near_the_one_device_port(spawned, shape, name, accum):
    """The sharded run against the port's own one-device ``Trainer`` on
    the same state and batches, within the same tolerances."""
    for r in _ranks_of(shape):
        run = spawned[0][r][shape][(name, accum)]
        _held(run["sharded"], run["one_device"])


@pytest.mark.parametrize("shape,name,accum", RUNS, ids=IDS)
def test_ranks_agree_bit_for_bit(spawned, shape, name, accum):
    """Every rank ends with the same parameters, AdamW state, losses and
    norms, bit for bit: the leaves replicated over an axis (the norms'
    weights over ``model``, the qkv biases over ``data``, MLA's ``w_dkv``
    and ``kv_norm``) stay replicated."""
    runs = [spawned[0][r][shape][(name, accum)]["sharded"] for r in _ranks_of(shape)]
    for run in runs[1:]:
        for what in ("params", "opt"):
            a, b = _leaves(run[what]), _leaves(runs[0][what])
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}{k}")
        assert run["losses"] == runs[0]["losses"] and run["norms"] == runs[0]["norms"]


def _reckon(cfg, shape, accum) -> dict:
    """The collectives of a sharded run by kind, from the layers, the
    leaves' logical axes and the microbatches: a leaf splits over ``data``
    where it has ``embed`` and over ``model`` where it has ``heads``,
    ``ff``, ``vocab`` or ``experts`` (``LM_RULES``)."""
    P, D, M = (1,) * (3 - len(shape)) + tuple(shape)
    tp_names = ("heads", "ff", "vocab", "experts")
    sets = set()
    gathers = scatters = replicated = rows = 0
    tp = 4 * (M > 1)           # the lookup, the cross-entropy's MAX and SUM, the logits' entry
    for name in ("embed", "final_norm"):
        logical = lm.param_specs(cfg)[name]
        sets.add(("embed" in logical and D > 1, any(n in logical for n in tp_names) and M > 1))
    for _, _, n, moe_block in lm._stacks(cfg):
        for sub, tree in lm._block_axes(cfg, moe_block).items():
            for logical in _leaves_of(tree):
                data = "embed" in logical and D > 1
                model = any(x in logical for x in tp_names) and M > 1
                sets.add((data, model))
                gathers += n * (data or (sub == "moe" and model))
                scatters += n * data
                replicated |= "embed" not in logical
        enters = 3 if cfg.attn == "mla" else 1
        tp += n * (M > 1) * (1 + enters + (0 if moe_block else 2))
        rows += n * moe_block * (P * D > 1)
    held = 2 * (D > 1)
    pod = P > 1            # a gradient reduce-scattered over data is all-reduced over pod
    return {"gathers": STEPS * (held + 2 * accum * gathers),      # forward and recompute
            "reduce_scatters": STEPS * (held + accum * scatters),
            "tp_all_reduces": STEPS * accum * tp,
            "row_gathers": STEPS * accum * 2 * rows,
            "fsdp_all_reduces": STEPS * (accum * rows + pod * (held + accum * scatters)),
            "norm_all_reduces": STEPS * len(sets - {(False, False)}),
            "replicated_all_reduces": STEPS * int((replicated or D == 1) and P * D > 1)}


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves_of(v)]
    return [tree]


@pytest.mark.parametrize("shape,name,accum", RUNS, ids=IDS)
def test_collective_counts(spawned, shape, name, accum):
    """The collectives a rank issued, by kind, equal their reckoning from
    layers x microbatches (per-layer gathers in the forward and again in
    the recompute, one reduce-scatter a leaf a microbatch, the embedding
    and final norm once a step); ``launch.steps.gather_tree`` was never
    called."""
    cfg = get_arch(ARCHS[name]).smoke_config()
    want = {k: v for k, v in _reckon(cfg, shape, accum).items() if v}
    for r in _ranks_of(shape):
        counts = dict(spawned[0][r][shape][(name, accum)]["sharded"]["counts"])
        counts.pop("pieces")
        assert counts == want, r


def test_empty_microbatch_piece(spawned):
    """The (2, 1) run at ``accum`` 3 over 6 rows: each rank holds 3 rows, so
    microbatch 1 (rows 2-3) spans both ranks and each rank ran an empty
    piece of another (rank 0 of microbatch 2, rank 1 of microbatch 0)
    through the sharded forward and backward, every step; both ranks
    finished, and their parameters match JAX's one-device ``Trainer``."""
    ranks, want = spawned
    name, accum, _ = EMPTY_PIECE
    for r, rows in zip(_ranks_of((2, 1)), ([2, 1, 0], [0, 1, 2])):
        run = ranks[r][(2, 1)][(name, accum)]["sharded"]
        assert run["counts"]["pieces"] == rows * STEPS, r
        _held(run, want[(name, accum)])


def _fake_mesh(shape):
    """A process mesh without a group: enough for a layout, no collective."""
    return ProcessMesh(shape=shape, axis_names=("data", "model"), rank=0,
                       device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("arch,replace,model,leaf", [
    ("qwen2-1.5b", {}, 4, "/layers/attn/wq: 6 heads"),
    ("qwen2-1.5b", {"n_heads": 4}, 4, "/layers/attn/wk: 2 heads"),
    ("deepseek-v2-lite-16b", {}, 8, "/dense_layers/attn/wq: 4 heads"),
])
def test_uneven_heads_raise(arch, replace, model, leaf):
    """Head counts that do not split over ``model`` raise ``ValueError``
    naming the leaf, though the columns split evenly (a query group would
    leave its kv head)."""
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), **replace)
    with pytest.raises(ValueError, match=leaf):
        train_layout(lm, cfg, _fake_mesh((1, model)), LM_RULES)


def _ref_attention(p, x, cfg, positions):
    B, S, _ = x.shape
    attend = lambda q, k, v: gqa_attention(  # noqa: E731
        q, k, v, causal=True, q_offset=0, kv_block=cfg.kv_block, window=cfg.window,
        mixed=cfg.attn_mixed_precision, causal_skip=cfg.attn_causal_skip)
    H = cfg.n_heads
    if cfg.attn == "mla":
        dn, dr, dv, r = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
        q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)], dim=-1)
        ckv_kr = x @ p["w_dkv"]
        ckv = rms_norm(ckv_kr[..., :r], p["kv_norm"])
        kr = apply_rope(ckv_kr[..., r:], positions, cfg.rope_theta)
        k = torch.cat([(ckv @ p["w_uk"]).reshape(B, S, H, dn),
                       kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        v = (ckv @ p["w_uv"]).reshape(B, S, H, dv)
        return attend(q, k, v).reshape(B, S, H * dv) @ p["wo"]
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, cfg.rope_theta)
    return attend(q, k, v.reshape(B, S, Hkv, Dh)).reshape(B, S, H * Dh) @ p["wo"]


def _ref_loss(params, batch, cfg):
    """The one-device training loss, op for op as the model computed it
    before the sharded path (no checkpoint: a recompute gives the same
    values)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1])[None, :]
    for key, _, n, moe_block in lm._stacks(cfg):
        for i in range(n):
            p = lm.layer_params(params[key], i)
            x = x + _ref_attention(p["attn"], rms_norm(x, p["pre_attn"]), cfg, positions)
            h = rms_norm(x, p["pre_ffn"])
            if moe_block:
                B, S, d = h.shape
                x = x + moe_ffn(p["moe"], h.reshape(B * S, d), cfg.moe_cfg()).reshape(B, S, d)
            else:
                x = x + swiglu(p["ffn"], h)
    logits = (rms_norm(x, params["final_norm"]) @ params["embed"].T).float()
    lse = torch.logsumexp(logits, dim=-1)
    targets = batch["targets"].long()
    tgt = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (batch["targets"] >= 0).float()
    return torch.sum((lse - tgt) * mask)


@pytest.mark.parametrize("arch", list(ARCHS.values()))
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_unsharded_loss_is_the_one_device_ops(arch, policy):
    """``shard=None``: the training loss and every gradient bit for bit the
    one-device ops as they ran before the sharded path."""
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), remat_policy=policy)
    params = lm.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 16)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    batch["targets"][0, 5:] = -1
    leaves = [t.requires_grad_(True) for t in _leaves_of(params)]
    got = lm.loss_terms(params, batch, cfg)[0]
    want = _ref_loss(params, batch, cfg)
    assert torch.equal(got, want)
    for g, w in zip(torch.autograd.grad(got, leaves), torch.autograd.grad(want, leaves)):
        assert torch.equal(g, w)
