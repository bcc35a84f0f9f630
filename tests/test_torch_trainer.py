"""Port parity for the fault-tolerant trainer (``launch/train.py``),
``launch.train_step``, ``data/tokens.py`` and the AdamW state converter:
``Trainer.fit`` histories against the JAX package's from the same
carried-over state and batches, a JAX-written checkpoint resumed in the
port, microbatch accumulation, and bit-identical restart.

JAX's parameters and AdamW state cross with ``lm_params_from_reference`` /
``sasrec_params_from_reference`` and ``adamw_state_from_reference``; the
batches are the JAX package's, passed as numpy.  Tolerances, and why:

* Losses within rtol 1e-5 and grad norms within rtol 1e-4 a step: float32
  gradients agree within ~1e-6 (``test_torch_train.py``), but AdamW's step
  ``m / (sqrt(v) + eps)`` is ~±1 for any gradient element far above eps,
  so an element whose gradient is near 0 may move by ±lr in one package
  and by its opposite in the other.  The parameters after a run are held
  to at most 2 lr · Σ lr_scale a element (what such flips can add up to),
  and to rtol 1e-5 for all but 1 % of the elements.
* Accumulation over two halves against one batch (the same mean when
  every position counts): the same rules.
* Restart: bit for bit (float32 and bfloat16 trees).
"""
import dataclasses
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np
from torch_parity import numpy_tree as _numpy_tree

from repro import optim as joptim
from repro.configs import qwen2_1_5b as jqwen
from repro.configs import sasrec as jsasrec_config
from repro.data.recsys import make_sasrec_batch_fn as jmake_sasrec_batch_fn
from repro.data.tokens import make_lm_batch_fn as jmake_lm_batch_fn
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import Trainer as JTrainer
from repro.models import sasrec as jsasrec
from repro.models import transformer_lm as jlm
from repro_torch import optim
from repro_torch.configs import qwen2_1_5b
from repro_torch.configs import sasrec as sasrec_config
from repro_torch.core.convert import (
    adamw_state_from_reference,
    lm_params_from_reference,
    sasrec_params_from_reference,
)
from repro_torch.data import make_lm_batch_fn, make_sasrec_batch_fn
from repro_torch.launch import TrainConfig, Trainer, train_step
from repro_torch.models import sasrec
from repro_torch.models import transformer_lm as lm

CPU = "cpu"
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_RTOL = 1e-5
FLIP_SHARE = 0.01
LR = optim.AdamWConfig().lr


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return _numpy_tree(tree)


def _paths(tree, prefix=""):
    """A dict / list tree's leaves as ``{"/a/0/b": float32 numpy}`` (JAX
    arrays or port tensors)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _paths(v, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _case(model):
    """(JAX module, port module, jcfg, cfg, JAX params, port params, JAX
    batch function): float32 smoke configs, small batches."""
    if model == "sasrec":
        jcfg, cfg = jsasrec_config.smoke_config(), sasrec_config.smoke_config()
        jp = jsasrec.init(jax.random.PRNGKey(0), jcfg)
        return (jsasrec, sasrec, jcfg, cfg, jp, sasrec_params_from_reference(_tree_np(jp), cfg,
                                                                            CPU),
                jmake_sasrec_batch_fn(cfg.vocab, 8, cfg.seq_len))
    jcfg, cfg = jqwen.smoke_config(), qwen2_1_5b.smoke_config()
    jp = jax.jit(jlm.init, static_argnums=(1,))(jax.random.PRNGKey(0), jcfg)
    return (jlm, lm, jcfg, cfg, jp, lm_params_from_reference(_tree_np(jp), cfg, CPU),
            jmake_lm_batch_fn(cfg.vocab, 4, 16))


def _port_batches(jmake, steps):
    """The JAX package's batches of steps 0.. as port tensors."""
    batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in jmake(s).items()}
               for s in range(steps)]
    return lambda step: batches[step]


def _hold_params(got, want, lr_sum):
    """Every element within 2 lr · lr_sum (+ rtol 1e-5), and all but
    ``FLIP_SHARE`` of them within rtol 1e-5."""
    far = total = 0
    got, want = _paths(got), _paths(want)
    assert set(got) == set(want)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert (d <= 2 * LR * lr_sum + PARAM_RTOL * np.abs(w)).all(), float(d.max())
        far += int((d > PARAM_RTOL * np.abs(w) + 1e-7).sum())
        total += d.size
    assert far <= FLIP_SHARE * total, (far, total)


def _hold_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=NORM_RTOL)
        assert g["sec_per_step"] > 0


def _lr_sum(steps, warmup, first=0):
    return sum(float(optim.warmup_cosine(torch.tensor(s), warmup=warmup, total=max(steps, 2)))
               for s in range(first, steps))


@pytest.mark.parametrize("model", ["sasrec", "qwen2"])
def test_fit_history_matches_jax(model):
    jmod, mod, jcfg, cfg, jp, params, jmake = _case(model)
    steps, warmup = 5, 2
    opt = adamw_state_from_reference(_tree_np(joptim.adamw_init(jp)), params, CPU)
    jtrainer = JTrainer(jmod, jcfg, train_cfg=JTrainConfig(steps=steps, warmup=warmup,
                                                           log_every=1))
    jparams, _, jhist = jtrainer.fit(jmake, params=jp, opt_state=joptim.adamw_init(jp))
    trainer = Trainer(mod, cfg, train_cfg=TrainConfig(steps=steps, warmup=warmup, log_every=1),
                      device=CPU)
    got, got_opt, hist = trainer.fit(_port_batches(jmake, steps), params=params, opt_state=opt)
    _hold_history(hist, jhist)
    assert int(got_opt["step"]) == steps and got_opt["step"].dtype == torch.int32
    _hold_params(got, jparams, _lr_sum(steps, warmup))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains 6 steps and checkpoints at 3 and 6; the port resumes from
    JAX's step 3 (float32 ``arrays.npz``) and continues within tolerance of
    JAX's clean run."""
    jmod, mod, jcfg, cfg, jp, _, jmake = _case("sasrec")
    steps, warmup = 6, 2
    tc = dict(steps=steps, warmup=warmup, log_every=1, ckpt_every=3)
    jtrainer = JTrainer(jmod, jcfg, train_cfg=JTrainConfig(**tc))
    jparams, _, jhist = jtrainer.fit(jmake, params=jp, opt_state=joptim.adamw_init(jp),
                                     ckpt_dir=str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax" / "step_0000000003", tmp_path / "port" / "step_0000000003")
    trainer = Trainer(mod, cfg, train_cfg=TrainConfig(**tc), device=CPU)
    got, got_opt, hist = trainer.fit(_port_batches(jmake, steps), ckpt_dir=str(tmp_path / "port"))
    assert hist[0]["step"] == 4 and int(got_opt["step"]) == steps
    _hold_history(hist, jhist[3:])
    _hold_params(got, jparams, _lr_sum(steps, warmup, first=3))


def test_train_step_matches_the_jax_train_cell_body():
    """``launch.train_step`` against the body of the JAX package's train cell
    (``build_step``: loss, grad, clip at 1.0, AdamW at lr_scale 1)."""
    jmod, mod, jcfg, cfg, jp, params, jmake = _case("qwen2")
    jopt = joptim.adamw_init(jp)
    opt = adamw_state_from_reference(_tree_np(jopt), params, CPU)

    def jstep(p, o, batch):
        loss, grads = jax.value_and_grad(lambda q: jlm.loss_fn(q, batch, jcfg))(p)
        grads, gn = joptim.clip_by_global_norm(grads, 1.0)
        p, o = joptim.adamw_update(p, grads, o, joptim.AdamWConfig())
        return p, o, {"loss": loss, "grad_norm": gn}

    batch = jmake(0)
    jparams, jopt, jm = jax.jit(jstep)(jp, jopt, batch)
    got, got_opt, m = train_step(mod, params, opt, {k: torch.from_numpy(np.asarray(v))
                                                    for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
    assert int(got_opt["step"]) == 1
    _hold_params(got, jparams, 1.0)


def test_accumulation_matches_one_batch():
    """``accum=2`` (two halves, gradients summed in float32, divided) against
    ``accum=1`` on a batch where every position counts."""
    _, mod, _, cfg, _, params, _ = _case("sasrec")
    rng = np.random.default_rng(4)
    batches = [{k: torch.from_numpy(rng.integers(1, cfg.vocab, (8, cfg.seq_len)).astype(np.int32))
                for k in ("seq", "pos", "neg")} for _ in range(4)]
    runs = {}
    for accum in (1, 2):
        trainer = Trainer(mod, cfg, train_cfg=TrainConfig(steps=4, warmup=1, log_every=1,
                                                          accum=accum), device=CPU)
        opt = optim.adamw_init(params)
        runs[accum] = trainer.fit(lambda s: batches[s], params=params, opt_state=opt)
    _hold_history(runs[2][2], runs[1][2])
    _hold_params(runs[2][0], runs[1][0], _lr_sum(4, 1))
    for a, b in zip(optim.tree_leaves(runs[2][0]), optim.tree_leaves(params)):
        assert a.dtype == b.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restart_is_bit_identical(tmp_path, dtype):
    """6 steps with a checkpoint every 3, against a run that fails at step 4
    and resumes from step 3: parameters and AdamW state equal bit for bit
    (bfloat16 LM parameters through the bf16 checkpoint)."""
    if dtype == "float32":
        mod, cfg = sasrec, sasrec_config.smoke_config()
        make = make_sasrec_batch_fn(cfg.vocab, 8, cfg.seq_len, device=CPU)
    else:
        mod, cfg = lm, dataclasses.replace(qwen2_1_5b.smoke_config(), dtype="bfloat16")
        make = make_lm_batch_fn(cfg.vocab, 4, 16, device=CPU)
    tc = dict(steps=6, ckpt_every=3, warmup=1, log_every=1)
    clean = Trainer(mod, cfg, train_cfg=TrainConfig(**tc), device=CPU)
    p_clean, o_clean, h_clean = clean.fit(make, ckpt_dir=str(tmp_path / "clean"))
    failing = Trainer(mod, cfg, train_cfg=TrainConfig(**tc, fail_at_step=4), device=CPU)
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        failing.fit(make, ckpt_dir=str(tmp_path / "crash"))
    resumed = Trainer(mod, cfg, train_cfg=TrainConfig(**tc), device=CPU)
    p, o, h = resumed.fit(make, ckpt_dir=str(tmp_path / "crash"))
    assert [x["step"] for x in h] == [4, 5, 6]
    assert [x["loss"] for x in h] == [x["loss"] for x in h_clean[3:]]
    for a, b in zip(optim.tree_leaves({"p": p, "o": o}), optim.tree_leaves({"p": p_clean,
                                                                            "o": o_clean})):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert optim.tree_leaves(p)[0].dtype == getattr(torch, dtype) or dtype == "float32"


def test_trainer_refuses_a_mesh_and_names_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(sasrec, sasrec_config.smoke_config(), device=CPU, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(sasrec, sasrec_config.smoke_config(), device=CPU, rules={})


@pytest.mark.parametrize("structured", [True, False])
def test_make_lm_batch_fn_invariants(structured):
    make = make_lm_batch_fn(97, 3, 11, structured=structured, device=CPU)
    a, b, c = make(5), make(5), make(6)
    for k in ("tokens", "targets"):
        assert a[k].dtype == torch.int32 and a[k].shape == (3, 11)
        assert torch.equal(a[k], b[k])
        assert int(a[k].min()) >= 0 and int(a[k].max()) < 97
    assert not torch.equal(a["tokens"], c["tokens"])
    want = (a["tokens"].long() * 7 + 3) % 97 if structured else torch.roll(a["tokens"], -1, 1)
    assert torch.equal(a["targets"].long(), want.long())


def test_adamw_state_from_reference_carries_and_refuses():
    _, _, _, cfg, jp, params, _ = _case("sasrec")
    jopt = jax.tree.map(np.asarray, joptim.adamw_init(jp))
    jopt["step"] = np.asarray(9, np.int32)
    jopt["m"]["pos_emb"] = np.full(jopt["m"]["pos_emb"].shape, 0.25, np.float32)
    opt = adamw_state_from_reference(jopt, params, CPU)
    assert int(opt["step"]) == 9 and opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    assert float(opt["m"]["pos_emb"][0, 0]) == 0.25 and isinstance(opt["v"]["blocks"], list)
    bad = dict(jopt, m=dict(jopt["m"], pos_emb=jopt["m"]["pos_emb"][:-1]))
    with pytest.raises(ValueError, match="shape"):
        adamw_state_from_reference(bad, params, CPU)
    bad = dict(jopt, v=dict(jopt["v"], item_emb=jopt["v"]["item_emb"].astype(np.float64)))
    with pytest.raises(TypeError, match="float32"):
        adamw_state_from_reference(bad, params, CPU)
    bad = dict(jopt, m={k: v for k, v in jopt["m"].items() if k != "pos_emb"})
    with pytest.raises(ValueError, match="differ"):
        adamw_state_from_reference(bad, params, CPU)
