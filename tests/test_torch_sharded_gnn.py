"""Port parity for GNN training on a process mesh: the edge lists split
over every rank, vertex state whole on each, the aggregation's combine on
``torch.distributed`` (``distributed/gnn.py``), under gloo on the CPU.

One spawn of 4 ranks (``tests/sharded_gnn_ranks.py`` is the rank side,
which imports no JAX) runs every multi-rank check on (2, 1), (1, 2) and
(2, 2) ``("data", "model")`` meshes under ``GNN_RULES``, where ``"edges"``
is every axis; the JAX package's one-device ``value_and_grad``, its
``Trainer`` and its ``build_step`` specs are computed while they run.  The
models are the four GNNs at their smoke configs: GIN and PNA classify
nodes, DimeNet and Equiformer regress graphs; JAX's ``init`` crosses with
``gnn_params_from_reference``; PNA's batch repeats its first 16 edges as
edges 32-47, so its max and min tie across ranks.  Tolerances, and why:

* Losses within ``LOSS_RTOL`` 1e-5 and every gradient leaf within
  ``GRAD_RTOL`` 1e-4 relative L2 (beside 1e-7 of the whole gradient's
  norm, ``tests/gnn_parity.py``'s rule) of JAX's one-device values and of
  the port's: the combined sums add the ranks' partials in another order.
* The combine alone: max and min values bit for bit one device's (an
  extremum picks an element); their gradients within ``TIE_RTOL`` 1e-6 of
  the largest, with ties split by the global count (the rank's own count
  would be off by 2x where a tie straddles ranks); degrees exact (whole
  floats); sums, means, std and the edge softmax within 1e-6 + 1e-5
  relative.
* ``Trainer`` on (2, 1), 3 steps: both ranks' parameters equal bit for bit
  (the gradients are all-reduced before clipping and AdamW), held to JAX's
  one-device ``Trainer`` by ``tests/test_torch_trainer.py``'s rule (every
  element within 2 lr Σ lr_scale, all but 1 % within rtol 1e-5: AdamW's
  step is ~±lr wherever a gradient element is near 0, and two sum orders
  may flip its sign).
  A restart from step 2: bit for bit (the CPU sums are deterministic).

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

from gnn_parity import GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, flat, numpy_tree
from repro import optim as joptim
from repro.configs import all_cells as jall_cells
from repro.configs import dimenet as jdimenet
from repro.configs import equiformer_v2 as jequiformer
from repro.configs import gin_tu as jgin
from repro.configs import pna as jpna
from repro.launch.mesh import single_device_mesh
from repro.launch.steps import build_step as jbuild_step
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import Trainer as JTrainer
from repro_torch import optim
from repro_torch.configs import dimenet, equiformer_v2, gin_tu, gnn_common, pna
from repro_torch.core import ProcessMesh
from repro_torch.distributed import GNN_RULES, edge_slice
from repro_torch.launch import train_layout
from repro_torch.models.gnn import gin as gin_model
from sharded_gnn_ranks import COMBINES, MODELS, STEPS, rank_main
from torch_parity import write_payload

SPAWN_LIMIT_S = 150   # ranks still running after this are killed: a hung rank fails
MESHES = [(2, 1), (1, 2), (2, 2)]
TIE_RTOL = 1e-6
SUM_ATOL, SUM_RTOL = 1e-6, 1e-5
PARAM_RTOL = 1e-5
FLIP_SHARE = 0.01
LR = optim.AdamWConfig().lr
N = 12                # the combine's nodes: 10 and 11 receive no edge
E = 80                # its edges: 40 and their copies, so ties straddle every split
JAX_CONFIGS = {"gin": jgin, "pna": jpna, "dimenet": jdimenet, "equiformer": jequiformer}


def _jax_cfg(name):
    cfg = JAX_CONFIGS[name].smoke_config()
    return dataclasses.replace(cfg, task="node", n_classes=8) if name == "gin" else cfg


def _batch(name, seed):
    """A smoke batch of ``name`` as numpy: GIN's a node task (8 classes,
    every fifth label -1); PNA's first 16 edges repeated at 32-47."""
    if name == "gin":
        b = gnn_common.gnn_smoke_batch(seed, task="node", n_classes=8, device="cpu")
        b["labels"][::5] = -1
    else:
        conf = {"pna": pna, "dimenet": dimenet, "equiformer": equiformer_v2}[name]
        b = conf.smoke_batch(seed, device="cpu")
    if name == "pna":
        for k in ("edge_src", "edge_dst"):
            b[k][32:48] = b[k][:16]
    return {k: v.numpy() for k, v in b.items()}


def _combine_inputs():
    """The combine's edges: destinations in [0, 10), the sentinel N and an
    id past it; small integer values (exact ties); edges 40-79 copy 0-39,
    so every tie of a copy straddles ranks on every mesh."""
    rng = np.random.default_rng(7)
    half = E // 2
    dst = rng.integers(0, N - 2, half).astype(np.int32)
    dst[:3] = N
    dst[3] = N + 4
    vals = rng.integers(-3, 4, (half, 3)).astype(np.float32)
    dst, vals = np.concatenate([dst, dst]), np.concatenate([vals, vals])
    sdst = np.minimum(dst, N)
    sdst[5] = N - 1                      # node N - 1 gets a real edge: a finite max
    scores = rng.normal(size=(E, 2)).astype(np.float32)
    scores[sdst >= N] = -1e30
    return {"n": N, "dst": dst, "vals": vals, "cot": rng.normal(size=(N, 3)).astype(np.float32),
            "sdst": sdst, "scores": scores,
            "scot": rng.normal(size=(E, 2)).astype(np.float32)}


def _payload(tmp):
    models, jax_state = {}, {}
    for name in MODELS:
        jmod, jcfg = JAX_CONFIGS[name].MODULE, _jax_cfg(name)
        jp = jmod.init(jax.random.PRNGKey(0), jcfg)
        batches = [_batch(name, s) for s in range(STEPS)]
        models[name] = {"params": numpy_tree(jp), "opt": numpy_tree(joptim.adamw_init(jp)),
                        "batch": batches[0], "batches": batches}
        jax_state[name] = (jmod, jcfg, jp)
    return {"models": models, "combine": _combine_inputs(), "ckpt_dir": str(tmp / "ckpt")}, \
        jax_state


def _jax_references(payload, jax_state):
    """JAX's one-device loss and gradients (one jit a model), its
    ``Trainer`` after ``STEPS`` steps, and its ``build_step`` specs of every
    GNN cell."""
    out = {"grads": {}, "train": {}}
    for name, (jmod, jcfg, jp) in jax_state.items():
        case = payload["models"][name]
        jb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        loss, g = jax.jit(jax.value_and_grad(lambda p: jmod.loss_fn(p, jb, jcfg)))(jp)
        out["grads"][name] = (float(loss), flat(g))
        tr = JTrainer(jmod, jcfg, train_cfg=JTrainConfig(steps=STEPS, warmup=1, log_every=1))
        p, _, hist = tr.fit(lambda s: {k: jnp.asarray(v) for k, v in case["batches"][s].items()},
                            params=jax.tree.map(jnp.array, jp), opt_state=joptim.adamw_init(jp))
        out["train"][name] = (numpy_tree(p), [h["loss"] for h in hist])
    spec = lambda tree: jax.tree.map(lambda s: tuple(s.spec), tree,  # noqa: E731
                                     is_leaf=lambda s: hasattr(s, "spec"))
    out["specs"] = {key: tuple(spec(t) for t in jbuild_step(cell, single_device_mesh())[2:])
                    for key, cell in jall_cells().items() if cell.family == "gnn"}
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(every rank's results, JAX's references, the payload)."""
    tmp = tmp_path_factory.mktemp("sharded_gnn")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 4, str(tmp / "init"),
                                                 str(tmp / "payload.pkl"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        payload, jax_state = _payload(tmp)
        write_payload(tmp / "payload.pkl", payload)
        want = _jax_references(payload, jax_state)
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


def _mesh_ranks(shape):
    return {(2, 1): [0, 1], (1, 2): [2, 3], (2, 2): [0, 1, 2, 3]}[shape]


def _hold_grads(loss, grads, want_loss, want):
    """The loss within ``LOSS_RTOL`` and every leaf within ``GRAD_RTOL``
    relative L2 (beside ``GRAD_FLOOR`` of the whole norm) of ``want``."""
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    got = flat(grads)
    assert got.keys() == want.keys()
    total = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want.values()))
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * float(np.linalg.norm(w)) + GRAD_FLOOR * total, (k, err)


def _same_bits(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ---------------------------------------------------------------- losses and gradients
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("shape", MESHES)
def test_loss_and_grads_match_jax(spawned, shape, name):
    """Every rank's sharded loss and gradients within ``LOSS_RTOL`` /
    ``GRAD_RTOL`` of JAX's one-device ``value_and_grad``; every rank of the
    mesh holds the same bits; the edges split over every mesh axis."""
    ranks, want, _ = spawned
    jloss, jgrads = want["grads"][name]
    first = ranks[_mesh_ranks(shape)[0]][shape]["grads"][name]
    assert first["edge_axes"] == ("data", "model") and first["parts"] == shape[0] * shape[1]
    for r in _mesh_ranks(shape):
        got = ranks[r][shape]["grads"][name]
        _hold_grads(got["loss"], got["grads"], jloss, jgrads)
        assert got["loss"] == first["loss"]
        _same_bits(got["grads"], first["grads"])


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("shape", MESHES)
def test_loss_and_grads_match_the_one_device_port(spawned, shape, name):
    """The same sharded values against the port's own one-device
    ``value_and_grad`` on the same parameters and batch."""
    for r in _mesh_ranks(shape):
        got = spawned[0][r][shape]["grads"][name]
        _hold_grads(got["loss"], got["grads"], got["one_loss"], flat(got["one_grads"]))


# ---------------------------------------------------------------- the combine alone
def _joined(ranks, shape, name, key):
    """A per-edge result of ``name`` joined from the mesh's ranks in the
    order of their ranges."""
    parts = sorted({(ranks[r][shape]["combine"]["lo"], r) for r in _mesh_ranks(shape)})
    return np.concatenate([ranks[r][shape]["combine"][name][key] for _, r in parts])


def test_ties_straddle_the_ranks(spawned):
    """The combine's data holds segments whose max ties across the two
    halves of the edge list, and ties within one quarter."""
    c = spawned[2]["combine"]
    dst, vals = c["dst"], c["vals"]
    seg_max = {d: vals[dst == d].max(axis=0) for d in set(dst.tolist()) if d < N}
    tied_at = [[e for e in range(E) if dst[e] == d and vals[e, 0] == m[0]]
               for d, m in seg_max.items()]
    assert any(min(t) < E // 2 <= max(t) for t in tied_at)
    assert any(len({e // (E // 4) for e in t}) < len(t) for t in tied_at)


@pytest.mark.parametrize("shape", MESHES)
def test_max_and_min_bit_for_bit_with_the_global_tie_split(spawned, shape):
    """``scatter_max`` / ``scatter_min`` combined over the ranks equal one
    device's bit for bit; their gradients, joined from the ranks, within
    ``TIE_RTOL`` of the largest."""
    ranks = spawned[0]
    for name in ("scatter_max", "scatter_min"):
        for r in _mesh_ranks(shape):
            c = ranks[r][shape]["combine"][name]
            np.testing.assert_array_equal(c["value"], c["one"], err_msg=name)
        one = ranks[_mesh_ranks(shape)[0]][shape]["combine"][name]["one_grad"]
        got = _joined(ranks, shape, name, "grad")
        assert np.abs(got - one).max() <= TIE_RTOL * np.abs(one).max(), name


@pytest.mark.parametrize("shape", MESHES)
def test_sums_degrees_and_softmax_combine(spawned, shape):
    """Degrees exact; sums, means, std and the edge softmax (values and
    gradients) within ``SUM_ATOL`` + ``SUM_RTOL`` of one device's."""
    ranks = spawned[0]
    for r in _mesh_ranks(shape):
        c = ranks[r][shape]["combine"]
        np.testing.assert_array_equal(c["degrees"]["value"], c["degrees"]["one"])
        for name in ("scatter_sum", "scatter_mean", "scatter_std"):
            np.testing.assert_allclose(c[name]["value"], c[name]["one"], rtol=SUM_RTOL,
                                       atol=SUM_ATOL, err_msg=name)
    head = ranks[_mesh_ranks(shape)[0]][shape]["combine"]
    for name in COMBINES:
        if name in ("degrees", "scatter_max", "scatter_min"):
            continue
        got = _joined(ranks, shape, name, "grad")
        np.testing.assert_allclose(got, head[name]["one_grad"], rtol=SUM_RTOL, atol=SUM_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(_joined(ranks, shape, "segment_softmax", "value"),
                               head["segment_softmax"]["one"], rtol=SUM_RTOL, atol=SUM_ATOL)


# ---------------------------------------------------------------- the trainer
def _hold_params(got, want, lr_sum):
    """``tests/test_torch_trainer.py``'s rule: every element within 2 lr ·
    lr_sum (+ rtol 1e-5), and all but ``FLIP_SHARE`` of them within rtol
    1e-5."""
    far = total = 0
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert (d <= 2 * LR * lr_sum + PARAM_RTOL * np.abs(w)).all(), (k, float(d.max()))
        far += int((d > PARAM_RTOL * np.abs(w) + 1e-7).sum())
        total += d.size
    assert far <= FLIP_SHARE * total, (far, total)


def _lr_sum(steps, warmup):
    return sum(float(optim.warmup_cosine(torch.tensor(s), warmup=warmup, total=max(steps, 2)))
               for s in range(steps))


@pytest.mark.parametrize("name", MODELS)
def test_trainer_on_two_one_matches_jax(spawned, name):
    """``Trainer(mesh=(2, 1), rules=GNN_RULES)``, 3 steps: both ranks'
    parameters and AdamW state equal bit for bit; held to JAX's one-device
    ``Trainer`` and to the port's by ``_hold_params``, the losses within
    ``LOSS_RTOL``."""
    ranks, want, _ = spawned
    jparams, jlosses = want["train"][name]
    a, b = ranks[0]["train"][name], ranks[1]["train"][name]
    _same_bits(a["sharded"], b["sharded"])
    for ref_params, ref_losses in ((jparams, jlosses),
                                   (a["one_device"]["params"], a["one_device"]["losses"])):
        np.testing.assert_allclose(a["sharded"]["losses"], ref_losses, rtol=LOSS_RTOL)
        _hold_params(a["sharded"]["params"], ref_params, _lr_sum(STEPS, 1))
    assert len(a["sharded"]["losses"]) == STEPS


def test_trainer_restart_is_bit_for_bit(spawned):
    """GIN on (2, 1), a checkpoint every 2 steps, a failure injected at
    step 2 on both ranks, resumed from step 2: parameters, AdamW state and
    the resumed loss equal the clean run's bit for bit."""
    for rank in (0, 1):
        r = spawned[0][rank]["restart"]
        assert r["crash"] == "RuntimeError: injected failure at step 2"
        _same_bits(r["resumed"], r["clean"])
        assert r["resumed_steps"] == [3]
        assert r["resumed_losses"] == r["clean_losses"][2:]


# ---------------------------------------------------------------- build_step
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_build_step_specs_equal_jax(spawned, shape):
    """All 16 GNN train cells: ``build_step`` on the process mesh returns
    ``in_specs`` / ``out_specs`` equal to the JAX package's (nodes over
    ``data``, edges over both axes, parameters whole)."""
    ranks, want, _ = spawned
    for r in _mesh_ranks(shape)[:2]:
        got = ranks[r]["cells", shape]
        assert len(got) == 16 and got.keys() == want["specs"].keys()
        for key, specs in want["specs"].items():
            assert got[key] == specs, key


def test_build_step_fn_is_the_sharded_step(spawned):
    """gin-tu/molecule's ``fn`` on (2, 1) at the smoke config: one step from
    JAX's state near the port's one-device ``train_step`` (``_hold_params``
    for one step), the same on both ranks."""
    a, b = spawned[0][0]["cell step"], spawned[0][1]["cell step"]
    _same_bits(a["params"], b["params"])
    assert abs(a["loss"] - a["one_loss"]) <= LOSS_RTOL * abs(a["one_loss"])
    _hold_params(a["params"], a["one_params"], 1.0)


# ---------------------------------------------------------------- one process
def _fake_mesh(shape, rank):
    """A process mesh without a group: enough for placement, no collective."""
    return ProcessMesh(shape=shape, axis_names=("data", "model"), rank=rank,
                       device=torch.device("cpu"), backend="gloo")


def test_edge_slice_ranges_and_the_layout():
    """Each rank of (2, 2) takes its contiguous quarter of the edge list in
    row-major order; an uneven split raises; ``train_layout`` gives a GNN
    the rules' ``"edges"`` axes, and a model splitting neither rows nor
    edges raises on a mesh of two."""
    for rank in range(4):
        m = _fake_mesh((2, 2), rank)
        part = edge_slice(m, ("data", "model"), 64)
        assert (part.lo, part.hi, part.parts) == (16 * rank, 16 * rank + 16, 4)
        x = torch.arange(64)
        assert torch.equal(part.take(x), x[16 * rank:16 * rank + 16])
    with pytest.raises(ValueError, match="does not split evenly"):
        edge_slice(_fake_mesh((2, 2), 0), ("data", "model"), 66)
    lay = train_layout(gin_model, gin_tu.smoke_config(), _fake_mesh((1, 2), 1), GNN_RULES)
    assert lay.edge_axes == ("data", "model") and lay.edge_parallel == 2
    assert lay.batch_axes == ("data",)

    class NoSplit:
        param_specs = staticmethod(gin_model.param_specs)
        param_shapes = staticmethod(gin_model.param_shapes)

    with pytest.raises(TypeError, match="neither"):
        train_layout(NoSplit, gin_tu.smoke_config(), _fake_mesh((2, 1), 0), GNN_RULES)
