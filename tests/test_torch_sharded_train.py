"""Port parity for sharded training on a process mesh: ``Trainer(mesh=,
rules=)`` one rank a process under gloo on the CPU, ``compressed_psum``,
``elastic_restore`` across mesh shapes, and the placement helpers.

One spawn of 4 ranks (``tests/sharded_train_ranks.py`` is the rank side,
which imports no JAX) runs every multi-rank check; the JAX package's
single-device ``Trainer`` runs and the 4-device ``compressed_psum`` (a
subprocess) are computed while it runs.  The models are the tiny LM of
``tests/test_distributed.py`` and SASRec's smoke config, their weights and
AdamW state carried over from JAX's ``init``.  Tolerances, and why:

* (1, 2) ``("data", "model")``: the batch axes have size 1, so every rank
  runs the one-device body on gathered parameters: bit for bit the port's
  one-device ``Trainer``.
* (2, 1): each rank back-props its rows' masked sums over the global
  counts and the float32 gradients are all-reduced, a sum in another order:
  parameters within ``ATOL`` (2e-5, ``tests/test_distributed.py``'s
  accumulation tolerance) of JAX's ``Trainer`` on one device, losses within
  ``LOSS_RTOL``.  The batches give the two ranks different counts of
  unmasked positions; with ``accum`` 3 over 6 rows the middle microbatch
  spans both ranks.
* Restart and ``elastic_restore``: bit for bit.
* ``compressed_psum``: bit for bit JAX's ``shard_map`` over 4 CPU devices
  (the same float32 operations in the same order, round half to even).

A rank still running after ``SPAWN_LIMIT_S`` is killed and the tests fail.
"""
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.configs import sasrec as jsasrec_config
from repro.data.recsys import make_sasrec_batch_fn as jmake_sasrec_batch_fn
from repro.configs import all_cells as jall_cells
from repro.launch.mesh import single_device_mesh
from repro.launch.steps import build_step as jbuild_step
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import Trainer as JTrainer
from repro.models import sasrec as jsasrec
from repro.models import transformer_lm as jlm
from repro_torch.configs import sasrec as sasrec_config
from repro_torch.core import ProcessMesh, make_mesh
from repro_torch.distributed import (
    RECSYS_RULES,
    PartitionSpec,
    axis_rules,
    logical_to_spec,
    shard_block,
    shard_tree,
    spec_tree,
)
from repro_torch.launch import Trainer
from repro_torch.models import sasrec
from sharded_train_ranks import rank_main
from torch_parity import numpy_tree, write_payload

ATOL = 2e-5          # tests/test_distributed.py's accumulation tolerance
LOSS_RTOL = 1e-5
SPAWN_LIMIT_S = 150  # ranks still running after this are killed: a hung rank fails
STEPS = {"one_two": 3, "two_one": 2, "restart": 4}
TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
            d_ff=64, vocab=101, dtype="float32", kv_block=8)
# (model, accum, batches): the (2, 1) runs, held to the port's one-device
# Trainer; all but the last LM case to JAX's too
TWO_ONE = [("lm", 1, "batches"), ("lm", 2, "batches"), ("sasrec", 1, "batches"),
           ("sasrec", 2, "batches"), ("lm", 3, "batches6")]
HELD_TO_JAX = TWO_ONE[:4]
SERVING_CELLS = [("sasrec", "serve_p99"), ("sasrec", "serve_bulk"), ("sasrec", "retrieval_cand"),
                 ("qwen2-1.5b", "prefill_32k"), ("qwen2-1.5b", "decode_32k"),
                 ("qwen2-1.5b", "long_500k")]


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return numpy_tree(tree)


def _lm_batches(rows, steps):
    """Batches of ``rows`` x 16 tokens below 101, the targets the next token
    (``tests/test_distributed.py``'s form) masked unevenly: row 0 keeps 2 of
    16, row 1 keeps 8, row 4 keeps 5."""
    rng = np.random.default_rng(rows)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, 101, (rows, 16)).astype(np.int32)
        tgt = np.roll(toks, -1, axis=1)
        tgt[0, 2:] = -1
        tgt[1, 8:] = -1
        if rows > 4:
            tgt[4, :11] = -1
        out.append({"tokens": toks, "targets": tgt})
    return out


def _payload(tmp_path):
    jcfg = jsasrec_config.smoke_config()
    jp_s = jsasrec.init(jax.random.PRNGKey(0), jcfg)
    jmake = jmake_sasrec_batch_fn(jcfg.vocab, 8, jcfg.seq_len)
    s_batches = [{k: np.array(v) for k, v in jmake(s).items()} for s in range(4)]
    for b in s_batches:
        b["pos"][0, :6] = 0  # row 0 (rank 0's on (2, 1)) loses 6 more positives
    lcfg = jlm.LMConfig(**TINY)
    jp_l = jax.jit(jlm.init, static_argnums=(1,))(jax.random.PRNGKey(0), lcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 32)))
    return {
        "steps": STEPS, "two_one": TWO_ONE, "ckpt_dir": str(tmp_path / "ckpt"), "psum_x": x,
        "serving_cells": SERVING_CELLS,
        "sasrec": {"params": _tree_np(jp_s), "opt": _tree_np(joptim.adamw_init(jp_s)),
                   "batches": s_batches},
        "lm": {"cfg": TINY, "params": _tree_np(jp_l), "opt": _tree_np(joptim.adamw_init(jp_l)),
               "batches": _lm_batches(4, 4), "batches6": _lm_batches(6, 4)},
    }, {"sasrec": (jsasrec, jcfg, jp_s), "lm": (jlm, lcfg, jp_l)}


PSUM_CODE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, use_mesh
from repro.optim import compressed_psum
mesh = make_mesh((4,), ("pod",))
x = jax.random.normal(jax.random.PRNGKey(0), (4, 32))
f = shard_map(lambda a: compressed_psum(a[0], "pod")[None],
              mesh=mesh, in_specs=P("pod"), out_specs=P("pod"))
with use_mesh(mesh):
    got = f(x)
np.save(os.environ["PSUM_OUT"], np.asarray(got))
"""


def _jax_fit(jmod, jcfg, jp, batches, accum, steps):
    tr = JTrainer(jmod, jcfg, train_cfg=JTrainConfig(steps=steps, warmup=1, accum=accum,
                                                     log_every=1))
    p, _, hist = tr.fit(lambda s: {k: jnp.asarray(v) for k, v in batches[s].items()},
                        params=jax.tree.map(jnp.array, jp),
                        opt_state=joptim.adamw_init(jp))
    return _tree_np(p), [h["loss"] for h in hist]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(every rank's results, JAX's (2, 1) references, JAX's 4-device
    ``compressed_psum``)."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    psum = subprocess.Popen([sys.executable, "-c", PSUM_CODE], cwd=root,
                            env={**os.environ, "PYTHONPATH": "src",
                                 "PSUM_OUT": str(tmp / "psum.npy")},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, 4, str(tmp / "init"),
                                                 str(tmp / "payload.pkl"), str(tmp)))
             for r in range(4)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        payload, jax_models = _payload(tmp)
        write_payload(tmp / "payload.pkl", payload)
        want = {}
        for name, accum, key in HELD_TO_JAX:
            jmod, jcfg, jp = jax_models[name]
            want[(name, accum)] = _jax_fit(jmod, jcfg, jp, payload[name][key], accum,
                                           STEPS["two_one"])
        _, err = psum.communicate(timeout=SPAWN_LIMIT_S)
        assert psum.returncode == 0, err[-2000:]
        jpsum = np.load(tmp / "psum.npy")
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if psum.poll() is None:
            psum.kill()
    errs = sorted(tmp.glob("rank*.err"))
    assert not errs, errs[0].read_text()
    assert not hung, f"ranks {hung} still running after {SPAWN_LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0] * 4
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return ranks, want, jpsum, payload


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# ---------------------------------------------------------------- (1, 2)
@pytest.mark.parametrize("rank", [0, 1])
def test_one_two_is_the_one_device_trainer_bit_for_bit(spawned, rank):
    """SASRec on (1, 2), 3 steps: the gathered parameters, AdamW state,
    losses and norms equal the port's one-device ``Trainer``'s bit for bit."""
    run = spawned[0][rank]["one_two"]
    _same_bits(run["sharded"]["params"], run["one_device"]["params"])
    _same_bits(run["sharded"]["opt"], run["one_device"]["opt"])
    assert run["sharded"]["losses"] == run["one_device"]["losses"]
    assert run["sharded"]["norms"] == run["one_device"]["norms"]
    assert len(run["sharded"]["losses"]) == STEPS["one_two"]


@pytest.mark.parametrize("rank", [0, 1])
def test_init_state_keeps_the_ranks_block(spawned, rank):
    """``init_state`` on (1, 2): the item table's rows ``rank`` half of the
    one-device init, bit for bit; every other leaf whole."""
    init = spawned[0][rank]["init"]
    blocks, whole = _leaves(init["blocks"]), _leaves(init["whole"])
    assert set(blocks) == set(whole)
    for k, w in whole.items():
        if k == "/item_emb":
            half = w.shape[0] // 2
            np.testing.assert_array_equal(blocks[k], w[rank * half:(rank + 1) * half])
        else:
            np.testing.assert_array_equal(blocks[k], w, err_msg=k)


def _jax_specs(tree):
    """A tree of JAX ``NamedSharding``s as tuples."""
    return jax.tree.map(lambda s: tuple(s.spec), tree, is_leaf=lambda s: hasattr(s, "spec"))


def test_errors_on_a_two_rank_mesh(spawned):
    """The tiny LM's 101 vocabulary rows do not split over ``model``: the
    error names the leaf; a GNN train cell on a 2-rank mesh builds its
    layout (the edges split over both axes) and its step, with JAX's
    specs; every LM and SASRec serving cell returns its sharded step, with
    ``in_specs`` / ``out_specs`` equal to the JAX package's
    ``build_step``'s."""
    for rank in (0, 1):
        e = spawned[0][rank]["errors"]
        assert e["lm uneven"].startswith("ValueError: /embed: dim 0 of size 101"), e["lm uneven"]
        assert e["gnn train"] == "", e["gnn train"]
        assert spawned[0][rank]["gnn edge axes"] == ("data", "model")
        _, _, jin, jout = jbuild_step(jall_cells()[("gin-tu", "molecule")], single_device_mesh())
        assert spawned[0][rank]["gnn specs"] == (_jax_specs(jin), _jax_specs(jout))
        for cell in SERVING_CELLS:
            ins, outs = spawned[0][rank]["serving specs"][cell]
            _, _, jin, jout = jbuild_step(jall_cells()[cell], single_device_mesh())
            assert ins == _jax_specs(jin) and outs == _jax_specs(jout), cell


# ---------------------------------------------------------------- (2, 1)
@pytest.mark.parametrize("case", [f"{m}-accum{a}" for m, a, _ in HELD_TO_JAX])
def test_two_one_matches_jax(spawned, case):
    """On (2, 1) every rank's gathered parameters after 2 steps are within
    ``ATOL`` of JAX's one-device ``Trainer``, the losses within
    ``LOSS_RTOL``; both ranks end identical; the ranks held different counts
    of unmasked positions."""
    ranks, want, _, payload = spawned
    name, accum = case.split("-accum")
    accum = int(accum)
    jparams, jlosses = want[(name, accum)]
    key = dict((f"{m}-{a}", k) for m, a, k in TWO_ONE)[f"{name}-{accum}"]
    b0 = payload[name][key][0]
    mask = b0["targets"] >= 0 if name == "lm" else b0["pos"] > 0
    half = mask.shape[0] // 2
    assert mask[:half].sum() != mask[half:].sum()
    for rank in (2, 3):
        run = ranks[rank]["two_one"][(name, accum)]["sharded"]
        np.testing.assert_allclose(run["losses"], jlosses, rtol=LOSS_RTOL)
        got, exp = _leaves(run["params"]), _leaves(jparams)
        assert set(got) == set(exp)
        for k, w in exp.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL, err_msg=k)
    _same_bits(ranks[2]["two_one"][(name, accum)]["sharded"],
               ranks[3]["two_one"][(name, accum)]["sharded"])


@pytest.mark.parametrize("case", [f"{m}-accum{a}" for m, a, _ in TWO_ONE])
def test_two_one_near_the_one_device_port(spawned, case):
    """The (2, 1) run against the port's own one-device ``Trainer`` on the
    same state and batches: parameters within ``ATOL``, losses within
    ``LOSS_RTOL`` (the gradient sum runs in another order).  With ``accum``
    3 over 6 rows, microbatch 1 (rows 2-3) spans both ranks' rows (0-2,
    3-5)."""
    name, accum = case.split("-accum")
    run = spawned[0][2]["two_one"][(name, int(accum))]
    np.testing.assert_allclose(run["sharded"]["losses"], run["one_device"]["losses"],
                               rtol=LOSS_RTOL)
    got, exp = _leaves(run["sharded"]["params"]), _leaves(run["one_device"]["params"])
    for k, w in exp.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL, err_msg=k)


def test_restart_is_bit_for_bit(spawned):
    """SASRec on (2, 1), a checkpoint every 2 steps, a failure injected at
    step 3 on both ranks, resumed from step 2: parameters, AdamW state and
    the resumed losses equal the clean run's bit for bit."""
    for rank in (2, 3):
        r = spawned[0][rank]["restart"]
        assert r["crash"] == "RuntimeError: injected failure at step 3"
        _same_bits(r["resumed"], r["clean"])
        assert r["resumed_steps"] == [3, 4]
        assert r["resumed_losses"] == r["clean_losses"][2:]


# ---------------------------------------------------------------- elastic
def _saved(spawned):
    return spawned[0][2]["restart"]["clean"]


@pytest.mark.parametrize("rank", [0, 1])
def test_elastic_restore_onto_one_two(spawned, rank):
    """The (2, 1) run's step-4 checkpoint restored on (1, 2): the item
    table's rows ``rank`` half (and its moments'), every other leaf whole,
    bit for bit the saved leaves."""
    got = spawned[0][rank]["elastic"]["one_two"]
    assert got["step"] == STEPS["restart"] and got["coords"] == (0, rank)
    saved, blocks = _leaves(_saved(spawned)), _leaves(got["tree"])
    assert set(saved) == set(blocks)
    for k, w in saved.items():
        if k.endswith("/item_emb"):
            half = w.shape[0] // 2
            w = w[rank * half:(rank + 1) * half]
        np.testing.assert_array_equal(blocks[k], w, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_elastic_restore_onto_one_rank(spawned, rank):
    """The same checkpoint on a (1, 1) mesh carved over this rank alone:
    every leaf whole, bit for bit."""
    got = spawned[0][rank]["elastic"]
    assert got["alone_shape"] == (1, 1) and got["alone"]["step"] == STEPS["restart"]
    _same_bits(got["alone"]["tree"], _saved(spawned))


# ---------------------------------------------------------------- compressed_psum
def test_compressed_psum_equals_jax_bit_for_bit(spawned):
    """``compressed_psum`` over a ``("pod",)`` mesh of 4 ranks: every rank's
    result bit for bit JAX's 4-device ``shard_map`` result, within a scale
    of the true mean."""
    ranks, _, jpsum, payload = spawned
    x = payload["psum_x"]
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["psum"], jpsum[r])
    assert np.abs(ranks[0]["psum"] - x.mean(axis=0)).max() <= np.abs(x).max() / 127 * 1.01


# ---------------------------------------------------------------- one process
def _fake_mesh(shape, rank):
    """A process mesh without a group: enough for placement, no collective."""
    return ProcessMesh(shape=shape, axis_names=("data", "model"), rank=rank,
                       device=torch.device("cpu"), backend="gloo")


def test_shard_block_places_row_major_and_raises():
    """A leaf split over two axes at once takes the row-major digits of the
    rank's coordinates; an uneven split names the leaf; a mesh axis used
    twice and an axis the mesh lacks raise."""
    x = torch.arange(8 * 3).reshape(8, 3)
    for rank in range(4):
        m = _fake_mesh((2, 2), rank)
        got = shard_block(x, PartitionSpec(("data", "model"), None), m)
        assert torch.equal(got, x[2 * rank:2 * rank + 2])
        got = shard_block(x, PartitionSpec(("model", "data"), None), m)
        d, mo = m.coords
        assert torch.equal(got, x[2 * (mo * 2 + d):2 * (mo * 2 + d) + 2])
    m = _fake_mesh((2, 2), 1)
    assert torch.equal(shard_block(x, PartitionSpec("data", "model"), _fake_mesh((2, 1), 1)),
                       x[4:])
    with pytest.raises(ValueError, match="/blocks/0/w: dim 1 of size 3 does not split"):
        shard_tree({"blocks": [{"w": x}]}, {"blocks": [{"w": PartitionSpec(None, "model")}]}, m)
    with pytest.raises(ValueError, match="uses a mesh axis twice"):
        shard_block(x, PartitionSpec("data", ("data",)), m)
    with pytest.raises(ValueError, match="no mesh axis 'pod'"):
        shard_block(x, PartitionSpec("pod", None), m)


def test_trainer_mesh_arguments():
    """A ShardMesh of more than one position raises ``TypeError``; a
    one-position ShardMesh with rules trains on one device, equal to no
    mesh; ``mesh=None`` with rules is the one-device trainer too."""
    cfg = sasrec_config.smoke_config()
    with pytest.raises(TypeError, match="one shard a process"):
        Trainer(sasrec, cfg, device="cpu",
                mesh=make_mesh((2,), ("data",), devices=["cpu"] * 2), rules=RECSYS_RULES)
    one = Trainer(sasrec, cfg, device="cpu", mesh=make_mesh((1, 1), ("data", "model"),
                                                             devices=["cpu"]),
                  rules=RECSYS_RULES)
    assert one.layout is None and one.mesh is None
    assert Trainer(sasrec, cfg, device="cpu", rules=RECSYS_RULES).layout is None


def test_spec_tree_and_partition_spec():
    """``spec_tree`` keeps dicts and lists, maps ``()`` to a 0-d spec; a
    one-axis tuple equals its axis, ``()`` equals ``None``, as JAX compares."""
    m = _fake_mesh((1, 2), 0)
    with axis_rules(RECSYS_RULES, m):
        tree = spec_tree({"a": ("vocab_rows", "embed"), "b": [(), ("batch",)]})
    assert tree == {"a": ("model", None), "b": [(), (("data",),)]}
    assert tree["b"][1] == ("data",) and tuple(tree["b"][1]) == (("data",),)
    assert PartitionSpec(()) == PartitionSpec(None) and hash(PartitionSpec(("x",))) == hash(
        PartitionSpec("x"))
    assert logical_to_spec("batch") == (None,)
    with axis_rules(RECSYS_RULES, m):
        assert spec_tree(sasrec.param_specs(sasrec_config.smoke_config()))["item_emb"] == (
            "model", None)
