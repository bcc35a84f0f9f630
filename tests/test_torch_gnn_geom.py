"""Port parity for the geometric GNNs: real spherical harmonics
(``models/gnn/sh.py``), DimeNet and Equiformer-v2 (both branches of
``compact_messages``), against the JAX package on the CPU with numpy inputs
from a seed; JAX's parameters cross with ``gnn_params_from_reference``.

Tolerances, and why:

* Spherical harmonics within 1e-5 of JAX's (float32 recursions to l = 6
  with the same operation order; the two libraries' sqrt and division
  round alike, their fused forms may not).  ``sh_index_table`` and
  ``linspace`` exact.
* Losses within relative 1e-5 and every gradient leaf within relative L2
  1e-4 of JAX's, or within 1e-7 of the whole gradient's norm where a leaf's
  gradient vanishes analytically (Equiformer's attention bias ``b2``: the
  edge softmax is invariant to a shift of all its logits, so both packages'
  values are rounding noise ~1e-8); observed up to ~4e-6.
* Where JAX's DimeNet gradient is not finite (a self-loop's zero vector, a
  triplet whose cosine reaches 1) the port's is finite and every value
  equal to JAX's forward within the same limits.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from gnn_parity import hold_loss_and_grads, numpy_tree

from repro.configs import dimenet as jdimenet_config
from repro.configs import equiformer_v2 as jequiformer_config
from repro.models.gnn import sh as jsh
from repro_torch.configs import dimenet, equiformer_v2
from repro_torch.core.convert import gnn_params_from_reference
from repro_torch.models.gnn import equiformer_v2 as eqv2
from repro_torch.models.gnn import sh

CPU = "cpu"
SH_ATOL = 1e-5


def _unit_vectors(seed, k=64):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(k, 3)).astype(np.float32)
    u[:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0, 0, 0], [1e-20, 0, 1]]
    n = np.linalg.norm(u, axis=-1, keepdims=True)
    return np.where(n > 0, u / np.maximum(n, 1e-30), u).astype(np.float32)


@pytest.mark.parametrize("lmax", [0, 1, 2, 4, 6])
def test_real_sph_harm_matches_jax(lmax):
    """Random unit vectors, the poles, the axes and the zero vector (a
    self-loop's direction)."""
    u = _unit_vectors(lmax)
    want = np.asarray(jsh.real_sph_harm(lmax, jnp.asarray(u)))
    got = sh.real_sph_harm(lmax, torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (len(u), (lmax + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=SH_ATOL, atol=SH_ATOL)
    np.testing.assert_array_equal(sh.sh_index_table(lmax), jsh.sh_index_table(lmax))


def test_real_sph_harm_gradient_matches_jax():
    u = _unit_vectors(9)[6:]           # away from the poles
    cot = np.random.default_rng(9).normal(size=(len(u), 49)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jsh.real_sph_harm(6, v), jnp.asarray(u))
    (want,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(u).requires_grad_(True)
    (got,) = torch.autograd.grad(sh.real_sph_harm(6, t), t, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("num", [2, 3, 6, 8, 16, 33])
def test_linspace_matches_jax(num):
    """Bit for bit at n_radial = 8 (the radial centres Equiformer uses) and
    at 2, 3, 6 and 33; within one float32 ulp elsewhere (XLA fuses its
    jitted formula)."""
    got = eqv2.linspace(0.0, 5.0, num).numpy()
    want = np.asarray(jnp.linspace(0.0, 5.0, num))
    if num in (2, 3, 6, 8, 33):
        np.testing.assert_array_equal(got, want)
    assert np.max(np.abs(got.view(np.int32) - want.view(np.int32))) <= 1


# ----------------------------------------------------------------------
# DimeNet
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["smoke", "node", "seed1"])
def test_dimenet_loss_and_gradients_match_jax(variant):
    """The smoke config (graph regression; its batch holds a self-loop and
    two triplets with t_kj == t_ji, where both gradients stay finite), a
    node-regression variant, and another seed's batch with padded
    triplets (t = E)."""
    jcfg, pcfg = jdimenet_config.smoke_config(), dimenet.smoke_config()
    batch = dimenet.smoke_batch(0 if variant != "seed1" else 1, device=CPU)
    if variant == "node":
        jcfg = dataclasses.replace(jcfg, task="node")
        pcfg = dataclasses.replace(pcfg, task="node")
        batch["labels"] = torch.from_numpy(
            np.random.default_rng(4).normal(size=24).astype(np.float32))
    if variant == "seed1":
        E = batch["edge_src"].shape[0]
        batch["t_kj"][::7] = E
        batch["t_ji"][3::11] = E
    hold_loss_and_grads(jdimenet_config.MODULE, jcfg, dimenet.MODULE, pcfg, batch)


def _degenerate_batch():
    """A self-loop edge inside a triplet (a zero vector) and a triplet whose
    two edges are one edge (cosine exactly 1)."""
    b = dimenet.smoke_batch(0, device=CPU)
    b["edge_src"][0] = b["edge_dst"][0] = 3
    b["t_kj"][0] = 0
    b["t_kj"][1] = b["t_ji"][1] = 5
    b["pos"][b["edge_src"][5]] = torch.tensor([0.0, 0.0, 0.0])
    b["pos"][b["edge_dst"][5]] = torch.tensor([1.0, 2.0, 2.0])   # |v| = 3: cos = 9/9
    return b


def _pos_grads(batch, key=0):
    """DimeNet's loss and its gradient with respect to the positions (the
    forces' direction), in JAX and in the port, from the same parameters."""
    jcfg, pcfg = jdimenet_config.smoke_config(), dimenet.smoke_config()
    jparams = jdimenet_config.MODULE.init(jax.random.PRNGKey(key), jcfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda pos: jdimenet_config.MODULE.loss_fn(jparams, dict(jb, pos=pos), jcfg)))(jb["pos"])
    params = gnn_params_from_reference(numpy_tree(jparams), pcfg, device=CPU)
    pos = batch["pos"].clone().requires_grad_(True)
    pl = dimenet.MODULE.loss_fn(params, dict(batch, pos=pos), pcfg)
    (pg,) = torch.autograd.grad(pl, pos)
    return float(jl), np.asarray(jg), float(pl), pg.numpy()


def test_dimenet_position_gradient_matches_jax():
    """d loss / d pos on a batch with no degenerate triplet: the smoke
    batch's triplets through its self-loop and those with t_kj == t_ji are
    replaced by a copy of a regular one.  (Padding would not do: a padded
    triplet reads edge E - 1 twice, a cosine of 1, and JAX's position
    gradient is then NaN.)"""
    b = dimenet.smoke_batch(0, device=CPU)
    loop = torch.nonzero(b["edge_src"] == b["edge_dst"])[:, 0]
    bad = (b["t_kj"] == b["t_ji"]) | torch.isin(b["t_kj"], loop) | torch.isin(b["t_ji"], loop)
    good = int(torch.nonzero(~bad)[0, 0])
    b["t_kj"][bad], b["t_ji"][bad] = b["t_kj"][good], b["t_ji"][good]
    jl, jg, pl, pg = _pos_grads(b)
    assert abs(pl - jl) <= 1e-5 * abs(jl) and np.all(np.isfinite(jg))
    assert np.linalg.norm(pg - jg) <= 1e-4 * np.linalg.norm(jg)


def test_dimenet_gradients_stay_finite_where_jax_gives_nan():
    """A zero vector's norm and arccos at its clip point: JAX's position
    gradient holds NaN there, the port's is finite; the losses agree and so
    does every parameter gradient (the geometry holds no parameter)."""
    batch = _degenerate_batch()
    jl, jg, pl, pg = _pos_grads(batch)
    assert not np.all(np.isfinite(jg))
    assert np.all(np.isfinite(pg)) and abs(pl - jl) <= 1e-5 * abs(jl)
    hold_loss_and_grads(jdimenet_config.MODULE, jdimenet_config.smoke_config(),
                        dimenet.MODULE, dimenet.smoke_config(), batch)


def test_dimenet_angle_is_arccos_of_the_clipped_cosine():
    c = torch.tensor([-1.5, -1.0, -0.3, 0.0, 0.7, 1.0, np.nextafter(np.float32(1), 2)],
                     requires_grad=True)
    a = dimenet.MODULE._angle(c)
    np.testing.assert_array_equal(
        a.detach().numpy(), np.asarray(jnp.arccos(jnp.clip(jnp.asarray(c.detach().numpy()),
                                                           -1.0, 1.0))))
    (g,) = torch.autograd.grad(a.sum(), c)
    assert torch.isfinite(g).all() and float(g[0]) == float(g[1]) == float(g[5]) == 0.0
    assert float(g[2]) == pytest.approx(-1 / np.sqrt(1 - 0.09), rel=1e-6)


# ----------------------------------------------------------------------
# Equiformer-v2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("variant", ["smoke", "node", "sentinel"])
def test_equiformer_loss_and_gradients_match_jax(compact, variant):
    """Both branches of ``compact_messages`` on the smoke config (graph
    regression), a node-classification variant (7 classes, a label -1) and
    a batch with sentinel edges into a node that also has real ones."""
    jcfg = dataclasses.replace(jequiformer_config.smoke_config(), compact_messages=compact)
    pcfg = dataclasses.replace(equiformer_v2.smoke_config(), compact_messages=compact)
    batch = equiformer_v2.smoke_batch(0, device=CPU)
    if variant == "node":
        jcfg = dataclasses.replace(jcfg, task="node", n_classes=7)
        pcfg = dataclasses.replace(pcfg, task="node", n_classes=7)
        labels = np.random.default_rng(5).integers(0, 7, 24).astype(np.int32)
        labels[::6] = -1
        batch["labels"] = torch.from_numpy(labels)
    if variant == "sentinel":
        n = batch["node_feat"].shape[0]
        batch["edge_dst"][:4] = n
        batch["edge_src"][4:6] = n
        batch["edge_dst"][6] = n - 1   # the node the sentinels' softmax reads
    hold_loss_and_grads(jequiformer_config.MODULE, jcfg, equiformer_v2.MODULE, pcfg, batch)


def test_equiformer_full_width_forward_matches_jax():
    """The full config's widths (l_max 6, m_max 2, 8 heads, d 128) cut to
    2 layers, forward only, on the smoke batch."""
    jcfg = dataclasses.replace(jequiformer_config.full_config(), n_layers=2, task="graph",
                               n_graphs=4)
    pcfg = dataclasses.replace(equiformer_v2.full_config(), n_layers=2, task="graph",
                               n_graphs=4)
    batch = equiformer_v2.smoke_batch(0, device=CPU)
    jparams = jequiformer_config.MODULE.init(jax.random.PRNGKey(1), jcfg)
    want = jax.jit(lambda p, b: jequiformer_config.MODULE.forward(p, b, jcfg))(
        jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    params = gnn_params_from_reference(numpy_tree(jparams), pcfg, device=CPU)
    got = equiformer_v2.MODULE.forward(params, batch, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
