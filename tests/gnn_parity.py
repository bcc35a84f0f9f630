"""Shared helpers of the GNN parity suites (``test_torch_gnn*.py``): JAX
trees as numpy, trees flattened by path, and one model's loss and gradient
held to the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core.convert import gnn_params_from_reference
from repro_torch.launch import value_and_grad

CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-7  # of the whole gradient's norm: leaves that vanish analytically


def numpy_tree(tree):
    """A JAX tree (nested dicts and lists) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


def flat(tree, prefix=""):
    """``{"/a/0/b": numpy leaf}`` of a JAX or a port tree."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in flat(x, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def hold_loss_and_grads(jmod, jcfg, pmod, pcfg, batch, key=0):
    """JAX's ``init`` tree carried to the port; the loss and every gradient
    leaf held to JAX's (one jitted ``jax.value_and_grad``).  Returns the
    port's gradient tree."""
    jparams = jmod.init(jax.random.PRNGKey(key), jcfg)
    jb = jax_batch(batch)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmod.loss_fn(p, jb, jcfg)))(jparams)
    params = gnn_params_from_reference(numpy_tree(jparams), pcfg, device=CPU)
    pl, pg = value_and_grad(lambda p: pmod.loss_fn(p, batch, pcfg), params)
    assert np.isfinite(float(jl)) and np.isfinite(float(pl))
    assert abs(float(pl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    fj, fp = flat(jg), flat(pg)
    assert fj.keys() == fp.keys()
    total = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in fj.values()))
    for k in fj:
        assert fp[k].shape == fj[k].shape and fp[k].dtype == fj[k].dtype, k
        assert np.all(np.isfinite(fp[k])), k
        err = float(np.linalg.norm(fp[k] - fj[k]))
        assert err <= GRAD_RTOL * float(np.linalg.norm(fj[k])) + GRAD_FLOOR * total, (k, err)
    return pg
