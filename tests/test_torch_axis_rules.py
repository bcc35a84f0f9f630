"""Port parity for the logical-axis rules and the specs built from them:
``distributed/shardings.py``'s functions, ``launch.build_step``'s
placements for every cell, ``transformer_lm.param_specs`` /
``cache_specs``, ``optim.state_logical_specs`` and ``carve_mesh``'s
factorization, each against the JAX package's.

A port ``PartitionSpec`` is held to ``tuple(jax_spec)``: equal entry for
entry, where JAX reads a one-axis tuple as its axis.  ``_resolve`` is held to
JAX's raw result, where ``("data",)`` and ``"data"`` stay distinct.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax

import repro.distributed.shardings as jsh
from repro.configs import ARCHS as JARCHS
from repro.configs import all_cells as jall_cells
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.launch.mesh import single_device_mesh
from repro.launch.steps import build_step as jbuild_step
from repro.optim import state_logical_specs as jstate_logical_specs
from repro_torch.configs import ARCHS
from repro_torch.configs import all_cells
from repro_torch.core import make_mesh
from repro_torch.distributed import carve_shape
from repro_torch.distributed import shardings as sh
from repro_torch.launch import build_step
from repro_torch.models import transformer_lm as lm
from repro_torch.optim import state_logical_specs

RULE_TABLES = ["LM_RULES", "LM_RULES_SP", "LM_PREFILL_RULES", "LM_DECODE_RULES",
               "LM_DECODE_LONG_RULES", "LM_DECODE_LONG_RULES_V2", "GNN_RULES", "GNN_RULES_TP",
               "RECSYS_RULES", "RECSYS_RETRIEVAL_RULES", "GRAPH_ENGINE_RULES"]
MESHES = {"(data, model)": ("data", "model"), "(pod, data, model)": ("pod", "data", "model")}
LM_ARCHS = sorted(a for a, m in ARCHS.items() if m.FAMILY == "lm")
CELLS = sorted(all_cells())


def _jax_mesh(axes):
    return jmake_mesh((1,) * len(axes), axes)


def _port_mesh(axes):
    return make_mesh((1,) * len(axes), axes, devices=["cpu"])


def _specs(tree):
    """A tree of JAX ``NamedSharding``s or ``PartitionSpec``s as tuples."""
    return jax.tree.map(lambda s: tuple(getattr(s, "spec", s)), tree,
                        is_leaf=lambda s: hasattr(s, "spec") or isinstance(s, jax.sharding.
                                                                          PartitionSpec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("table", RULE_TABLES)
def test_rules_resolve_as_jax(table, mesh):
    """Every logical name of the table (and None, and a name no table
    has): ``_resolve`` equal to JAX's raw result, ``logical_to_spec`` to
    ``tuple(jax_spec)``, one spec of all names at once, and ``spec_tree`` of
    a tree holding each name, a pair and ``()``."""
    rules, jrules = getattr(sh, table), getattr(jsh, table)
    assert rules == jrules
    axes = MESHES[mesh]
    names = sorted(rules) + [None, "no_such_axis"]
    tree = {"one": {n or "none": (n,) for n in names}, "pairs": [tuple(names[:2]), ()],
            "all": tuple(names)}
    with sh.axis_rules(rules, _port_mesh(axes)):
        got = {n: (sh._resolve(n), sh.logical_to_spec(n)) for n in names}
        got_all, got_tree = sh.logical_to_spec(*names), sh.spec_tree(tree)
    with jsh.axis_rules(jrules, _jax_mesh(axes)):
        want = {n: (jsh._resolve(n), tuple(jsh.logical_to_spec(n))) for n in names}
        want_all, want_tree = tuple(jsh.logical_to_spec(*names)), _specs(jsh.spec_tree(tree))
    for n in names:
        assert got[n][0] == want[n][0] and type(got[n][0]) is type(want[n][0]), n
        assert got[n][1] == want[n][1], n
    assert got_all == want_all
    assert got_tree == want_tree


def test_inactive_rules_replicate_and_constrain_is_identity():
    """Outside ``axis_rules`` every spec is replicated, as JAX's; a rule set
    without a mesh keeps every target axis; ``constrain`` returns its
    input."""
    assert sh.logical_to_spec("batch", "embed") == tuple(jsh.logical_to_spec("batch", "embed"))
    with sh.axis_rules(sh.LM_RULES), jsh.axis_rules(jsh.LM_RULES):
        assert sh.logical_to_spec("batch", "vocab") == tuple(jsh.logical_to_spec("batch",
                                                                                  "vocab"))
        assert sh._resolve("batch") == ("pod", "data") == jsh._resolve("batch")
    x = torch.ones(3)
    assert sh.constrain(x, "batch") is x


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_build_step_specs_equal_jax(cell):
    """``build_step``'s ``in_specs`` and ``out_specs`` equal JAX's
    ``build_step`` shardings on ``single_device_mesh()``, and its
    ``arg_specs`` JAX's shapes and dtypes, leaf for leaf."""
    _, jargs, jin, jout = jbuild_step(jall_cells()[cell], single_device_mesh())
    _, args, ins, outs = build_step(all_cells()[cell], _port_mesh(("data", "model")))
    assert ins == _specs(jin)
    assert outs == _specs(jout)
    jl = jax.tree_util.tree_leaves_with_path(jargs)
    pl = jax.tree_util.tree_leaves_with_path(
        args, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
    assert len(jl) == len(pl)
    for (jp, j), (pp, p) in zip(jl, pl):
        assert jax.tree_util.keystr(jp) == jax.tree_util.keystr(pp)
        assert tuple(p.shape) == tuple(j.shape), jax.tree_util.keystr(jp)
        assert str(p.dtype).removeprefix("torch.") == str(j.dtype), jax.tree_util.keystr(jp)


@pytest.mark.parametrize("which", ["full_config", "smoke_config"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_and_cache_specs_equal_jax(arch, which):
    """``param_specs`` (dense, MoE with ``dense_layers``, MLA) and
    ``cache_specs`` equal JAX's, leaf for leaf; the moments take the
    params' axes."""
    cfg, jcfg = getattr(ARCHS[arch], which)(), getattr(JARCHS[arch], which)()
    from repro.models import transformer_lm as jlm

    assert lm.param_specs(cfg) == jlm.param_specs(jcfg)
    assert lm.cache_specs(cfg) == jlm.cache_specs(jcfg)
    assert state_logical_specs(lm.param_specs(cfg)) == jstate_logical_specs(
        jlm.param_specs(jcfg))
    shapes = lm.param_shapes(cfg)
    assert jax.tree.structure(lm.param_specs(cfg), is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.structure(shapes, is_leaf=lambda x: isinstance(x, tuple))
    caches = lm.make_cache(cfg, 1, 2, device="meta")
    assert jax.tree.structure(lm.cache_specs(cfg), is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.structure(caches)


CARVE_CODE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=64"
from repro.distributed.elastic import carve_mesh
for mx in (16, 4, 1):
    print(mx, [tuple(carve_mesh(n, max_model=mx).devices.shape) for n in range(1, 65)])
"""


def test_carve_shape_equals_jax():
    """``carve_shape``'s (data, model) for n = 1..64 and max_model 16, 4 and
    1 equals the JAX package's ``carve_mesh`` over 64 CPU devices (a
    subprocess)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", CARVE_CODE], capture_output=True, text=True,
                       cwd=root, env={**os.environ, "PYTHONPATH": "src"}, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        mx, shapes = line.split(" ", 1)
        want = eval(shapes)  # noqa: S307 — the subprocess printed a list of tuples
        assert [carve_shape(n, max_model=int(mx)) for n in range(1, 65)] == want
