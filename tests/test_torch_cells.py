"""Port parity for the cell registry: ``repro_torch.configs`` against the
JAX package's ``repro.configs``.

Every ``(arch, shape)`` of JAX's ``all_cells()`` has a port cell equal in
``arch``, ``shape``, ``kind``, ``family``, the batch specs' shapes and dtypes
(compared by name: ``int32``, ``bfloat16``), ``batch_logical``, ``rules``,
``notes``, ``model_flops`` (Python floats from the same formulas: exactly)
and ``model_cfg`` field for field.  Also the registry's order, the paper's
own ``sage_graph`` configs, SASRec's ``param_specs`` and the LM smoke
batches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs
import repro.models.sasrec as jsasrec
import repro_torch.configs as configs
import repro_torch.models.sasrec as sasrec
from repro_torch.configs import lm_common

JAX_CELLS = jconfigs.all_cells()
LM_ARCHS = [a for a, m in jconfigs.ARCHS.items() if m.FAMILY == "lm"]


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


def _fields(cfg) -> dict:
    """A config's fields, dtypes by name."""
    return {k: _dtype_name(v) if "dtype" in type(v).__name__.lower() or k == "dtype" else v
            for k, v in dataclasses.asdict(cfg).items()}


def _specs(tree):
    """A batch spec tree as {name: (shape, dtype name)}."""
    return {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in tree.items()}


def test_archs_same_keys_same_order():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    for name, m in configs.ARCHS.items():
        j = jconfigs.get_arch(name)
        assert configs.get_arch(name) is m
        assert (m.ARCH_ID, m.FAMILY) == (j.ARCH_ID, j.FAMILY)
    assert list(configs.GNN_ARCHS) == ["pna", "dimenet", "equiformer-v2", "gin-tu"]


def test_all_cells_is_the_40_cell_grid():
    mine = configs.all_cells()
    assert len(mine) == 40
    assert list(mine) == list(JAX_CELLS)


@pytest.mark.parametrize("key", list(JAX_CELLS), ids=lambda k: f"{k[0]}/{k[1]}")
def test_cell_equals_jax(key):
    c, r = configs.get_arch(key[0]).cells()[key[1]], JAX_CELLS[key]
    assert (c.arch, c.shape, c.kind, c.family, c.notes) == (r.arch, r.shape, r.kind, r.family,
                                                            r.notes)
    assert _specs(c.batch_specs) == _specs(r.batch_specs)
    assert list(c.batch_specs) == list(r.batch_specs)
    assert c.batch_logical == r.batch_logical
    assert c.rules == r.rules
    assert type(c.model_flops) is float and c.model_flops == r.model_flops
    assert type(c.model_cfg).__name__ == type(r.model_cfg).__name__
    assert _fields(c.model_cfg) == _fields(r.model_cfg)


def test_decode_cells_take_one_kv_block():
    """The decode cells' config attends over the whole cache in one block."""
    for arch in LM_ARCHS:
        for shape in ("decode_32k", "long_500k"):
            cell = configs.get_arch(arch).cells()[shape]
            assert cell.model_cfg.kv_block == {"decode_32k": 32768, "long_500k": 524288}[shape]
            assert cell.batch_specs["pos"].shape == ()


def test_sage_graph_configs_equal_jax():
    from repro.configs import sage_graph as jsage

    sg = configs.sage_graph
    for fn in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(sg, fn)()) == dataclasses.asdict(getattr(jsage, fn)())
    assert (sg.ARCH_ID, sg.FAMILY) == (jsage.ARCH_ID, jsage.FAMILY)
    assert sg.RULES == jsage.RULES


@pytest.mark.parametrize("which", ["full_config", "smoke_config"])
def test_sasrec_param_specs_equal_jax(which):
    from repro.configs import sasrec as jcfg

    cfg = getattr(configs.sasrec, which)()
    specs = sasrec.param_specs(cfg)
    assert specs == jsasrec.param_specs(getattr(jcfg, which)())
    shapes = sasrec.param_shapes(cfg)

    def same_tree(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same_tree(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same_tree(x, y)
        else:
            assert len(a) == len(b[0])   # one logical name a dimension

    same_tree(specs, shapes)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_batch(arch):
    """Shapes and dtypes of JAX's smoke batch, tokens in [0, vocab), targets
    the tokens rolled by -1; the same generator state gives the same batch."""
    import jax

    m = configs.get_arch(arch)
    jb = jconfigs.get_arch(arch).smoke_batch(jax.random.PRNGKey(0))
    b = m.smoke_batch(torch.Generator().manual_seed(3), device="cpu")
    assert _specs(b) == _specs(jb)
    toks = b["tokens"].numpy()
    assert 0 <= toks.min() and toks.max() < m.smoke_config().vocab
    np.testing.assert_array_equal(b["targets"].numpy(), np.roll(toks, -1, axis=1))
    again = m.smoke_batch(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["tokens"], b["tokens"])
    wide = lm_common.lm_smoke_batch(m.smoke_config(), torch.Generator().manual_seed(1),
                                    batch=3, seq=7, device="cpu")
    assert wide["tokens"].shape == (3, 7) and wide["tokens"].dtype == torch.int32
