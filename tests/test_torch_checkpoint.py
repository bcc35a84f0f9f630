"""The port's checkpoints against the JAX package's, leaf for leaf and byte
for byte: ``repro_torch.checkpoint`` writes the JAX package's on-disk
format (``step_%010d/arrays.npz`` + ``manifest.json``), so a tree saved by
either package restores in the other.

bfloat16 is the case that needs care: numpy has no bfloat16, the JAX
package's host copy of a bf16 leaf is a 2-byte type that ``np.save``
records as ``<V2``, and ``np.load`` gives 2-byte void back.  The port
writes a bf16 tensor's bits under the same descr and turns 2-byte void
back into bf16 where the example leaf is bf16.  Everything here is exact.
"""
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro_torch.checkpoint import restore, restore_latest, save

CPU = "cpu"


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((5, 7)).astype(np.float32),
        "layers": [rng.standard_normal((3,)).astype(np.float32) for _ in range(2)],
        "count": np.asarray(rng.integers(-9, 9, (4,)), np.int32),
        "codes": np.asarray(rng.integers(0, 1 << 16, (6,)), np.uint16),
        "words": np.asarray(rng.integers(0, 1 << 32, (3,), dtype=np.uint64), np.uint32),
        "step": np.asarray(7, np.int32),
    }


def _trees(values, bf16=("w",)):
    """The same values as a JAX tree and a port tree; ``bf16`` leaves are
    bfloat16 in both (the same bits), the bit-view leaves as the port keeps
    them (int16 / int32)."""
    jt = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
          for k, v in values.items()}
    tt = {}
    for k, v in values.items():
        if isinstance(v, list):
            tt[k] = [torch.from_numpy(x.copy()) for x in v]
        elif v.dtype == np.uint16:
            tt[k] = torch.from_numpy(v.view(np.int16).copy())
        elif v.dtype == np.uint32:
            tt[k] = torch.from_numpy(v.view(np.int32).copy())
        else:
            tt[k] = torch.from_numpy(v.copy())
    for k in bf16:
        jt[k] = jt[k].astype(jnp.bfloat16)
        tt[k] = tt[k].to(torch.bfloat16)
    return jt, tt


def _members(ckpt_dir, step):
    with zipfile.ZipFile(f"{ckpt_dir}/step_{step:010d}/arrays.npz") as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_tree(a, b)
    else:
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


def test_bf16_save_writes_the_jax_packages_bytes(tmp_path):
    """Every ``arrays.npz`` member (bf16, float32, int32, a 0-d int32) is
    byte for byte the JAX package's save of the same values, and the
    manifests are equal.  (The port keeps uint16 / uint32 arrays as int16 /
    int32 bit-views and saves them so: the same bytes under another descr.)"""
    values = {k: v for k, v in _values().items() if k not in ("codes", "words")}
    jt, tt = _trees(values)
    assert np.array_equal(np.asarray(jt["w"]).view(np.uint16),
                          tt["w"].view(torch.int16).numpy().view(np.uint16))
    # the JAX package saves the uint16 / uint32 arrays themselves
    jsave(str(tmp_path / "jax"), 3, jt)
    save(str(tmp_path / "port"), 3, tt)
    want, got = _members(tmp_path / "jax", 3), _members(tmp_path / "port", 3)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert b"'descr': '<V2'" in got["leaf_4.npy"][:128]  # "w", last in key order
    jm = (tmp_path / "jax" / "step_0000000003" / "manifest.json").read_text()
    assert (tmp_path / "port" / "step_0000000003" / "manifest.json").read_text() == jm


def test_port_restores_the_jax_packages_bf16_save(tmp_path):
    jt, tt = _trees(_values(1))
    jt["layers"] = [x.astype(jnp.bfloat16) for x in jt["layers"]]
    tt["layers"] = [x.to(torch.bfloat16) for x in tt["layers"]]
    jsave(str(tmp_path), 5, jt)
    example = {k: ([torch.zeros_like(x) for x in v] if isinstance(v, list)
                   else torch.zeros_like(v)) for k, v in tt.items()}
    got, step = restore_latest(str(tmp_path), example, device=CPU)
    assert step == 5
    _same_tree(got, tt)


def test_jax_package_restores_the_ports_bf16_save(tmp_path):
    """The JAX package's own restore gives 2-byte void for a bf16 leaf,
    whoever saved it: the port's save gives it the same bits."""
    jt, tt = _trees(_values(2))
    save(str(tmp_path), 1, tt)
    got = jrestore(str(tmp_path), 1, jt)
    assert got["w"].dtype.kind == "V" and got["w"].dtype.itemsize == 2
    assert np.array_equal(np.asarray(got["w"]).view(np.uint16),
                          np.asarray(jt["w"]).view(np.uint16))
    assert np.array_equal(np.asarray(got["codes"]), _values(2)["codes"].view(np.int16))


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_plain_dtypes_round_trip_as_before(tmp_path, saver):
    """float32, int32 and the uint16 / uint32 bit-views, no bf16 leaf."""
    jt, tt = _trees(_values(3), bf16=())
    if saver == "port":
        save(str(tmp_path), 2, tt)
    else:
        jsave(str(tmp_path), 2, jt)
    _same_tree(restore(str(tmp_path), 2, tt, device=CPU), tt)


def test_a_bf16_leaf_restores_only_into_bf16(tmp_path):
    jt, tt = _trees(_values(4))
    save(str(tmp_path), 1, tt)
    wrong = dict(tt, w=torch.zeros(5, 7))
    with pytest.raises(TypeError, match="bfloat16"):
        restore(str(tmp_path), 1, wrong, device=CPU)
