"""Fault-tolerant checkpointing: atomic step-directory save / restore-latest.

The on-disk format is the JAX package's, so a tree saved by either package
restores in the other:

* ``<ckpt_dir>/step_%010d/`` holds ``arrays.npz`` (leaves ``leaf_0``,
  ``leaf_1``, ... in flatten order) and ``manifest.json`` (step, leaf
  count, the tree's structure as a string);
* a save writes ``step_N.tmp`` and publishes it with one ``os.replace``, so
  a crash mid-write never leaves a torn step visible;
* the newest ``keep`` published steps are retained.

Flatten order is JAX's pytree order: a dict's leaves by sorted key, lists
and tuples in order, ``None`` an empty subtree.  The port flattens its
trees itself for that reason (``torch.utils._pytree`` keeps a dict's
insertion order).  Tensors are read back to the host for the save;
``restore`` places every leaf on ``device`` (default ``cuda``), uint16 and
uint32 arrays as the port's int16 / int32 bit-views.

numpy has no bfloat16.  The JAX package's ``np.asarray`` of a bfloat16
leaf is a 2-byte type that ``np.save`` records with the descr ``<V2`` and
its raw bit patterns; the port writes a bfloat16 tensor's bits under the
same descr, so both packages write the same bytes.  ``np.load`` reads such
a leaf back as 2-byte void, which ``restore`` turns into bfloat16 where the
example tree's leaf is a bfloat16 tensor (and refuses elsewhere).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save", "restore", "restore_latest", "latest_step"]


def _flatten(tree) -> tuple[list, str]:
    """(leaves in JAX's pytree order, the structure as JAX prints it)."""
    leaves: list = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            parts = [f"{k!r}: {walk(node[k])}" for k in sorted(node)]
            return "{" + ", ".join(parts) + "}"
        if isinstance(node, (list, tuple)):
            parts = [walk(x) for x in node]
            if isinstance(node, list):
                return "[" + ", ".join(parts) + "]"
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(example, leaves: list):
    """``example``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(example)


BF16_DESCR = "<V2"  # what np.save records for the JAX package's host bfloat16 arrays


def _host(x) -> np.ndarray:
    """A leaf on the host; a bfloat16 tensor as its bits, in 2-byte void."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view("V2").copy()
        return x.numpy()
    return np.asarray(x)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)``, but a 2-byte void array is recorded with
    the descr ``BF16_DESCR`` (``np.savez`` would write ``|V2``)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": BF16_DESCR, "fortran_order": False, "shape": a.shape})
                    fid.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=False)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` of ``ckpt_dir`` atomically; returns the
    published directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    _savez(os.path.join(tmp, "arrays.npz"), arrays)
    manifest = {"step": step, "n_leaves": len(leaves), "treedef": treedef}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest published step of ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


_BIT_VIEWS = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def _to_device(a: np.ndarray, like, dev, path: str) -> torch.Tensor:
    """A loaded leaf as a tensor on ``dev``; 2-byte void becomes bfloat16
    where the example leaf ``like`` is a bfloat16 tensor."""
    a = np.ascontiguousarray(a).reshape(a.shape)  # ascontiguousarray makes a 0-d array 1-d
    if a.dtype.kind == "V":
        if not (a.dtype.itemsize == 2 and isinstance(like, torch.Tensor)
                and like.dtype == torch.bfloat16):
            raise TypeError(f"{path}: a {a.dtype.itemsize}-byte void leaf restores only into "
                            f"a bfloat16 leaf, the example's is "
                            f"{getattr(like, 'dtype', type(like).__name__)}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    view = _BIT_VIEWS.get(a.dtype)
    if view is not None:
        a = a.view(view)
    return torch.from_numpy(a.copy()).to(dev)


def restore(ckpt_dir: str, step: int, example_tree, *, device=None):
    """Restore step ``step`` into the structure of ``example_tree``, every leaf
    a tensor on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves, _ = _flatten(example_tree)
        loaded = [_to_device(data[f"leaf_{i}"], like, dev, f"{path} leaf_{i}")
                  for i, like in enumerate(leaves)]
    return _unflatten(example_tree, loaded)


def restore_latest(ckpt_dir: str, example_tree, *, device=None):
    """``(tree, step)`` of the newest published step, or ``(None, None)``."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return restore(ckpt_dir, step, example_tree, device=device), step
