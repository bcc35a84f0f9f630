"""Shared helpers of the ``test_torch_*`` parity suites.

Graphs are built in the JAX package from numpy edge lists, carried to the
port as numpy arrays (``repro_torch.core.from_reference_arrays``), and both
packages then run on the same data on the CPU.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.core import from_reference_arrays

CPU = "cpu"


def to_np(t):
    """A port tensor (or a JAX array) as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def port_graph(g):
    """The port's copy (on the CPU) of a JAX ``CSRGraph`` / ``CompressedCSR``."""
    kind = "compressed" if hasattr(g, "deltas") else "csr"
    arrays, meta = {}, {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, (int, bool)) or v is None and f.name == "exception_dense_hint":
            meta[f.name] = v
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return from_reference_arrays(kind, arrays, meta, CPU)


def words_u32(t):
    """Port int32 packed words as the JAX package's uint32 words."""
    return to_np(t).view(np.uint32)


def leaves(tree, prefix=""):
    """A nested dict's leaves as ``{"/a/b": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def numpy_tree(tree):
    """A JAX parameter tree (nested dicts) as numpy arrays; bfloat16 leaves
    as their uint16 bit patterns (numpy has no bfloat16 of its own)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_close(got, want, tol):
    """Element for element within rtol = atol = ``tol``, in float32."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)
