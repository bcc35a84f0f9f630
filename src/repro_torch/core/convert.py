"""Carrying a graph between the JAX package and the port as numpy arrays.

A graph is this system's "weights": the parity tests build one in the JAX
package, take ``{field: np.asarray(getattr(g, field))}`` of its dataclass
fields, and rebuild it here with :func:`from_reference_arrays`, so both
packages run on the same data.  A graphFilter crosses the same way
(:func:`filter_from_reference_arrays`), and so does a delta-overlay snapshot
(:func:`delta_from_reference_arrays`: its base, its patch arrays and its
tombstone words).  The port stores uint16 codes and uint32
words as int16/int32 bit-views; the conversion reinterprets, never rounds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..optim import tree_map
from .compressed import CompressedCSR
from .csr import CSRGraph
from .graph_filter import GraphFilter

CSR_FIELDS = (
    "offsets", "block_offsets", "block_src", "edge_src", "edge_dst", "edge_w", "degrees",
)
CSR_META = ("n", "m", "num_blocks", "block_size", "weighted")
COMPRESSED_FIELDS = (
    "block_first", "deltas", "valid_count", "exc_block", "exc_slot", "exc_value",
    "block_src", "degrees", "block_weights",
)
COMPRESSED_META = (
    "n", "m", "num_blocks", "block_size", "n_exceptions", "weighted",
    "exception_dense_hint",
)
DELTA_FIELDS = ("patch_src", "patch_dst", "patch_w", "live_words", "degrees")
DELTA_META = ("n", "m", "num_blocks", "num_base_blocks", "block_size", "weighted")
FILTER_FIELDS = ("bits", "active_deg", "dirty")
FILTER_META = ("n", "num_blocks", "block_size")
_BIT_VIEWS = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
_REFERENCE_VIEWS = {"deltas": np.uint16, "valid_count": np.uint16}


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    view = _BIT_VIEWS.get(a.dtype)
    if view is not None:
        a = a.view(view)
    return torch.from_numpy(a.copy()).to(device)


def from_reference_arrays(kind: str, arrays: dict, meta: dict, device=None):
    """The port's ``CSRGraph`` (``kind="csr"``) or ``CompressedCSR``
    (``kind="compressed"``) from numpy copies of the JAX dataclass fields
    and its static metadata, placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if kind == "csr":
        fields, meta_keys, cls = CSR_FIELDS, CSR_META, CSRGraph
    elif kind == "compressed":
        fields, meta_keys, cls = COMPRESSED_FIELDS, COMPRESSED_META, CompressedCSR
    else:
        raise ValueError(f"kind must be 'csr' or 'compressed', got {kind!r}")
    data = {
        f: None if arrays.get(f) is None else _to_tensor(np.asarray(arrays[f]), dev)
        for f in fields
    }
    return cls(**data, **{k: meta[k] for k in meta_keys if k in meta})


def to_reference_arrays(g) -> tuple[str, dict, dict]:
    """``(kind, arrays, meta)`` of a port graph, with the JAX package's
    dtypes (uint16 codes), the inverse of :func:`from_reference_arrays`."""
    if isinstance(g, CompressedCSR):
        kind, fields, meta_keys = "compressed", COMPRESSED_FIELDS, COMPRESSED_META
    else:
        kind, fields, meta_keys = "csr", CSR_FIELDS, CSR_META
    arrays = {}
    for f in fields:
        t = getattr(g, f)
        if t is None:
            arrays[f] = None
            continue
        a = t.cpu().numpy()
        arrays[f] = a.view(_REFERENCE_VIEWS[f]) if f in _REFERENCE_VIEWS else a
    return kind, arrays, {k: getattr(g, k) for k in meta_keys}


def delta_from_reference_arrays(kind: str, base_arrays: dict, base_meta: dict, arrays: dict,
                                meta: dict, device=None):
    """The port's ``DeltaGraph`` from numpy copies of a JAX ``DeltaGraph``:
    its base (``kind``, ``base_arrays``, ``base_meta`` as for
    :func:`from_reference_arrays`), its patch arrays, ``degrees`` and uint32
    ``live_words`` (carried as their int32 bit-view), and its metadata,
    placed on ``device`` (default ``cuda``)."""
    from ..delta.overlay import DeltaGraph  # here: delta layers on core

    dev = resolve_device(device)
    return DeltaGraph(
        base=from_reference_arrays(kind, base_arrays, base_meta, dev),
        **{f: _to_tensor(np.asarray(arrays[f]), dev) for f in DELTA_FIELDS},
        **{k: meta[k] for k in DELTA_META},
    )


def filter_from_reference_arrays(arrays: dict, meta: dict, device=None) -> GraphFilter:
    """The port's ``GraphFilter`` from numpy copies of a JAX filter's fields
    (uint32 ``bits`` become their int32 bit-view) and its metadata, placed
    on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return GraphFilter(
        **{f: _to_tensor(np.asarray(arrays[f]), dev) for f in FILTER_FIELDS},
        **{k: int(meta[k]) for k in FILTER_META},
    )


def filter_to_reference_arrays(f: GraphFilter) -> tuple[dict, dict]:
    """``(arrays, meta)`` of a port filter with the JAX package's dtypes
    (uint32 ``bits``), the inverse of :func:`filter_from_reference_arrays`."""
    arrays = {name: getattr(f, name).cpu().numpy() for name in FILTER_FIELDS}
    arrays["bits"] = arrays["bits"].view(np.uint32)
    return arrays, {k: getattr(f, k) for k in FILTER_META}


def lm_params_from_reference(tree: dict, cfg, device=None) -> dict:
    """The port's LM parameters from the JAX package's ``init`` tree, given
    as nested dicts of numpy arrays, placed on ``device`` (default ``cuda``).

    The tree must have exactly the leaves of ``transformer_lm.param_specs``
    with their shapes; a float32 config takes float32 arrays, a bfloat16
    config the bit patterns (uint16 or int16 views of the JAX arrays, or
    the JAX arrays' own 2-byte ``bfloat16`` dtype), which are reinterpreted,
    never rounded.  Anything else raises."""
    from ..models.transformer_lm import param_specs  # here: models imports kernels, kernels core

    dev = resolve_device(device)
    dtype = cfg.activation_dtype

    def carry(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{path or 'tree'}: expected a dict of leaves")
            if set(node) != set(spec):
                raise ValueError(f"{path or 'tree'}: leaves {sorted(node)} differ from "
                                 f"{sorted(spec)}")
            return {k: carry(spec[k], node[k], f"{path}/{k}") for k in spec}
        shape, _ = spec
        a = np.asarray(node)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, the port's is {tuple(shape)}")
        if dtype == torch.float32 and a.dtype == np.float32:
            return torch.from_numpy(a.copy()).to(dev)
        if dtype == torch.bfloat16 and a.dtype.itemsize == 2 and (
                a.dtype in (np.uint16, np.int16) or a.dtype.name == "bfloat16"):
            bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
            return bits.view(torch.bfloat16).to(dev)
        raise TypeError(f"{path}: dtype {a.dtype} does not carry the port's {dtype}")

    return carry(param_specs(cfg), tree, "")


def sasrec_params_from_reference(tree: dict, cfg, device=None) -> dict:
    """The port's SASRec parameters from the JAX package's ``init`` tree,
    given as nested dicts (``blocks`` a list) of float32 numpy arrays,
    placed on ``device`` (default ``cuda``).

    The tree must have exactly the leaves of ``sasrec.param_shapes`` with
    their shapes, and every leaf float32; anything else raises."""
    from ..models.sasrec import param_shapes  # here: models imports kernels, kernels core

    dev = resolve_device(device)

    def carry(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{path or 'tree'}: expected a dict of leaves")
            if set(node) != set(spec):
                raise ValueError(f"{path or 'tree'}: leaves {sorted(node)} differ from "
                                 f"{sorted(spec)}")
            return {k: carry(spec[k], node[k], f"{path}/{k}") for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise ValueError(f"{path}: expected a list of {len(spec)} blocks")
            return [carry(s, n, f"{path}/{i}") for i, (s, n) in enumerate(zip(spec, node))]
        shape, _ = spec
        a = np.asarray(node)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, the port's is {tuple(shape)}")
        if a.dtype != np.float32:
            raise TypeError(f"{path}: dtype {a.dtype}, the port's is float32")
        return torch.from_numpy(a.copy()).to(dev)

    return carry(param_shapes(cfg), tree, "")


def adamw_state_from_reference(state: dict, params_like, device=None) -> dict:
    """The port's AdamW state from the JAX package's ``{"step", "m", "v"}``
    given as numpy arrays (nested dicts and lists, as ``np.asarray`` of each
    leaf gives them), placed on ``device`` (default ``cuda``).

    ``m`` and ``v`` must have the leaves of ``params_like`` (a port
    parameter tree) with their shapes, float32; ``step`` a 0-d integer,
    carried as int32.  Anything else raises."""
    dev = resolve_device(device)

    def moments(tree, name):
        if tree_map(lambda _: 0, tree) != tree_map(lambda _: 0, params_like):
            raise ValueError(f"{name}: leaves differ from the parameters'")

        def carry(like, node):
            a = np.asarray(node)
            if a.shape != tuple(like.shape):
                raise ValueError(f"{name}: a leaf of shape {a.shape}, the parameter's is "
                                 f"{tuple(like.shape)}")
            if a.dtype != np.float32:
                raise TypeError(f"{name}: a leaf of dtype {a.dtype}, a moment is float32")
            return torch.from_numpy(a.copy()).to(dev)

        return tree_map(carry, params_like, tree)

    step = np.asarray(state["step"])
    if step.shape != () or step.dtype.kind not in "iu":
        raise TypeError(f"step must be a 0-d integer, got {step.dtype} {step.shape}")
    return {
        "step": torch.tensor(int(step), dtype=torch.int32, device=dev),
        "m": moments(state["m"], "m"),
        "v": moments(state["v"], "v"),
    }
