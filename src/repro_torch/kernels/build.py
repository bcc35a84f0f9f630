"""Building and loading the hand-written CUDA kernels, and checking their operands.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point.  On first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/`` at the repository root, keyed by a hash of the
source and the flags, and loaded with ``ctypes``; ptxas's report of each
kernel's registers and spills is kept beside it (``resource_usage``).  A
failed build raises;
nothing falls back.  Which calls reach a kernel at all is decided by the
device of their tensors (``repro_torch.device.kernel_route``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import pathlib
import shutil
import subprocess
import threading

import torch

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report each kernel's registers and spills
)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
BLOCK_SIZES = (32, 64, 128)  # F_B the kernels take: FB/32 slots per lane
MAX_TILE_BLOCKS = 32         # warps per CTA of a whole-graph kernel: 1024 threads

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else the one under
    ``torch.utils.cpp_extension.CUDA_HOME``."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_all(sources) -> None:
    """Compile every source not yet built, one ``nvcc`` each, all at once.

    Each compiles to a temporary name and is renamed into place when it
    succeeds, so a cut build never leaves a library that looks finished."""
    sources = [pathlib.Path(s) for s in sources]
    with _LOCK:
        started = []
        for source in sources:
            lib = _library_path(source)
            if str(source) in _LOADED or lib.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            started.append((source, lib, tmp, proc))
        failed = []
        for source, lib, tmp, proc in started:  # wait for all before raising
            out, _ = proc.communicate()
            if proc.returncode == 0:
                lib.with_suffix(".ptxas").write_text(out)
                os.replace(tmp, lib)
            else:
                failed.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))


def resource_usage(source) -> dict[str, tuple[int, int]]:
    """What ptxas reported when ``source`` was built: ``{kernel: (registers
    a thread, spill store bytes)}`` by mangled name; empty when this
    build's report is not at hand."""
    report = _library_path(pathlib.Path(source)).with_suffix(".ptxas")
    if not report.exists():
        return {}
    usage, name, spill = {}, None, 0
    for line in report.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            usage[name] = (int(m.group(1)), spill)
            name = None
    return usage


def load_library(source) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    source = pathlib.Path(source)
    key = str(source)
    lib = _LOADED.get(key)
    if lib is not None:
        return lib
    build_all([source])
    with _LOCK:
        if key not in _LOADED:
            _LOADED[key] = ctypes.CDLL(str(_library_path(source)))
        return _LOADED[key]


def check_launch(status: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def data_ptr(t) -> int | None:
    """The device address of ``t`` for a C entry point; None (NULL) for None."""
    return None if t is None else t.data_ptr()


def check_operand(name, t, dtypes, shape, device, align=4) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of one of
    ``dtypes``, of ``shape``, contiguous and ``align``-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the graph on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def sums_output(x, n, dev, rows):
    """Check the vertex state ``x`` of a sums launch and allocate its output.

    Returns ``(B, row stride, out)``: ``out`` is (rows,) for a 1-D ``x`` and
    (rows, B) for a (B, n_pad) batch, of ``x``'s dtype."""
    if x is None or x.dim() not in (1, 2):
        raise ValueError("sums need x of shape (n_pad,) or (B, n_pad)")
    check_operand("x", x, (torch.float32, torch.int32), x.shape, dev)
    if x.shape[-1] < n:
        raise ValueError(f"x has {x.shape[-1]} columns, fewer than n={n}")
    batched = x.dim() == 2
    B = x.shape[0] if batched else 1
    out = torch.empty((rows, B) if batched else (rows,), dtype=x.dtype, device=dev)
    return B, x.shape[-1], out


def check_tile_blocks(tile_blocks: int) -> int:
    """``tile_blocks`` as the warps per CTA of a whole-graph kernel (1..32)."""
    if not 1 <= int(tile_blocks) <= MAX_TILE_BLOCKS:
        raise ValueError(f"tile_blocks must be in 1..{MAX_TILE_BLOCKS}, got {tile_blocks}")
    return int(tile_blocks)
