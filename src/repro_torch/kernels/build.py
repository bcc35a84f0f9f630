"""Building and loading the hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point.  On first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/`` at the repository root, keyed by a hash of the
source and the flags, and loaded with ``ctypes``.  A failed build raises;
nothing falls back.  Which calls reach a kernel at all is decided by the
device of their tensors (``repro_torch.device.kernel_route``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"

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
                os.replace(tmp, lib)
            else:
                failed.append(f"nvcc failed on {source} (exit {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))


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
