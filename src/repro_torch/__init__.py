"""repro_torch — the Sage graph engine ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``, with the same module
layout (``core/``, ``kernels/``, ``algorithms/``, ``serving/``).  It imports
torch and numpy only.  Entry points place data on ``cuda`` unless the
caller passes ``device="cpu"``; each kernel call launches the hand-written
CUDA kernel for CUDA tensors and the plain PyTorch version for CPU tensors.
"""
