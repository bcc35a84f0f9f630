"""Real spherical harmonics Y_lm up to l_max by the associated-Legendre
recursion (Equiformer-v2's edge directions), the JAX package's ``sh.py`` op
for op; the static (l, m) table stays in numpy."""
from __future__ import annotations

import math

import numpy as np
import torch

from .aggregate import maximum


def _k_norm(l: int, m: int) -> float:
    return math.sqrt(
        (2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m)
    )


def real_sph_harm(lmax: int, u: torch.Tensor) -> torch.Tensor:
    """u: (..., 3) unit vectors → (..., (lmax+1)^2) real SH values, index
    ``l*l + (m + l)`` for m in [-l, l]."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    rxy = torch.sqrt(maximum(x * x + y * y, 1e-30))
    cphi, sphi = x / rxy, y / rxy

    cos_m = [torch.ones_like(x), cphi]
    sin_m = [torch.zeros_like(x), sphi]
    for m in range(2, lmax + 1):
        cos_m.append(2 * cphi * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cphi * sin_m[-1] - sin_m[-2])

    P = {}
    somx2 = torch.sqrt(maximum(1.0 - z * z, 0.0))
    P[(0, 0)] = torch.ones_like(z)
    for m in range(1, lmax + 1):
        P[(m, m)] = -(2 * m - 1) * somx2 * P[(m - 1, m - 1)]
    for m in range(0, lmax):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = (
                (2 * l - 1) * z * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]
            ) / (l - m)

    out = []
    sq2 = math.sqrt(2.0)
    for l in range(lmax + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            k = _k_norm(l, m)
            if m == 0:
                row[l] = k * P[(l, 0)]
            else:
                row[l + m] = sq2 * k * cos_m[m] * P[(l, m)]
                row[l - m] = sq2 * k * sin_m[m] * P[(l, m)]
        out.extend(row)
    return torch.stack(out, dim=-1)


def sh_index_table(lmax: int) -> np.ndarray:
    """(l, m) per flat index."""
    return np.array([(l, m) for l in range(lmax + 1) for m in range(-l, l + 1)])
