"""Transfer-function (gamma) application on tensors.

Counterpart of phaneron_tpu/ops/gamma.py.  The reference applies gamma
through 2^16-entry LUTs indexed by ``convert_ushort_sat_rte(value *
65535)`` (v210.ts:68-70,148-150).  Two implementations, both quantizing
to the same 16-bit index first:

- ``mode='lut'``      — a gather from the 65536-entry float32 LUT;
- ``mode='analytic'`` — the ITU transfer formula at that index, in
  float32, with the JAX package's expression order (gamma.py:46-73).
  The CUDA kernels evaluate this same formula.
"""

from __future__ import annotations

import numpy as np
import torch

from .colour_maths import COLOUR_SPECS, LUT_ENTRIES
from .quant import u16_sat_rte

__all__ = [
    "gamma_lut_apply",
    "gamma2linear_at_index",
    "linear2gamma_at_index",
    "g2l_constants",
    "l2g_constants",
]

INV_LUT_MAX = np.float32(1.0 / (LUT_ENTRIES - 1))


def g2l_constants(col_spec: str) -> tuple[float, ...]:
    """(inv_lut_max, beta*delta, 1/delta, alpha-1, 1/alpha, 1/gamma) as
    float32 values: the literals of gamma2linear_at_index, shared with
    the CUDA kernels so both evaluate the same float32 formula."""
    p = COLOUR_SPECS[col_spec]
    return tuple(
        float(np.float32(v))
        for v in (
            INV_LUT_MAX, p.beta * p.delta, 1.0 / p.delta, p.alpha - 1.0,
            1.0 / p.alpha, 1.0 / p.gamma,
        )
    )


def l2g_constants(col_spec: str) -> tuple[float, ...]:
    """(inv_lut_max, beta, delta, alpha, alpha-1, gamma) as float32
    values: the literals of linear2gamma_at_index."""
    p = COLOUR_SPECS[col_spec]
    return tuple(
        float(np.float32(v))
        for v in (INV_LUT_MAX, p.beta, p.delta, p.alpha, p.alpha - 1.0, p.gamma)
    )


def gamma_lut_apply(lut: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """lut[convert_ushort_sat_rte(x * 65535)] — the reference's exact op."""
    return lut[u16_sat_rte(x * 65535.0).long()]


def _index_to_f(idx: torch.Tensor, inv_lut_max: float) -> torch.Tensor:
    return idx.to(torch.float32) * inv_lut_max


def gamma2linear_at_index(col_spec: str, idx: torch.Tensor) -> torch.Tensor:
    """Analytic LUT cell value at an integer index in [0, 65535]."""
    inv_max, beta, inv_delta, alpha_m1, inv_alpha, inv_gamma = g2l_constants(col_spec)
    fi = _index_to_f(idx, inv_max)
    lo = fi * inv_delta
    hi = torch.pow((fi + alpha_m1) * inv_alpha, inv_gamma)
    return torch.where(fi < beta, lo, hi)


def linear2gamma_at_index(col_spec: str, idx: torch.Tensor) -> torch.Tensor:
    inv_max, beta, delta, alpha, alpha_m1, gamma = l2g_constants(col_spec)
    fi = _index_to_f(idx, inv_max)
    lo = fi * delta
    hi = alpha * torch.pow(fi, gamma) - alpha_m1
    return torch.where(fi < beta, lo, hi)

