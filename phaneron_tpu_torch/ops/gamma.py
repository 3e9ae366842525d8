"""Transfer-function (gamma) application on tensors.

Counterpart of phaneron_tpu/ops/gamma.py.  The reference applies gamma
through 2^16-entry LUTs indexed by ``convert_ushort_sat_rte(value *
65535)`` (v210.ts:68-70,148-150).  Two implementations, both quantizing
to the same 16-bit index first:

- ``mode='lut'``      — a gather from the reference's 65536-entry LUT;
- ``mode='analytic'`` — the ITU transfer formula at that index, with the
  JAX package's float32 expression order (gamma.py:46-73).

gamma'->linear in 'analytic' mode is a gather from ``g2l_table``: the
formula evaluated once per index on the host, with the C library's
float32 ``powf`` for the power term.  That is the function XLA's CPU
backend calls for a float32 ``pow``, so the table equals JAX's
``gamma2linear_at_index`` at every one of the 65536 indices
(tests/test_torch_colour.py); ``torch.pow`` and a float64 power rounded
once differ from it at 1071-1078 and 24-40 indices.  The CUDA kernels
gather from the same table (uploaded once per device and col_spec), so
kernel and plain version agree by construction.  linear->gamma' stays
the float32 formula with ``torch.pow`` (CUDA ``powf`` in the kernels):
it lands in the same 10-bit codes as JAX's at every tested input.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np
import torch

from .colour_maths import COLOUR_SPECS, LUT_ENTRIES
from .quant import u16_sat_rte

__all__ = [
    "gamma_lut_apply",
    "g2l_table",
    "g2l_table_on",
    "gamma2linear_at_index",
    "linear2gamma_at_index",
    "l2g_constants",
]

INV_LUT_MAX = np.float32(1.0 / (LUT_ENTRIES - 1))


def l2g_constants(col_spec: str) -> tuple[float, ...]:
    """(inv_lut_max, beta, delta, alpha, alpha-1, gamma) as float32
    values: the literals of linear2gamma_at_index, shared with the CUDA
    kernels so both evaluate the same float32 formula."""
    p = COLOUR_SPECS[col_spec]
    return tuple(
        float(np.float32(v))
        for v in (INV_LUT_MAX, p.beta, p.delta, p.alpha, p.alpha - 1.0, p.gamma)
    )


def gamma_lut_apply(lut: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """lut[convert_ushort_sat_rte(x * 65535)] — the reference's exact op."""
    return lut[u16_sat_rte(x * 65535.0).long()]


def _powf(base: np.ndarray, exponent: np.float32) -> np.ndarray:
    """The C library's float32 powf, element by element."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    powf = libm.powf
    powf.restype = ctypes.c_float
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    e = float(exponent)
    return np.array([powf(b, e) for b in base.tolist()], dtype=np.float32)


@lru_cache(maxsize=None)
def g2l_table(col_spec: str) -> np.ndarray:
    """gamma'->linear at every LUT index, (65536,) float32: the JAX
    package's float32 formula (fi = idx * inv_max; fi * inv_delta below
    beta*delta, else ((fi + alpha-1) * 1/alpha) ** (1/gamma)), the power
    by the C library's powf."""
    p = COLOUR_SPECS[col_spec]
    fi = np.arange(LUT_ENTRIES, dtype=np.float32) * INV_LUT_MAX
    lo = fi * np.float32(1.0 / p.delta)
    base = (fi + np.float32(p.alpha - 1.0)) * np.float32(1.0 / p.alpha)
    hi = _powf(base, np.float32(1.0 / p.gamma))
    table = np.where(fi < np.float32(p.beta * p.delta), lo, hi).astype(np.float32)
    table.setflags(write=False)
    return table


@lru_cache(maxsize=None)
def g2l_table_on(col_spec: str, device: torch.device) -> torch.Tensor:
    """g2l_table on ``device``, uploaded once per device and col_spec."""
    return torch.from_numpy(g2l_table(col_spec).copy()).to(device)


def gamma2linear_at_index(col_spec: str, idx: torch.Tensor) -> torch.Tensor:
    """Analytic LUT cell value at an integer index in [0, 65535]."""
    return g2l_table_on(col_spec, idx.device)[idx.long()]


def linear2gamma_at_index(col_spec: str, idx: torch.Tensor) -> torch.Tensor:
    inv_max, beta, delta, alpha, alpha_m1, gamma = l2g_constants(col_spec)
    fi = idx.to(torch.float32) * inv_max
    lo = fi * delta
    hi = alpha * torch.pow(fi, gamma) - alpha_m1
    return torch.where(fi < beta, lo, hi)
