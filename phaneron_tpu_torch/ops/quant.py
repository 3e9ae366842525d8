"""Rounding / saturation primitives matching OpenCL convert_* semantics.

Counterpart of phaneron_tpu/ops/quant.py.  The reference kernels rely on
specific OpenCL conversion modes for bit-exactness (v210.ts:68-70
``convert_ushort_sat_rte``, v210.ts:176-183 ``convert_ushort_sat_rtz`` +
``round()``).  These helpers reproduce them on float32 tensors:

- ``_rte``: round to nearest, ties to even (``torch.round``, like
  ``jnp.rint``)
- ``_rtz``: truncate toward zero
- ``round()`` in OpenCL: round half away from zero
"""

from __future__ import annotations

import torch

__all__ = [
    "u16_sat_rte",
    "u16_sat_rtz",
    "u16_sat_round_half_away",
    "u10_sat_rte",
    "u8_sat_rte",
    "round_half_away",
]


def u16_sat_rte(x: torch.Tensor) -> torch.Tensor:
    """convert_ushort_sat_rte: round-to-nearest-even, clamp [0, 65535]."""
    return torch.clamp(torch.round(x), 0, 65535).to(torch.int32)


def u16_sat_rtz(x: torch.Tensor) -> torch.Tensor:
    """convert_ushort_sat_rtz: truncate toward zero, clamp [0, 65535]."""
    return torch.clamp(torch.trunc(x), 0, 65535).to(torch.int32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """OpenCL round(): round half away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def u16_sat_round_half_away(x: torch.Tensor) -> torch.Tensor:
    """convert_ushort_sat(round(x)): used on remainder tails (v210.ts:181)."""
    return torch.clamp(round_half_away(x), 0, 65535).to(torch.int32)


def u10_sat_rte(x: torch.Tensor) -> torch.Tensor:
    """10-bit code from float: rte, ushort saturation, then the 10-bit
    field mask the v210 packer applies (v210.ts:153-163)."""
    return u16_sat_rte(x) & 0x3FF


def u8_sat_rte(x: torch.Tensor) -> torch.Tensor:
    """convert_uchar_sat_rte: round-to-nearest-even, clamp [0, 255]."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.int32)
