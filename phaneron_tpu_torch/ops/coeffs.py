"""Loader / Saver coefficient bundles (counterpart of
phaneron_tpu/ops/coeffs.py).

The reference's Loader and Saver (loadSave.ts:33-201) own the colour
constants each format conversion needs: the gamma transfer, the 3x4
YCbCr<->RGB matrix sized for the format's bit depth and ranges, and (on
load) the 3x3 gamut matrix to the processing colourspace.  Here they are
host-built numpy constants copied once to ``device``.

``gamma_mode`` selects the transfer implementation:
- 'lut'      — 2^16-entry gather, bit-identical to the reference
- 'analytic' — the formula evaluated at the same quantized index
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import colour_maths as cm
from .formats.common import FormatInfo
from .gamma import gamma2linear_at_index, linear2gamma_at_index
from .quant import u16_sat_rte

__all__ = ["Gamma", "Loader", "Saver", "make_loader", "make_saver", "DEFAULT_GAMMA_MODE"]

DEFAULT_GAMMA_MODE = "analytic"


@dataclass(frozen=True)
class Gamma:
    """Transfer-function application: ``of`` quantizes a float in [0,1] to
    a 16-bit index then evaluates; ``at`` evaluates at integer indices."""

    col_spec: str
    direction: str  # 'g2l' | 'l2g'
    mode: str  # 'lut' | 'analytic'
    lut: Optional[torch.Tensor]

    def at(self, idx: torch.Tensor) -> torch.Tensor:
        if self.mode == "lut":
            return self.lut[idx.long()]
        if self.direction == "g2l":
            return gamma2linear_at_index(self.col_spec, idx)
        return linear2gamma_at_index(self.col_spec, idx)

    def of(self, x: torch.Tensor) -> torch.Tensor:
        return self.at(u16_sat_rte(x * 65535.0))


def _make_gamma(col_spec: str, direction: str, mode: str, device) -> Gamma:
    if mode not in ("lut", "analytic"):
        raise ValueError(f"unknown gamma mode '{mode}'")
    lut = None
    if mode == "lut":
        host = (
            cm.gamma2linear_lut(col_spec)
            if direction == "g2l"
            else cm.linear2gamma_lut(col_spec)
        )
        lut = torch.from_numpy(host).to(device)
    return Gamma(col_spec=col_spec, direction=direction, mode=mode, lut=lut)


@dataclass(frozen=True)
class Loader:
    """ToRGBA coefficients (loadSave.ts:33-128)."""

    col_matrix: Optional[torch.Tensor]  # (3,4) — None for RGB formats
    gamut_matrix: torch.Tensor  # (3,3)
    gamma: Gamma  # gamma' -> linear


@dataclass(frozen=True)
class Saver:
    """FromRGBA coefficients (loadSave.ts:130-201)."""

    col_matrix: Optional[torch.Tensor]  # (3,4) — None for RGB formats
    gamma: Gamma  # linear -> gamma'


def make_loader(
    info: FormatInfo,
    col_spec: str,
    out_col_spec: str,
    gamma_mode: str = DEFAULT_GAMMA_MODE,
    device: torch.device | str = "cpu",
) -> Loader:
    col_matrix = None
    if not info.is_rgb:
        m = cm.ycbcr2rgb_matrix(
            col_spec, info.num_bits, info.luma_black, info.luma_white, info.chroma_range
        )
        col_matrix = torch.from_numpy(m).to(device)
    gamut = torch.from_numpy(cm.rgb2rgb_matrix(col_spec, out_col_spec)).to(device)
    return Loader(
        col_matrix=col_matrix,
        gamut_matrix=gamut,
        gamma=_make_gamma(col_spec, "g2l", gamma_mode, device),
    )


def make_saver(
    info: FormatInfo,
    col_spec: str,
    gamma_mode: str = DEFAULT_GAMMA_MODE,
    device: torch.device | str = "cpu",
) -> Saver:
    col_matrix = None
    if not info.is_rgb:
        m = cm.rgb2ycbcr_matrix(
            col_spec, info.num_bits, info.luma_black, info.luma_white, info.chroma_range
        )
        col_matrix = torch.from_numpy(m).to(device)
    return Saver(
        col_matrix=col_matrix, gamma=_make_gamma(col_spec, "l2g", gamma_mode, device)
    )
