"""YCbCr <-> linear RGBA colour conversion stages (counterpart of
phaneron_tpu/ops/colorspace.py).

read:  integer Y/Cb/Cr codes -> 3x4 colour matrix -> gamma'->linear
       -> 3x3 gamut matrix -> linear RGBA, alpha = 1
write: linear RGBA -> linear->gamma' -> 3x4 matrix -> integer codes

Frames are planar (4, H, W) float32 RGBA.  Chroma arrives upsampled to
full resolution by the format unpacker.  Each dot product is summed left
to right, as in the JAX package, so every product and sum rounds as it
does there.
"""

from __future__ import annotations

from typing import Callable

import torch

from .quant import u16_sat_rte

__all__ = ["ycbcr_to_rgba", "rgb_gamut", "rgba_to_ycbcr"]

GammaFn = Callable[[torch.Tensor], torch.Tensor]


def ycbcr_to_rgba(
    y: torch.Tensor,
    cb: torch.Tensor,
    cr: torch.Tensor,
    col_matrix: torch.Tensor,  # (3, 4) f32: rows R', G', B' over (Y, U, V, 1)
    g2l: GammaFn,
    gamut_matrix: torch.Tensor,  # (3, 3) f32 linear-light gamut conversion
) -> torch.Tensor:
    """Integer code planes (H, W) -> linear RGBA (4, H, W)."""
    yf = y.to(torch.float32)
    uf = cb.to(torch.float32)
    vf = cr.to(torch.float32)
    m = col_matrix

    def channel(c: int) -> torch.Tensor:
        return g2l(m[c, 0] * yf + m[c, 1] * uf + m[c, 2] * vf + m[c, 3])

    r, g, b = channel(0), channel(1), channel(2)
    gm = gamut_matrix
    return torch.stack(
        [
            gm[0, 0] * r + gm[0, 1] * g + gm[0, 2] * b,
            gm[1, 0] * r + gm[1, 1] * g + gm[1, 2] * b,
            gm[2, 0] * r + gm[2, 1] * g + gm[2, 2] * b,
            torch.ones_like(r),
        ]
    )


def rgb_gamut(rgba: torch.Tensor, gamut_matrix: torch.Tensor) -> torch.Tensor:
    """Apply a 3x3 linear gamut matrix to (4, H, W) RGBA, alpha untouched."""
    r, g, b, a = rgba[0], rgba[1], rgba[2], rgba[3]
    gm = gamut_matrix
    return torch.stack(
        [
            gm[0, 0] * r + gm[0, 1] * g + gm[0, 2] * b,
            gm[1, 0] * r + gm[1, 1] * g + gm[1, 2] * b,
            gm[2, 0] * r + gm[2, 1] * g + gm[2, 2] * b,
            a,
        ]
    )


def rgba_to_ycbcr(
    rgba: torch.Tensor,  # (C>=3, H, W) linear RGB(A)
    col_matrix: torch.Tensor,  # (3, 4) f32: rows Y, U, V over (R', G', B', 1)
    l2g: GammaFn,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear RGB(A) -> full-resolution integer Y/Cb/Cr code planes (int32),
    rounded rte and saturated as convert_ushort_sat_rte (v210.ts:153-155);
    the caller masks to its bit depth when packing.  Alpha is not read."""
    rp = l2g(rgba[0])
    gp = l2g(rgba[1])
    bp = l2g(rgba[2])
    m = col_matrix

    def channel(c: int) -> torch.Tensor:
        return u16_sat_rte(m[c, 0] * rp + m[c, 1] * gp + m[c, 2] * bp + m[c, 3])

    return channel(0), channel(1), channel(2)
