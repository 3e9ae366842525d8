"""to_rgba / from_rgba — the ToRGBA/FromRGBA stage equivalents
(counterpart of phaneron_tpu/ops/io.py; io.ts:26-179).

``to_rgba`` maps packed plane tensors to a linear (4, H, W) RGBA frame;
``from_rgba`` maps a frame back to packed planes;
``interleave_rgba_fields`` merges two field-rate frames into one
interlaced frame.
"""

from __future__ import annotations

import torch

from .coeffs import Loader, Saver
from .colorspace import rgb_gamut, rgba_to_ycbcr, ycbcr_to_rgba
from .quant import u8_sat_rte

__all__ = ["to_rgba", "from_rgba", "interleave_rgba_fields"]


def to_rgba(fmt, planes, loader: Loader, width: int, height: int) -> torch.Tensor:
    """Packed planes -> linear RGBA (4, H, W) float32."""
    if fmt.INFO.is_rgb:
        codes = fmt.unpack_rgba_codes(planes, width, height)  # (4, H, W) 0..255
        # index = rte(c * 65535 / 255) == c * 257 exactly (rgba8.ts:53-61);
        # alpha passes through the transfer function too
        decoded = loader.gamma.at(codes * 257)
        return rgb_gamut(decoded, loader.gamut_matrix).to(torch.float32)
    y, cb, cr = fmt.unpack_codes(planes, width, height)
    return ycbcr_to_rgba(
        y, cb, cr, loader.col_matrix, loader.gamma.of, loader.gamut_matrix
    )


def from_rgba(
    fmt, rgba: torch.Tensor, saver: Saver, width: int, height: int
) -> list[torch.Tensor]:
    """Linear RGB(A) (C, H, W) -> packed planes (progressive).  Alpha is
    not read: an RGB format writes 255 (rgba8.ts:97)."""
    if fmt.INFO.is_rgb:
        codes = u8_sat_rte(saver.gamma.of(rgba[:3]) * 255.0)
        alpha = torch.full_like(codes[0], 255)
        return fmt.pack_rgba_codes(torch.cat([codes, alpha[None]]), width, height)
    y, cb, cr = rgba_to_ycbcr(rgba, saver.col_matrix, saver.gamma.of)
    return fmt.pack_codes(y, cb, cr, width, height)


def interleave_rgba_fields(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Merge two full-height field frames into one interlaced frame: even
    lines from ``top``, odd lines from ``bottom`` (the reference
    consumer's two write passes, macadamConsumer.ts:224-244,
    v210.ts:126-129)."""
    rows = torch.arange(top.shape[-2], device=top.device)
    return torch.where((rows % 2 == 0)[None, :, None], top, bottom)
