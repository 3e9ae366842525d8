"""to_rgba / from_rgba — the ToRGBA/FromRGBA stage equivalents
(counterpart of phaneron_tpu/ops/io.py; io.ts:26-179).

``to_rgba`` maps packed plane tensors to a linear (4, H, W) RGBA frame;
``from_rgba`` maps a frame back to packed planes;
``interleave_rgba_fields`` merges two field-rate frames into one
interlaced frame.  The port's formats
are all YCbCr; the RGB formats stay in ROADMAP.md Queue A (A2).
"""

from __future__ import annotations

import torch

from .coeffs import Loader, Saver
from .colorspace import rgba_to_ycbcr, ycbcr_to_rgba

__all__ = ["to_rgba", "from_rgba", "interleave_rgba_fields"]


def to_rgba(fmt, planes, loader: Loader, width: int, height: int) -> torch.Tensor:
    """Packed planes -> linear RGBA (4, H, W) float32."""
    y, cb, cr = fmt.unpack_codes(planes, width, height)
    return ycbcr_to_rgba(
        y, cb, cr, loader.col_matrix, loader.gamma.of, loader.gamut_matrix
    )


def from_rgba(
    fmt, rgba: torch.Tensor, saver: Saver, width: int, height: int
) -> list[torch.Tensor]:
    """Linear RGB(A) (C, H, W) -> packed planes (progressive)."""
    y, cb, cr = rgba_to_ycbcr(rgba, saver.col_matrix, saver.gamma.of)
    return fmt.pack_codes(y, cb, cr, width, height)


def interleave_rgba_fields(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Merge two full-height field frames into one interlaced frame: even
    lines from ``top``, odd lines from ``bottom`` (the reference
    consumer's two write passes, macadamConsumer.ts:224-244,
    v210.ts:126-129)."""
    rows = torch.arange(top.shape[-2], device=top.device)
    return torch.where((rows % 2 == 0)[None, :, None], top, bottom)
