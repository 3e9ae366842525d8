"""bgra8: 8-bit interleaved BGRA, for screen and web consumers
(reference: src/process/bgra8.ts).  Counterpart of
phaneron_tpu/ops/formats/bgra8.py: rgba8's arithmetic with the R and B
bytes swapped (bgra8.ts:53-62, 96-99)."""

from __future__ import annotations

import numpy as np
import torch

from .common import FormatInfo
from .rgba8 import (
    black_buf,
    fill_in,
    from_bytes,
    num_bytes,
    pack_rgba_codes_in,
    pitch,
    pitch_bytes,
    plane_shapes,
    unpack_rgba_codes_in,
)

__all__ = [
    "INFO", "CHANNEL_ORDER", "pitch", "pitch_bytes", "num_bytes", "plane_shapes", "from_bytes",
    "unpack_rgba_codes", "pack_rgba_codes", "black_buf", "fill_buf",
]

INFO = FormatInfo(
    name="bgra8",
    num_bits=8,
    luma_black=16,
    luma_white=235,
    chroma_range=224,
    is_rgb=True,
)

CHANNEL_ORDER = (2, 1, 0, 3)  # byte positions of R, G, B, A


def unpack_rgba_codes(planes, width: int, height: int) -> torch.Tensor:
    return unpack_rgba_codes_in(CHANNEL_ORDER, planes)


def pack_rgba_codes(codes: torch.Tensor, width: int, height: int) -> list[torch.Tensor]:
    return pack_rgba_codes_in(CHANNEL_ORDER, codes)


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    return fill_in(CHANNEL_ORDER, width, height)
