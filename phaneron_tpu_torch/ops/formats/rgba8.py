"""rgba8: 8-bit interleaved RGBA (reference: src/process/rgba8.ts).
Counterpart of phaneron_tpu/ops/formats/rgba8.py; one (H, W, 4) uint8
plane.

Read converts gamma-encoded 8-bit codes to linear float through the
transfer function at index code * 257 (exactly rte(c * 65535 / 255),
rgba8.ts:53-61); alpha passes through the same transfer function.
Write emits convert_uchar_sat_rte(l2g(v) * 255) with alpha forced to
255 (rgba8.ts:94-97).  bgra8 is the same format with R and B swapped
(``CHANNEL_ORDER``)."""

from __future__ import annotations

import numpy as np
import torch

from .common import FormatInfo

INFO = FormatInfo(
    name="rgba8",
    num_bits=8,
    luma_black=16,
    luma_white=235,
    chroma_range=224,
    is_rgb=True,
)

CHANNEL_ORDER = (0, 1, 2, 3)  # byte positions of R, G, B, A


def pitch(width: int) -> int:
    return width


def pitch_bytes(width: int) -> int:
    return width * 4


def num_bytes(width: int, height: int) -> list[int]:
    return [pitch_bytes(width) * height]


def plane_shapes(width: int, height: int):
    return [((height, width, 4), np.dtype(np.uint8))]


def from_bytes(data: bytes, width: int, height: int) -> list[np.ndarray]:
    return [np.frombuffer(data, dtype=np.uint8).reshape(height, width, 4)]


def unpack_rgba_codes_in(order, planes) -> torch.Tensor:
    """(H, W, 4) bytes in the byte ``order`` of R, G, B, A -> (4, H, W)
    int32 codes in R, G, B, A order."""
    px = planes[0].to(torch.int32)
    return torch.stack([px[:, :, i] for i in order])


def pack_rgba_codes_in(order, codes: torch.Tensor) -> list[torch.Tensor]:
    """(4, H, W) int32 codes (R, G, B, A order) -> (H, W, 4) bytes in the
    byte ``order``."""
    inv = [order.index(i) for i in range(4)]
    return [torch.stack([codes[c] for c in inv], dim=-1).to(torch.uint8)]


def fill_in(order, width: int, height: int) -> list[np.ndarray]:
    """Constant R=16 G=32 B=64 A=255 field (rgba8.ts:114-133)."""
    px = np.zeros((height, width, 4), dtype=np.uint8)
    for i, v in zip(order, (16, 32, 64, 255)):
        px[:, :, i] = v
    return [px]


def unpack_rgba_codes(planes, width: int, height: int) -> torch.Tensor:
    return unpack_rgba_codes_in(CHANNEL_ORDER, planes)


def pack_rgba_codes(codes: torch.Tensor, width: int, height: int) -> list[torch.Tensor]:
    return pack_rgba_codes_in(CHANNEL_ORDER, codes)


def black_buf(width: int, height: int) -> list[np.ndarray]:
    """Zeros are black for RGB formats (transparent black, the reference
    Black generator's zeroed buffer, blackSilence.ts:109-153)."""
    return [np.zeros((height, width, 4), dtype=np.uint8)]


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    return fill_in(CHANNEL_ORDER, width, height)
