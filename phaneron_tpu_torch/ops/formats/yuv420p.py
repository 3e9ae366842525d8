"""yuv420p: 8-bit planar 4:2:0 (reference: src/process/yuv420p.ts).
Counterpart of phaneron_tpu/ops/formats/yuv420p.py; planes are uint8,
chroma (H+1)/2 rows of pitch/2 samples."""

from __future__ import annotations

import numpy as np
import torch

from . import planar
from .common import FormatInfo

INFO = FormatInfo(
    name="yuv420p",
    num_bits=8,
    luma_black=16,
    luma_white=235,
    chroma_range=224,
    is_rgb=False,
    sub_x=2,
    sub_y=2,
)

pitch = planar.pitch


def pitch_bytes(width: int) -> int:
    return pitch(width)


def num_bytes(width: int, height: int) -> list[int]:
    luma = pitch_bytes(width) * height
    return [luma, luma // 4, luma // 4]


def plane_shapes(width: int, height: int):
    p = pitch(width)
    h2 = (height + 1) // 2
    u8 = np.dtype(np.uint8)
    return [((height, p), u8), ((h2, p // 2), u8), ((h2, p // 2), u8)]


def from_bytes(data: bytes, width: int, height: int) -> list[np.ndarray]:
    arr = np.frombuffer(data, dtype=np.uint8)
    p = pitch(width)
    h2 = (height + 1) // 2
    ly = height * p
    lc = h2 * (p // 2)
    return [
        arr[:ly].reshape(height, p),
        arr[ly : ly + lc].reshape(h2, p // 2),
        arr[ly + lc : ly + 2 * lc].reshape(h2, p // 2),
    ]


def unpack_codes(planes, width: int, height: int):
    return planar.unpack_420(planes, width, height)


def pack_codes(y, cb, cr, width: int, height: int):
    return planar.pack_420(INFO, torch.uint8, y, cb, cr, width, height)


def black_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.black_420(INFO, np.uint8, width, height, interleaved=False)


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.fill_420(INFO, np.uint8, width, height, interleaved=False)
