"""yuv422p: 8-bit planar 4:2:2 (reference: src/process/yuv422p8.ts).
Counterpart of phaneron_tpu/ops/formats/yuv422p8.py; planes are uint8."""

from __future__ import annotations

import numpy as np
import torch

from . import planar
from .common import FormatInfo

INFO = FormatInfo(
    name="yuv422p",
    num_bits=8,
    luma_black=16,
    luma_white=235,
    chroma_range=224,
    is_rgb=False,
    sub_x=2,
    sub_y=1,
)

pitch = planar.pitch


def pitch_bytes(width: int) -> int:
    return pitch(width)


def num_bytes(width: int, height: int) -> list[int]:
    luma = pitch_bytes(width) * height
    return [luma, luma // 2, luma // 2]


def plane_shapes(width: int, height: int):
    p = pitch(width)
    u8 = np.dtype(np.uint8)
    return [((height, p), u8), ((height, p // 2), u8), ((height, p // 2), u8)]


def from_bytes(data: bytes, width: int, height: int) -> list[np.ndarray]:
    arr = np.frombuffer(data, dtype=np.uint8)
    p = pitch(width)
    ly = height * p
    lc = ly // 2
    return [
        arr[:ly].reshape(height, p),
        arr[ly : ly + lc].reshape(height, p // 2),
        arr[ly + lc :].reshape(height, p // 2),
    ]


def unpack_codes(planes, width: int, height: int):
    return planar.unpack_422(planes, width, height)


def pack_codes(y, cb, cr, width: int, height: int):
    return planar.pack_422(INFO, torch.uint8, y, cb, cr, width, height)


def black_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.black_422(INFO, np.uint8, width, height)


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.fill_422(INFO, np.uint8, width, height)
