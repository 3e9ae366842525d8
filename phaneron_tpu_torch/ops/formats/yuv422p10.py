"""yuv422p10le: 10-bit planar 4:2:2 (reference: src/process/yuv422p10.ts).
Counterpart of phaneron_tpu/ops/formats/yuv422p10.py; planes are
torch.uint16 tensors (numpy uint16 on the host), little-endian samples
in the low 10 bits."""

from __future__ import annotations

import numpy as np
import torch

from . import planar
from .common import FormatInfo

INFO = FormatInfo(
    name="yuv422p10le",
    num_bits=10,
    luma_black=64,
    luma_white=940,
    chroma_range=896,
    is_rgb=False,
    sub_x=2,
    sub_y=1,
)

pitch = planar.pitch


def pitch_bytes(width: int) -> int:
    return pitch(width) * 2


def num_bytes(width: int, height: int) -> list[int]:
    luma = pitch_bytes(width) * height
    return [luma, luma // 2, luma // 2]


def plane_shapes(width: int, height: int):
    p = pitch(width)
    u16 = np.dtype(np.uint16)
    return [((height, p), u16), ((height, p // 2), u16), ((height, p // 2), u16)]


def from_bytes(data: bytes, width: int, height: int) -> list[np.ndarray]:
    arr = np.frombuffer(data, dtype=np.uint16)
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
    return planar.pack_422(INFO, torch.uint16, y, cb, cr, width, height)


def black_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.black_422(INFO, np.uint16, width, height)


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.fill_422(INFO, np.uint16, width, height)
