"""nv12: 8-bit semi-planar 4:2:0 with one interleaved CbCr plane
(reference: src/process/nv12.ts).  Counterpart of
phaneron_tpu/ops/formats/nv12.py; planes are uint8: Y (H, pitch) and
CbCr ((H+1)/2, pitch), Cb at even and Cr at odd samples."""

from __future__ import annotations

import numpy as np
import torch

from . import planar
from .common import FormatInfo, upsample_420

INFO = FormatInfo(
    name="nv12",
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
    return [luma, luma // 2]


def plane_shapes(width: int, height: int):
    p = pitch(width)
    h2 = (height + 1) // 2
    u8 = np.dtype(np.uint8)
    return [((height, p), u8), ((h2, p), u8)]


def from_bytes(data: bytes, width: int, height: int) -> list[np.ndarray]:
    arr = np.frombuffer(data, dtype=np.uint8)
    p = pitch(width)
    h2 = (height + 1) // 2
    ly = height * p
    return [arr[:ly].reshape(height, p), arr[ly : ly + h2 * p].reshape(h2, p)]


def unpack_codes(planes, width: int, height: int):
    y_plane, c_plane = planes
    n_chroma = (width + 1) // 2
    y = y_plane[:, :width].to(torch.int32)
    cb = upsample_420(c_plane[:, 0 : 2 * n_chroma : 2].to(torch.int32), width, height)
    cr = upsample_420(c_plane[:, 1 : 2 * n_chroma : 2].to(torch.int32), width, height)
    return y, cb, cr


def pack_codes(y, cb, cr, width: int, height: int):
    yp, up, vp = planar.pack_420(INFO, torch.uint8, y, cb, cr, width, height)
    return [yp, torch.stack([up, vp], dim=-1).reshape(up.shape[0], -1)]


def black_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.black_420(INFO, np.uint8, width, height, interleaved=True)


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    return planar.fill_420(INFO, np.uint8, width, height, interleaved=True)
