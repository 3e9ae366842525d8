"""The unpack and pack kernels of the channel frame program.

Counterpart of phaneron_tpu/ops/pallas_kernels.py.  Each kernel has:

- a plain PyTorch version (``*_plain``): the JAX package's XLA
  formulation in torch ops (ops/io.py with the analytic transfer
  function), which the CPU tests hold against JAX;
- a wrapper, which runs the plain version for CPU tensors and, for CUDA
  tensors, checks device, dtype, shape and contiguity, allocates the
  outputs, launches the CUDA kernel (csrc/) on the current stream and
  raises if the launch failed.  There is no fallback on the card;
- a plain-integer launch counter on the wrapper (``wrapper.launches``),
  incremented once per kernel launch and nowhere else.

| wrapper            | CUDA source                  | replaces (phaneron_tpu/ops/pallas_kernels.py)             |
|--------------------|------------------------------|-----------------------------------------------------------|
| v210_unpack        | csrc/v210_unpack.cu          | _make_v210_spatial_unpack (C 3, 4), make_v210_unpack_rgba  |
| v210_pack          | csrc/v210_pack.cu            | make_v210_pack_rgba                                        |
| planar422_unpack   | csrc/planar422_unpack.cu     | _make_planar422_spatial_unpack, make_planar422_unpack_rgba |
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from . import colour_maths as cm
from ._build import library
from .coeffs import make_loader, make_saver
from .formats import v210 as v210fmt
from .formats import yuv422p8 as yuv422p8fmt
from .gamma import g2l_constants, l2g_constants
from .io import from_rgba, to_rgba

__all__ = [
    "v210_unpack",
    "v210_unpack_plain",
    "v210_pack",
    "v210_pack_plain",
    "planar422_unpack",
    "planar422_unpack_plain",
    "MAX_SRCS",
]

MAX_SRCS = 8  # sources per v210_unpack launch (kMaxSrcs in csrc/v210_unpack.cu)


# ------------------------------------------------------------- helpers


def is_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA
    tensor (launch the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def check_arg(
    t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype,
    shape: tuple[int, ...], align: int = 4,
) -> None:
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _c_floats(values) -> ctypes.Array:
    flat = [float(v) for v in np.asarray(values, dtype=np.float32).reshape(-1)]
    return (ctypes.c_float * len(flat))(*flat)


@lru_cache(maxsize=None)
def _decode_coeffs(num_bits: int, black: int, white: int, chroma: int,
                   col_spec: str, out_col_spec: str) -> ctypes.Array:
    """col[12], gamut[9], g2l[6] for csrc Decode (phn_common.cuh)."""
    col = cm.ycbcr2rgb_matrix(col_spec, num_bits, black, white, chroma)
    gamut = cm.rgb2rgb_matrix(col_spec, out_col_spec)
    return _c_floats(np.concatenate([col.ravel(), gamut.ravel(), g2l_constants(col_spec)]))


@lru_cache(maxsize=None)
def _encode_coeffs(out_col_spec: str) -> ctypes.Array:
    """col[12], l2g[6] for csrc Encode (phn_common.cuh)."""
    col = cm.rgb2ycbcr_matrix(out_col_spec, 10, 64, 940, 896)
    return _c_floats(np.concatenate([col.ravel(), l2g_constants(out_col_spec)]))


@lru_cache(maxsize=None)
def _loader(fmt_name: str, col_spec: str, out_col_spec: str, device: torch.device):
    info = v210fmt.INFO if fmt_name == "v210" else yuv422p8fmt.INFO
    return make_loader(info, col_spec, out_col_spec, "analytic", device)


@lru_cache(maxsize=None)
def _saver(out_col_spec: str, device: torch.device):
    return make_saver(v210fmt.INFO, out_col_spec, "analytic", device)


# ------------------------------------------------------- K1 v210 unpack


def v210_unpack_plain(
    words: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", channels: int = 4,
) -> list[torch.Tensor]:
    """Plain version of v210_unpack: each (H, G*4) int32 word tensor ->
    linear RGB(A) (channels, H, W) float32."""
    return [
        to_rgba(
            v210fmt, [w], _loader("v210", col_spec, out_col_spec, w.device), width, height
        )[:channels]
        for w in words
    ]


def v210_unpack(
    words: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", channels: int = 4,
) -> list[torch.Tensor]:
    """v210 words -> linear RGB(A) (channels, H, W) float32 for every
    source, up to MAX_SRCS sources per launch.  ``channels`` 4 gives RGBA
    with alpha 1, 3 the alpha-free opaque frames of the deinterlace ring.
    Each word tensor is (H, pitch_bytes/4) int32 holding the uint32 bit
    pattern."""
    if channels not in (3, 4):
        raise ValueError(f"v210_unpack: channels must be 3 or 4, got {channels}")
    if not words:
        return []
    if is_cpu(words[0], "v210_unpack"):
        return v210_unpack_plain(words, width, height, col_spec, out_col_spec, channels)
    dev = words[0].device
    groups = v210fmt.pitch(width) // 6
    for w in words:
        check_arg(w, "v210_unpack words", dev, torch.int32, (height, groups * 4), align=16)
    outs = [
        torch.empty((channels, height, width), dtype=torch.float32, device=dev) for _ in words
    ]
    coeffs = _decode_coeffs(10, 64, 940, 896, col_spec, out_col_spec)
    lib = library()
    with torch.cuda.device(dev):
        stream = stream_handle(dev)
        for i in range(0, len(words), MAX_SRCS):
            chunk = range(i, min(i + MAX_SRCS, len(words)))
            ins = (ctypes.c_void_p * len(chunk))(*(words[j].data_ptr() for j in chunk))
            outp = (ctypes.c_void_p * len(chunk))(*(outs[j].data_ptr() for j in chunk))
            rc = lib.phn_v210_unpack(
                ctypes.addressof(ins), ctypes.addressof(outp), len(chunk),
                width, height, groups, channels, ctypes.addressof(coeffs), stream,
            )
            check_launch(rc, "v210_unpack")
            v210_unpack.launches += 1
    return outs


v210_unpack.launches = 0


# --------------------------------------------------------- K2 v210 pack


def v210_pack_plain(rgb: torch.Tensor, out_col_spec: str = "709") -> torch.Tensor:
    """Plain version of v210_pack."""
    _, h, w = rgb.shape
    return from_rgba(v210fmt, rgb, _saver(out_col_spec, rgb.device), w, h)[0]


def v210_pack(rgb: torch.Tensor, out_col_spec: str = "709") -> torch.Tensor:
    """Linear RGB(A) (C, H, W) float32, C = 3 or 4 -> v210 words (H,
    pitch_bytes/4) int32.  Alpha is never read; pitch-pad fields are 0."""
    if rgb.ndim != 3 or rgb.shape[0] not in (3, 4):
        raise ValueError(f"v210_pack: expected (3|4, H, W), got {tuple(rgb.shape)}")
    if is_cpu(rgb, "v210_pack"):
        return v210_pack_plain(rgb, out_col_spec)
    c, h, w = rgb.shape
    check_arg(rgb, "v210_pack rgb", rgb.device, torch.float32, (c, h, w))
    groups = v210fmt.pitch(w) // 6
    out = torch.empty((h, groups * 4), dtype=torch.int32, device=rgb.device)
    with torch.cuda.device(rgb.device):
        rc = library().phn_v210_pack(
            rgb.data_ptr(), out.data_ptr(), w, h, groups,
            ctypes.addressof(_encode_coeffs(out_col_spec)), stream_handle(rgb.device),
        )
    check_launch(rc, "v210_pack")
    v210_pack.launches += 1
    return out


v210_pack.launches = 0


# ------------------------------------------------- K3 planar 4:2:2 unpack


def planar422_unpack_plain(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709",
) -> torch.Tensor:
    """Plain version of planar422_unpack."""
    loader = _loader("yuv422p8", col_spec, out_col_spec, planes[0].device)
    return to_rgba(yuv422p8fmt, list(planes), loader, width, height)


def planar422_unpack(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709",
) -> torch.Tensor:
    """yuv422p8 planes -> linear RGBA (4, H, W) float32.  Planes are
    uint8 y (H, pitch) and u, v (H, pitch/2), pitch = width rounded up
    to 8."""
    y, u, v = planes
    if is_cpu(y, "planar422_unpack"):
        return planar422_unpack_plain(planes, width, height, col_spec, out_col_spec)
    p = yuv422p8fmt.pitch(width)
    check_arg(y, "planar422_unpack y", y.device, torch.uint8, (height, p), align=1)
    check_arg(u, "planar422_unpack u", y.device, torch.uint8, (height, p // 2), align=1)
    check_arg(v, "planar422_unpack v", y.device, torch.uint8, (height, p // 2), align=1)
    info = yuv422p8fmt.INFO
    coeffs = _decode_coeffs(
        info.num_bits, info.luma_black, info.luma_white, info.chroma_range,
        col_spec, out_col_spec,
    )
    out = torch.empty((4, height, width), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = library().phn_planar422_unpack(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            width, height, p, p // 2, ctypes.addressof(coeffs), stream_handle(y.device),
        )
    check_launch(rc, "planar422_unpack")
    planar422_unpack.launches += 1
    return out


planar422_unpack.launches = 0
