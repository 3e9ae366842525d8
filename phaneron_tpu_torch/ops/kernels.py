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
| v210_pack          | csrc/combine_pack.cu         | make_v210_pack_rgba                                        |
| planar422_unpack   | csrc/planar422_unpack.cu     | _make_planar422_spatial_unpack, make_planar422_unpack_rgba |
| planar422_pack     | csrc/planar422_pack.cu       | make_planar422_pack_rgba                                   |
| planar420_unpack   | csrc/planar420_unpack.cu     | _make_planar420_spatial_unpack, make_planar420_unpack_rgba |
| planar420_pack     | csrc/planar420_pack.cu       | make_planar420_pack_rgba                                   |
| fused_v210         | csrc/fused_v210.cu           | make_fused_v210_program (_make_kernel)                     |
| combine_pack       | csrc/combine_pack.cu         | make_v210_combine_pack                                     |
| rgb8_unpack        | csrc/rgb8_unpack.cu          | none: the JAX package decodes rgba8 and bgra8 in XLA       |

The planar wrappers take the format by name (yuv422p8 or yuv422p10le for
4:2:2, yuv420p or nv12 for 4:2:0) and key their coefficients, sample
type and pad codes on its INFO; rgb8_unpack takes rgba8 or bgra8 by name
and keys the byte order on its CHANNEL_ORDER.  The RGB formats' encode
has no kernel: ops/io.py packs them in torch ops, as the JAX package
does in XLA.

Every decode gathers gamma'->linear from ops/gamma.py g2l_table; the
kernels receive the same table on their device (``g2l_table_on``).  Every
encode (K2, B3, B5, B11, B13) computes linear->gamma' without powf, moved
to powf's bits by a correction byte an index (``l2g_corrections_on``,
csrc/l2g_corrections.cu).  K2 and B5 are one kernel (csrc/combine_pack.cu,
phn_common.cuh ``v210_segments``): K2 launches it over one layer.
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import colour_maths as cm
from ._build import library
from .coeffs import make_loader, make_saver
from .colorspace import rgba_to_ycbcr
from .composite import combine, combine_rgb, mix_frames
from .formats import get_format
from .formats import v210 as v210fmt
from .gamma import INV_LUT_MAX, g2l_table_on, l2g_constants
from .io import from_rgba, to_rgba

__all__ = [
    "v210_unpack",
    "v210_unpack_plain",
    "v210_pack",
    "v210_pack_plain",
    "planar422_unpack",
    "planar422_unpack_plain",
    "planar422_pack",
    "planar422_pack_plain",
    "planar420_unpack",
    "planar420_unpack_plain",
    "planar420_pack",
    "planar420_pack_plain",
    "rgb8_unpack",
    "rgb8_unpack_plain",
    "rgb8_unpack_args",
    "PLANAR422",
    "PLANAR420",
    "RGB8",
    "decode_args",
    "format_loader",
    "format_saver",
    "fused_v210",
    "fused_v210_plain",
    "l2g_corrections_on",
    "combine_pack",
    "combine_pack_plain",
    "MAX_SRCS",
    "MAX_LAYERS",
    "Rows",
    "check_window",
    "launched",
    "recording",
]

MAX_SRCS = 8  # sources per v210_unpack launch (kMaxSrcs in csrc/v210_unpack.cu)
MAX_LAYERS = 8  # layers per combine_pack launch (kMaxLayers in csrc/phn_common.cuh)
PLANAR422 = ("yuv422p10le", "yuv422p10", "yuv422p", "yuv422p8")  # K3 / B10, B11
PLANAR420 = ("yuv420p", "nv12")  # B12, B13
RGB8 = ("rgba8", "rgba", "bgra8", "bgra")  # rgb8_unpack


# ------------------------------------------------------------- helpers


class Rows(NamedTuple):
    """The rows of a band form (a row-sharded channel, parallel/bands.py):
    the launch computes output rows [row0, row1) of a frame ``height`` rows
    tall, from sources that are windows of the frame's rows whose first row
    is ``src_row0`` (the packed composite: a tuple, one first row a source).
    Coordinates stay the frame's own, so each output row equals that row of
    the full-frame call.  ``Rows.full(h)`` is the whole frame."""

    row0: int
    row1: int
    height: int
    src_row0: int | tuple = 0

    @classmethod
    def full(cls, height: int) -> "Rows":
        return cls(0, height, height, 0)

    @property
    def n(self) -> int:
        """The output rows."""
        return self.row1 - self.row0

    def check(self, name: str, src_rows: int, src_row0: int | None = None) -> None:
        """Raise unless the output rows and a source window of ``src_rows``
        rows from ``src_row0`` (default: this band's) lie inside the frame."""
        r0 = self.src_row0 if src_row0 is None else src_row0
        if not (0 <= self.row0 < self.row1 <= self.height):
            raise ValueError(f"{name}: rows [{self.row0}, {self.row1}) outside a {self.height}-row frame")
        if not (0 <= r0 and src_rows > 0 and r0 + src_rows <= self.height):
            raise ValueError(f"{name}: a source window of {src_rows} rows from row {r0} leaves the "
                             f"{self.height}-row frame")


def check_window(t: torch.Tensor, name: str, device: torch.device, shape: tuple[int, ...]) -> None:
    """check_arg for a float32 (C, rows, W) source window that a band form
    reads through its plane stride: each row contiguous and ``W`` floats
    after the last, the planes ``t.stride(0)`` floats apart (a view of a
    taller frame's rows passes without a copy)."""
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1] or t.stride(0) < t.shape[-2] * t.shape[-1]:
        raise ValueError(f"{name}: rows must be contiguous and planes must not overlap")
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: data must be 4-byte aligned")


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


_recorder = threading.local()


def launched(wrapper) -> None:
    """Count one launch of a kernel wrapper: its ``launches``, or on a
    thread inside ``recording()`` (a CUDA graph capture: nothing runs) the
    recording's count."""
    counts = getattr(_recorder, "counts", None)
    if counts is None:
        wrapper.launches += 1
    else:
        counts[wrapper] = counts.get(wrapper, 0) + 1


@contextmanager
def recording():
    """{wrapper: launches} of this thread's launches while inside, which
    leave the wrappers' ``launches`` as they were (graph/replay.py adds
    them to those counters at each replay)."""
    counts: dict = {}
    _recorder.counts = counts
    try:
        yield counts
    finally:
        _recorder.counts = None


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _c_floats(values) -> ctypes.Array:
    flat = [float(v) for v in np.asarray(values, dtype=np.float32).reshape(-1)]
    return (ctypes.c_float * len(flat))(*flat)


@lru_cache(maxsize=None)
def _decode_coeffs(fmt_name: str, col_spec: str, out_col_spec: str) -> ctypes.Array:
    """col[12], gamut[9] for csrc Decode (phn_common.cuh) of a format's
    codes; its gamma'->linear table is g2l_table_on(col_spec, device)."""
    info = get_format(fmt_name).INFO
    col = cm.ycbcr2rgb_matrix(
        col_spec, info.num_bits, info.luma_black, info.luma_white, info.chroma_range
    )
    gamut = cm.rgb2rgb_matrix(col_spec, out_col_spec)
    return _c_floats(np.concatenate([col.ravel(), gamut.ravel()]))


def decode_args(
    fmt_name: str, col_spec: str, out_col_spec: str, device: torch.device
) -> tuple[int, int]:
    """(coefficient array address, table pointer) of a decode of the
    format's codes on ``device``."""
    coeffs = _decode_coeffs(fmt_name, col_spec, out_col_spec)
    return ctypes.addressof(coeffs), g2l_table_on(col_spec, device).data_ptr()


def v210_decode_args(col_spec: str, out_col_spec: str, device: torch.device) -> tuple[int, int]:
    """The decode arguments of every kernel reading v210 words."""
    return decode_args("v210", col_spec, out_col_spec, device)


@lru_cache(maxsize=None)
def _encode_coeffs(out_col_spec: str, fmt_name: str = "v210") -> ctypes.Array:
    """col[12], l2g[6] for csrc Encode (phn_common.cuh), sized for the
    format's bit depth and ranges."""
    info = get_format(fmt_name).INFO
    col = cm.rgb2ycbcr_matrix(
        out_col_spec, info.num_bits, info.luma_black, info.luma_white, info.chroma_range
    )
    return _c_floats(np.concatenate([col.ravel(), l2g_constants(out_col_spec)]))


@lru_cache(maxsize=None)
def format_loader(fmt_name: str, col_spec: str, out_col_spec: str, device: torch.device,
                  gamma_mode: str = "analytic"):
    """The format's ToRGBA coefficients on ``device``, built once: what the
    plain versions and the RGB formats' torch ops decode with."""
    return make_loader(get_format(fmt_name).INFO, col_spec, out_col_spec, gamma_mode, device)


@lru_cache(maxsize=None)
def format_saver(fmt_name: str, out_col_spec: str, device: torch.device, gamma_mode: str = "analytic"):
    """The format's FromRGBA coefficients on ``device``, built once."""
    return make_saver(get_format(fmt_name).INFO, out_col_spec, gamma_mode, device)


def _planar_format(fmt_name: str, names: tuple[str, ...], who: str):
    if fmt_name not in names:
        raise ValueError(f"{who}: format '{fmt_name}' is not one of {names}")
    return get_format(fmt_name)


def _sample_dtype(info) -> torch.dtype:
    return torch.uint16 if info.num_bits > 8 else torch.uint8


def _check_rgb(rgb: torch.Tensor, who: str) -> None:
    if rgb.ndim != 3 or rgb.shape[0] not in (3, 4):
        raise ValueError(f"{who}: expected (3|4, H, W), got {tuple(rgb.shape)}")


def _planar_codes_plain(fmt, rgb: torch.Tensor, out_col_spec: str) -> list[torch.Tensor]:
    """The planar packs' plain version, term for term as csrc
    phn::encode_quad: linear->gamma', the format's encode matrix, rte and
    saturation, the mask to its bit depth, then the format's pack (chroma
    subsampling, the pad codes, the sample type).  Alpha is not read."""
    _, h, w = rgb.shape
    saver = format_saver(fmt.INFO.name, out_col_spec, rgb.device)
    mask = (1 << fmt.INFO.num_bits) - 1
    y, cb, cr = (c & mask for c in rgba_to_ycbcr(rgb, saver.col_matrix, saver.gamma.of))
    return fmt.pack_codes(y, cb, cr, w, h)


# ------------------------------------------------------- K1 v210 unpack


def v210_unpack_plain(
    words: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", channels: int = 4,
) -> list[torch.Tensor]:
    """Plain version of v210_unpack: each (H, G*4) int32 word tensor ->
    linear RGB(A) (channels, H, W) float32."""
    return [
        to_rgba(
            v210fmt, [w], format_loader("v210", col_spec, out_col_spec, w.device), width, height
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
    coeffs, g2l = v210_decode_args(col_spec, out_col_spec, dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = stream_handle(dev)
        for i in range(0, len(words), MAX_SRCS):
            chunk = range(i, min(i + MAX_SRCS, len(words)))
            ins = (ctypes.c_void_p * len(chunk))(*(words[j].data_ptr() for j in chunk))
            outp = (ctypes.c_void_p * len(chunk))(*(outs[j].data_ptr() for j in chunk))
            rc = lib.phn_v210_unpack(
                ctypes.addressof(ins), ctypes.addressof(outp), len(chunk),
                width, height, groups, channels, coeffs, g2l, stream,
            )
            check_launch(rc, "v210_unpack")
            launched(v210_unpack)
    return outs


v210_unpack.launches = 0


# --------------------------------------------------------- K2 v210 pack


def v210_pack_plain(rgb: torch.Tensor, out_col_spec: str = "709") -> torch.Tensor:
    """Plain version of v210_pack."""
    _, h, w = rgb.shape
    return from_rgba(v210fmt, rgb, format_saver("v210", out_col_spec, rgb.device), w, h)[0]


def v210_pack(rgb: torch.Tensor, out_col_spec: str = "709") -> torch.Tensor:
    """Linear RGB(A) (C, H, W) float32, C = 3 or 4 -> v210 words (H,
    pitch_bytes/4) int32.  Alpha is never read; pitch-pad fields are 0.
    The kernel reads ``l2g_corrections_on(out_col_spec, device)``, built
    at the first call unless a channel program's ``prepare(device)`` built
    it (one more launch, counted there, and a host wait)."""
    _check_rgb(rgb, "v210_pack")
    if is_cpu(rgb, "v210_pack"):
        return v210_pack_plain(rgb, out_col_spec)
    c, h, w = rgb.shape
    dev = rgb.device
    check_arg(rgb, "v210_pack rgb", dev, torch.float32, (c, h, w))
    groups = v210fmt.pitch(w) // 6
    out = torch.empty((h, groups * 4), dtype=torch.int32, device=dev)
    corr = l2g_corrections_on(out_col_spec, dev)
    with torch.cuda.device(dev):
        rc = library().phn_v210_pack(
            rgb.data_ptr(), out.data_ptr(), w, h, groups,
            ctypes.addressof(_encode_coeffs(out_col_spec)), corr.data_ptr(), stream_handle(dev),
        )
    check_launch(rc, "v210_pack")
    launched(v210_pack)
    return out


v210_pack.launches = 0


# ------------------------------------ K3 / B10 planar 4:2:2 unpack


def planar422_unpack_plain(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", fmt_name: str = "yuv422p8",
) -> torch.Tensor:
    """Plain version of planar422_unpack."""
    fmt = _planar_format(fmt_name, PLANAR422, "planar422_unpack")
    loader = format_loader(fmt_name, col_spec, out_col_spec, planes[0].device)
    return to_rgba(fmt, list(planes), loader, width, height)


def planar422_unpack(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", fmt_name: str = "yuv422p8",
) -> torch.Tensor:
    """Planar 4:2:2 planes -> linear RGBA (4, H, W) float32.  Planes are
    y (H, pitch) and u, v (H, pitch/2), pitch = width rounded up to 8:
    uint8 for yuv422p8, torch.uint16 10-bit codes for yuv422p10le."""
    fmt = _planar_format(fmt_name, PLANAR422, "planar422_unpack")
    y, u, v = planes
    if is_cpu(y, "planar422_unpack"):
        return planar422_unpack_plain(planes, width, height, col_spec, out_col_spec, fmt_name)
    info = fmt.INFO
    dtype = _sample_dtype(info)
    p = fmt.pitch(width)
    align = dtype.itemsize
    check_arg(y, "planar422_unpack y", y.device, dtype, (height, p), align=align)
    check_arg(u, "planar422_unpack u", y.device, dtype, (height, p // 2), align=align)
    check_arg(v, "planar422_unpack v", y.device, dtype, (height, p // 2), align=align)
    coeffs, g2l = decode_args(fmt_name, col_spec, out_col_spec, y.device)
    out = torch.empty((4, height, width), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = library().phn_planar422_unpack(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            width, height, p, p // 2, info.num_bits, coeffs, g2l, stream_handle(y.device),
        )
    check_launch(rc, "planar422_unpack")
    launched(planar422_unpack)
    return out


planar422_unpack.launches = 0


# ------------------------------------------- linear->gamma' corrections


@lru_cache(maxsize=None)
def l2g_corrections_on(out_col_spec: str, device: torch.device) -> torch.Tensor:
    """The l2g corrections of out_col_spec on ``device``: 65536 int8, at
    each table index of linear->gamma' the difference between the bits of
    its power by CUDA's full-precision powf and by the two-instruction
    approximation that K2, B3, B5, B11 and B13 compute instead, computed
    there by the kernel library (csrc/l2g_corrections.cu), so those
    kernels' linear->gamma' equals powf's to the bit.  Built once per
    device and col_spec, by one launch (counted in
    ``l2g_corrections_on.launches``, never in a pack's counter) and a host
    wait for its check; raises if a difference does not fit a byte.  A
    channel program's ``prepare(device)`` (graph/pipeline.py) calls it
    before the first frame of a structure that packs with K2, B5, B11 or
    B13."""
    corr = torch.empty(65536, dtype=torch.int8, device=device)
    bad = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = library().phn_l2g_corrections(
            corr.data_ptr(), bad.data_ptr(), ctypes.addressof(_encode_coeffs(out_col_spec)),
            stream_handle(device),
        )
        check_launch(rc, "l2g corrections")
        launched(l2g_corrections_on)
        if int(bad.item()):
            raise RuntimeError(f"l2g corrections: {int(bad.item())} of {out_col_spec} do not fit a byte")
    return corr


l2g_corrections_on.launches = 0


# ---------------------------------------------- B11 planar 4:2:2 pack


def planar422_pack_plain(rgb: torch.Tensor, fmt_name: str, out_col_spec: str = "709") -> list:
    """Plain version of planar422_pack."""
    fmt = _planar_format(fmt_name, PLANAR422, "planar422_pack")
    return _planar_codes_plain(fmt, rgb, out_col_spec)


def planar422_pack(rgb: torch.Tensor, fmt_name: str, out_col_spec: str = "709") -> list:
    """Linear RGB(A) (C, H, W) float32, C = 3 or 4 -> planar 4:2:2 planes
    [y (H, pitch), u (H, pitch/2), v (H, pitch/2)] of the format's sample
    type.  Chroma comes from even pixels; the pitch pad and an odd width's
    missing pixel pack as black luma and null chroma.  Alpha is never
    read.  The kernel reads ``l2g_corrections_on(out_col_spec, device)``,
    built at the first call unless a channel program's ``prepare(device)``
    built it (one more launch, counted there, and a host wait)."""
    fmt = _planar_format(fmt_name, PLANAR422, "planar422_pack")
    _check_rgb(rgb, "planar422_pack")
    if is_cpu(rgb, "planar422_pack"):
        return planar422_pack_plain(rgb, fmt_name, out_col_spec)
    c, h, w = rgb.shape
    dev = rgb.device
    check_arg(rgb, "planar422_pack rgb", dev, torch.float32, (c, h, w))
    info = fmt.INFO
    dtype = _sample_dtype(info)
    p = fmt.pitch(w)
    y = torch.empty((h, p), dtype=dtype, device=dev)
    u = torch.empty((h, p // 2), dtype=dtype, device=dev)
    v = torch.empty((h, p // 2), dtype=dtype, device=dev)
    corr = l2g_corrections_on(out_col_spec, dev)
    with torch.cuda.device(dev):
        rc = library().phn_planar422_pack(
            rgb.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(), w, h, p, p // 2,
            info.num_bits, info.luma_black,
            ctypes.addressof(_encode_coeffs(out_col_spec, fmt_name)), corr.data_ptr(), stream_handle(dev),
        )
    check_launch(rc, "planar422_pack")
    launched(planar422_pack)
    return [y, u, v]


planar422_pack.launches = 0


# -------------------------------------------- B12 planar 4:2:0 unpack


def planar420_unpack_plain(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", fmt_name: str = "yuv420p",
) -> torch.Tensor:
    """Plain version of planar420_unpack."""
    fmt = _planar_format(fmt_name, PLANAR420, "planar420_unpack")
    loader = format_loader(fmt_name, col_spec, out_col_spec, planes[0].device)
    return to_rgba(fmt, list(planes), loader, width, height)


def _chroma_420(fmt_name: str, p: int) -> tuple[int, int]:
    """(chroma plane pitch, interleaved) of a 4:2:0 format."""
    return (p, 1) if fmt_name == "nv12" else (p // 2, 0)


def planar420_unpack(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", fmt_name: str = "yuv420p",
) -> torch.Tensor:
    """8-bit 4:2:0 planes -> linear RGBA (4, H, W) float32, at any height.
    yuv420p: y (H, pitch), u, v ((H+1)/2, pitch/2); nv12: y and one
    interleaved CbCr plane ((H+1)/2, pitch).  Every plane uint8."""
    fmt = _planar_format(fmt_name, PLANAR420, "planar420_unpack")
    if is_cpu(planes[0], "planar420_unpack"):
        return planar420_unpack_plain(planes, width, height, col_spec, out_col_spec, fmt_name)
    p = fmt.pitch(width)
    cp, interleaved = _chroma_420(fmt_name, p)
    h2 = (height + 1) // 2
    if len(planes) != 3 - interleaved:
        raise ValueError(f"planar420_unpack: {fmt_name} has {3 - interleaved} planes")
    dev = planes[0].device
    check_arg(planes[0], "planar420_unpack y", dev, torch.uint8, (height, p), align=1)
    for c in planes[1:]:
        check_arg(c, "planar420_unpack chroma", dev, torch.uint8, (h2, cp), align=1)
    coeffs, g2l = decode_args(fmt_name, col_spec, out_col_spec, dev)
    out = torch.empty((4, height, width), dtype=torch.float32, device=dev)
    c1 = planes[2].data_ptr() if not interleaved else None
    with torch.cuda.device(dev):
        rc = library().phn_planar420_unpack(
            planes[0].data_ptr(), planes[1].data_ptr(), c1, out.data_ptr(),
            width, height, p, cp, interleaved, coeffs, g2l, stream_handle(dev),
        )
    check_launch(rc, "planar420_unpack")
    launched(planar420_unpack)
    return out


planar420_unpack.launches = 0


# ------------------------------------------- rgba8 / bgra8 unpack


def rgb8_unpack_plain(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", fmt_name: str = "rgba8",
    gamma_mode: str = "analytic",
) -> torch.Tensor:
    """Plain version of rgb8_unpack: ops/io.py to_rgba in torch ops."""
    fmt = _planar_format(fmt_name, RGB8, "rgb8_unpack")
    loader = format_loader(fmt_name, col_spec, out_col_spec, planes[0].device, gamma_mode)
    return to_rgba(fmt, list(planes), loader, width, height)


@lru_cache(maxsize=None)
def _gamut_coeffs(col_spec: str, out_col_spec: str) -> ctypes.Array:
    return _c_floats(cm.rgb2rgb_matrix(col_spec, out_col_spec))


@lru_cache(maxsize=None)
def rgb8_unpack_args(
    fmt_name: str, col_spec: str, out_col_spec: str, gamma_mode: str, device: torch.device,
) -> tuple[int, int, int]:
    """(gamut array address, table pointer, R's byte position) of an RGB
    format's decode on ``device``: the table the plain version gathers
    from (g2l_table_on, or the reference LUT under gamma_mode 'lut')."""
    r_byte = _planar_format(fmt_name, RGB8, "rgb8_unpack").CHANNEL_ORDER[0]
    loader = format_loader(fmt_name, col_spec, out_col_spec, device, gamma_mode)
    table = loader.gamma.lut if gamma_mode == "lut" else g2l_table_on(col_spec, device)
    return ctypes.addressof(_gamut_coeffs(col_spec, out_col_spec)), table.data_ptr(), r_byte


def rgb8_unpack(
    planes: Sequence[torch.Tensor], width: int, height: int,
    col_spec: str = "709", out_col_spec: str = "709", fmt_name: str = "rgba8",
    gamma_mode: str = "analytic",
) -> torch.Tensor:
    """One (H, W, 4) uint8 plane of 8-bit RGBA in the format's byte order
    (rgba8 R, G, B, A; bgra8 B, G, R, A) -> linear RGBA (4, H, W) float32:
    each byte through gamma'->linear at index code * 257, alpha too, then
    the 3x3 gamut on R, G and B.  ``gamma_mode`` 'lut' gathers from the
    reference's LUT in place of g2l_table, as the plain version does."""
    _planar_format(fmt_name, RGB8, "rgb8_unpack")
    if len(planes) != 1:
        raise ValueError(f"rgb8_unpack: {fmt_name} has one plane, got {len(planes)}")
    px = planes[0]
    if is_cpu(px, "rgb8_unpack"):
        return rgb8_unpack_plain(planes, width, height, col_spec, out_col_spec, fmt_name, gamma_mode)
    dev = px.device
    check_arg(px, "rgb8_unpack plane", dev, torch.uint8, (height, width, 4))
    gamut, table, r_byte = rgb8_unpack_args(fmt_name, col_spec, out_col_spec, gamma_mode, dev)
    out = torch.empty((4, height, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library().phn_rgb8_unpack(
            px.data_ptr(), out.data_ptr(), width, height, r_byte, gamut, table, stream_handle(dev),
        )
    check_launch(rc, "rgb8_unpack")
    launched(rgb8_unpack)
    return out


rgb8_unpack.launches = 0


# ---------------------------------------------- B13 planar 4:2:0 pack


def planar420_pack_plain(rgb: torch.Tensor, fmt_name: str, out_col_spec: str = "709") -> list:
    """Plain version of planar420_pack."""
    fmt = _planar_format(fmt_name, PLANAR420, "planar420_pack")
    return _planar_codes_plain(fmt, rgb, out_col_spec)


def planar420_pack(rgb: torch.Tensor, fmt_name: str, out_col_spec: str = "709") -> list:
    """Linear RGB(A) (C, H, W) float32, C = 3 or 4 -> 8-bit 4:2:0 planes:
    yuv420p [y, u, v], nv12 [y, CbCr] (the layouts of planar420_unpack).
    Chroma comes from the even pixels of even lines (yuv420p.ts:191-201);
    the pitch pad packs as black luma and null chroma.  Alpha is never
    read.  The kernel reads ``l2g_corrections_on`` as planar422_pack's
    does."""
    fmt = _planar_format(fmt_name, PLANAR420, "planar420_pack")
    _check_rgb(rgb, "planar420_pack")
    if is_cpu(rgb, "planar420_pack"):
        return planar420_pack_plain(rgb, fmt_name, out_col_spec)
    c, h, w = rgb.shape
    dev = rgb.device
    check_arg(rgb, "planar420_pack rgb", dev, torch.float32, (c, h, w))
    info = fmt.INFO
    if info.num_bits != 8:
        raise ValueError(f"planar420_pack: {fmt_name} is not an 8-bit format")
    p = fmt.pitch(w)
    cp, interleaved = _chroma_420(fmt_name, p)
    h2 = (h + 1) // 2
    planes = [torch.empty((h, p), dtype=torch.uint8, device=dev)]
    planes += [torch.empty((h2, cp), dtype=torch.uint8, device=dev) for _ in range(2 - interleaved)]
    c1 = planes[2].data_ptr() if not interleaved else None
    corr = l2g_corrections_on(out_col_spec, dev)
    with torch.cuda.device(dev):
        rc = library().phn_planar420_pack(
            rgb.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(), c1, w, h, p, cp,
            interleaved, info.luma_black,
            ctypes.addressof(_encode_coeffs(out_col_spec, fmt_name)), corr.data_ptr(), stream_handle(dev),
        )
    check_launch(rc, "planar420_pack")
    launched(planar420_pack)
    return planes


planar420_pack.launches = 0


# ------------------------------------------------ B3 fused v210 program


def _check_mix(mix, device: torch.device) -> torch.Tensor:
    mix = torch.as_tensor(mix, dtype=torch.float32, device=device).reshape(1)
    check_arg(mix, "mix", device, torch.float32, (1,))
    return mix


@lru_cache(maxsize=None)
def _g2l_consts(col_spec: str) -> ctypes.Array:
    """inv_max, thr, inv_delta, a1, inv_alpha, inv_gamma: the float32
    constants of ops/gamma.py g2l_table's expressions."""
    p = cm.COLOUR_SPECS[col_spec]
    return _c_floats([INV_LUT_MAX, p.beta * p.delta, 1.0 / p.delta, p.alpha - 1.0, 1.0 / p.alpha, 1.0 / p.gamma])


@lru_cache(maxsize=None)
def fused_v210_corrections_on(col_spec: str, out_col_spec: str, device: torch.device) -> torch.Tensor:
    """The fused v210 kernel's transfer corrections on ``device``: 2 x
    65536 int8, at each table index the difference between the bits of
    the exact value and of the kernel's two-instruction approximation of
    it: first linear->gamma' of out_col_spec (``l2g_corrections_on``'s
    table, copied), then gamma'->linear of col_spec (``g2l_table``, which
    every decode kernel gathers from), computed there by the kernel library
    (csrc/fused_v210.cu phn_fused_v210_corrections).  So the kernel's
    transfers equal K1's and K2's to the bit.  Built once per device and
    pair of col_specs, by one launch (counted in
    ``fused_v210_corrections_on.launches``; the l2g half counts its own)
    and a host wait for its check; raises if a difference does not fit a
    byte.  A channel program's ``prepare(device)`` (graph/pipeline.py)
    calls it before the first frame."""
    corr = torch.empty(2 * 65536, dtype=torch.int8, device=device)
    bad = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        corr[:65536].copy_(l2g_corrections_on(out_col_spec, device))
        rc = library().phn_fused_v210_corrections(
            corr[65536:].data_ptr(), bad.data_ptr(), g2l_table_on(col_spec, device).data_ptr(),
            ctypes.addressof(_g2l_consts(col_spec)), stream_handle(device),
        )
        check_launch(rc, "fused_v210 corrections")
        launched(fused_v210_corrections_on)
        if int(bad.item()):
            raise RuntimeError(f"fused_v210: {int(bad.item())} gamma'->linear corrections of {col_spec} "
                               "do not fit a byte")
    return corr


fused_v210_corrections_on.launches = 0


def fused_v210_plain(
    words: torch.Tensor, width: int, height: int, words_b: torch.Tensor | None = None,
    mix=None, col_spec: str = "709", out_col_spec: str = "709",
) -> torch.Tensor:
    """Plain version of fused_v210: the staged path of the top layer,
    v210_unpack_plain (4 ch) -> mix_frames -> 'over' black -> v210_pack_plain."""
    srcs = v210_unpack_plain(
        [words] + ([words_b] if words_b is not None else []), width, height,
        col_spec, out_col_spec,
    )
    top = srcs[0] if words_b is None else mix_frames(srcs[0], srcs[1], mix)
    return v210_pack_plain(combine([torch.zeros_like(top), top]), out_col_spec)


def fused_v210(
    words: torch.Tensor, width: int, height: int, words_b: torch.Tensor | None = None,
    mix=None, col_spec: str = "709", out_col_spec: str = "709",
) -> torch.Tensor:
    """A channel whose top layer is a v210 clip without DVE, in one launch:
    (H, pitch_bytes/4) int32 words of the clip (and, for a dissolve, of
    the second clip and ``mix``, a 0-d tensor or float) -> the channel's
    v210 output words, decode -> dissolve words*mix + words_b*(1-mix) ->
    'over' black -> encode.  The opaque top layer covers every lower
    layer, so they are not read (JAX ``supported_spec``).

    The kernel reads its transfer corrections from
    ``fused_v210_corrections_on``.  Unless they were built before (a
    channel program's ``prepare(device)``), the first call on a device for
    a pair of col_specs builds them: one more launch, counted in
    ``fused_v210_corrections_on.launches`` and not in
    ``fused_v210.launches``, and a host wait, so that call cannot run
    inside a CUDA-graph capture."""
    if (words_b is None) != (mix is None):
        raise ValueError("fused_v210: words_b and mix go together")
    if is_cpu(words, "fused_v210"):
        return fused_v210_plain(words, width, height, words_b, mix, col_spec, out_col_spec)
    dev = words.device
    groups = v210fmt.pitch(width) // 6
    shape = (height, groups * 4)
    check_arg(words, "fused_v210 words", dev, torch.int32, shape, align=16)
    b_ptr = mix_ptr = None
    if words_b is not None:
        check_arg(words_b, "fused_v210 words_b", dev, torch.int32, shape, align=16)
        mix = _check_mix(mix, dev)
        b_ptr, mix_ptr = words_b.data_ptr(), mix.data_ptr()
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    coeffs, g2l = v210_decode_args(col_spec, out_col_spec, dev)
    with torch.cuda.device(dev):
        rc = library().phn_fused_v210(
            words.data_ptr(), b_ptr, mix_ptr, out.data_ptr(), width, height, groups,
            coeffs, g2l, ctypes.addressof(_encode_coeffs(out_col_spec)),
            ctypes.addressof(_g2l_consts(col_spec)),
            fused_v210_corrections_on(col_spec, out_col_spec, dev).data_ptr(), stream_handle(dev),
        )
    check_launch(rc, "fused_v210")
    launched(fused_v210)
    return out


fused_v210.launches = 0


# --------------------------------------------------- B5 combine + pack


def _check_layers(layers: Sequence) -> tuple[int, int]:
    if not layers:
        raise ValueError("combine_pack: at least one layer")
    first = layers[0][0] if isinstance(layers[0], tuple) else layers[0]
    _, h, w = first.shape
    for f in layers:
        frame = f[0] if isinstance(f, tuple) else f
        c = 3 if isinstance(f, tuple) else 4
        if tuple(frame.shape) != (c, h, w):
            raise ValueError(
                f"combine_pack: a layer is a (4, H, W) frame or an (rgb (3, H, W), wy, wx) "
                f"tuple at {h}x{w}, got {tuple(frame.shape)}"
            )
    return h, w


def combine_pack_plain(layers: Sequence, out_col_spec: str = "709") -> torch.Tensor:
    """Plain version of combine_pack: combine_rgb -> v210_pack_plain."""
    _check_layers(layers)
    return v210_pack_plain(combine_rgb(list(layers)), out_col_spec)


def combine_pack(layers: Sequence, out_col_spec: str = "709") -> torch.Tensor:
    """Layers bottom to top, each a (4, H, W) float32 premultiplied RGBA
    frame or an ``(rgb (3, H, W), wy (H,), wx (W,))`` tuple whose alpha is
    wy[:, None] * wx, 'over' the implicit black base and packed to v210
    words (H, pitch_bytes/4) int32, at most MAX_LAYERS layers a launch.
    The kernel reads ``l2g_corrections_on`` as v210_pack's does."""
    h, w = _check_layers(layers)
    first = layers[0][0] if isinstance(layers[0], tuple) else layers[0]
    if is_cpu(first, "combine_pack"):
        return combine_pack_plain(layers, out_col_spec)
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"combine_pack: at most {MAX_LAYERS} layers per launch")
    dev = first.device
    frames, chans, wys, wxs = [], [], [], []
    for f in layers:
        if isinstance(f, tuple):
            rgb, wy, wx = f
            check_arg(rgb, "combine_pack rgb", dev, torch.float32, (3, h, w))
            check_arg(wy, "combine_pack wy", dev, torch.float32, (h,))
            check_arg(wx, "combine_pack wx", dev, torch.float32, (w,))
            frames.append(rgb.data_ptr())
            chans.append(3)
            wys.append(wy.data_ptr())
            wxs.append(wx.data_ptr())
        else:
            check_arg(f, "combine_pack frame", dev, torch.float32, (4, h, w))
            frames.append(f.data_ptr())
            chans.append(4)
            wys.append(None)
            wxs.append(None)
    n = len(layers)
    ptrs = lambda xs: (ctypes.c_void_p * n)(*xs)
    frame_p, wy_p, wx_p = ptrs(frames), ptrs(wys), ptrs(wxs)
    chan_p = (ctypes.c_int * n)(*chans)
    groups = v210fmt.pitch(w) // 6
    out = torch.empty((h, groups * 4), dtype=torch.int32, device=dev)
    corr = l2g_corrections_on(out_col_spec, dev)
    with torch.cuda.device(dev):
        rc = library().phn_combine_pack(
            ctypes.addressof(frame_p), ctypes.addressof(chan_p), ctypes.addressof(wy_p),
            ctypes.addressof(wx_p), n, out.data_ptr(), w, h, groups,
            ctypes.addressof(_encode_coeffs(out_col_spec)), corr.data_ptr(), stream_handle(dev),
        )
    check_launch(rc, "combine_pack")
    launched(combine_pack)
    return out


combine_pack.launches = 0
