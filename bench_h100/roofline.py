"""The work a channel tick needs, counted from its shapes, and the least
time an H100 could take for it.

Each stage of a tick (a source's unpack, an off-size clip's stretch
fit, a DVE layer's warp, the composite of the layers, the pack into the
output format) is counted as the work it needs: each input byte read
once, each output byte written once, and the float32 operations of its
arithmetic per pixel (one each for add, subtract, multiply, divide, abs,
min, max, floor, rint and powf; compares and selects not counted).  A
warp reads the source texels (v210: 6-pixel groups) that its in-range
taps land on.  The counts do not depend on which kernel, or how many,
implements a stage.

The least time of a stage is the larger of bytes / HBM_BYTES_PER_S and
operations / FP32_FLOPS.  Peaks: NVIDIA's H100 SXM data sheet, 3.35
TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores, at the
card's full 700 W; a card set to a lower power limit runs slower, so a
share is printed beside the card's limit.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

from .reference.formats import INFO, planar_pitch, v210_pitch

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "Stage", "least_s", "tick_stages", "kernel_kind",
           "is_torch_op", "composite_bytes_ops", "unpack_bytes_ops", "pack_bytes_ops"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

OPS_G2L = 4  # gamma'->linear index: scale, rint, max, min (the table read is a load)
OPS_L2G = 8  # linear->gamma': index (scale, rint, max, min), then scale, offset, scale, powf
OPS_DECODE_PX = 3 * 6 + 3 * OPS_G2L + 3 * 5  # 3x4 matrix, transfers, 3x3 gamut
OPS_RGB8_DECODE_PX = 4 + 3 * 5  # the index code * 257 of four channels, 3x3 gamut
OPS_ENCODE_PX = 3 * OPS_L2G + 9 + 9  # transfers, luma row, two chroma rows every other pixel
OPS_WARP_PX = 18  # per output pixel and matrix: ix, iy, px, py, floor and fraction
OPS_WARP_SAMPLE = 12  # per channel and source: three lerps
OPS_MIX = 4  # v * mix + vb * (1 - mix)
OPS_ALPHA = 6  # an opaque layer's separable alpha: wy, wx, 1 - wy * wx
OPS_K = 1  # a layer with its own alpha: 1 - alpha
OPS_OVER = 2  # out * k + v, per channel
OPS_FIT_PX = 2 * 4 * 3  # a stretch fit: two separable lerps of four channels

# kernels of the port's CUDA library by the stage they run (the base
# names of the __global__ functions)
KERNEL_KINDS = {
    "v210_unpack_kernel": "unpack.v210",
    "planar422_unpack_kernel": "unpack.planar422",
    "planar420_unpack_kernel": "unpack.planar420",
    "warp_kernel": "warp",
    "words_kernel": "composite",
    "frames_kernel": "composite",
    "frame_tile_kernel": "composite",
    "pack_kernel": "pack.v210",
    "planar422_pack_kernel": "pack.planar422",
    "planar420_pack_kernel": "pack.planar420",
}
_KERNEL_RE = re.compile(r"\b(" + "|".join(KERNEL_KINDS) + r")\b")


class Stage(NamedTuple):
    kind: str
    nbytes: float
    ops: float

    @property
    def least_s(self) -> float:
        return least_s(self.nbytes, self.ops)


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def kernel_kind(name: str):
    """The stage kind of a device operation of the port's library, or None."""
    m = _KERNEL_RE.search(name)
    return KERNEL_KINDS[m.group(1)] if m else None


def is_torch_op(name: str, cat: str = "kernel") -> bool:
    """A device operation PyTorch launched (its kernels, copies and fills),
    as opposed to one of the program's own kernels."""
    if cat in ("gpu_memcpy", "gpu_memset") or name.startswith(("Memcpy", "Memset")):
        return True
    return "at::" in name or "c10::" in name


def _family(fmt: str) -> str:
    return {"v210": "v210", "yuv422p10le": "planar422", "yuv420p": "planar420", "nv12": "planar420",
            "rgba8": "rgb8"}[fmt]


def _used(scale: float, offset: float, size: int, per: int = 1) -> int:
    x = torch.arange(size, dtype=torch.float32)
    pos = scale * (x / torch.full_like(x, float(size)) - 0.5) + offset + 0.5
    i0 = torch.floor(pos * size - 0.5).to(torch.int64)
    taps = torch.cat([i0, i0 + 1])
    return int((taps[(taps >= 0) & (taps < size)] // per).unique().numel())


def source_texels(mat, height: int, width: int) -> int:
    """Source texels an axis-aligned warp by ``mat`` reads."""
    m = torch.as_tensor(mat, dtype=torch.float32)
    return _used(m[1, 1], m[1, 2], height) * _used(m[0, 0], m[0, 2], width)


def source_groups(mat, height: int, width: int) -> int:
    """v210 6-pixel groups (by rows) an axis-aligned warp by ``mat`` reads."""
    m = torch.as_tensor(mat, dtype=torch.float32)
    return _used(m[1, 1], m[1, 2], height) * _used(m[0, 0], m[0, 2], width, 6)


def _plane_bytes(fmt: str, width: int, height: int) -> float:
    if fmt == "v210":
        return height * v210_pitch(width) * 8 / 3
    if fmt == "rgba8":
        return 4.0 * width * height
    sample = 2 if INFO[fmt].bits > 8 else 1
    chroma_rows = height if fmt == "yuv422p10le" else (height + 1) // 2
    return (height + chroma_rows) * planar_pitch(width) * sample


def unpack_bytes_ops(fmt: str, width: int, height: int) -> tuple:
    """Planes in, a (4, H, W) float32 frame out."""
    per_px = OPS_RGB8_DECODE_PX if fmt == "rgba8" else OPS_DECODE_PX
    return _plane_bytes(fmt, width, height) + 16.0 * width * height, per_px * width * height


def pack_bytes_ops(fmt: str, width: int, height: int, channels: int = 3) -> tuple:
    """A linear RGB frame's channels in, the format's planes out."""
    return 4.0 * channels * width * height + _plane_bytes(fmt, width, height), OPS_ENCODE_PX * width * height


def warp_ops(channels: int, n_src: int, pixels: int) -> float:
    return pixels * (OPS_WARP_PX + channels * (n_src * OPS_WARP_SAMPLE + (OPS_MIX if n_src == 2 else 0)))


def composite_bytes_ops(cfg, mats, width: int, height: int, kind: str, emit: str = "packed") -> tuple:
    """One launch's work over a run of DVE layers (``cfg``: sources per
    layer; ``kind`` 'packed' reads v210 words and decodes them at the
    taps, 'rgba' reads (4, H, W) frames): the sources the taps reach read
    once, the warps, the alphas and the 'over' per pixel, then the encode
    and the words out ('packed') or the (4, H, W) frame ('rgba')."""
    pixels = width * height
    channels = 4 if kind == "rgba" else 3
    nbytes = 36.0 * len(cfg) + 4 * sum(n == 2 for n in cfg)
    ops = 0.0
    if emit == "packed":
        nbytes += height * v210_pitch(width) * 8 / 3
        ops += pixels * OPS_ENCODE_PX
    else:
        nbytes += 16.0 * pixels
    for i, (n, m) in enumerate(zip(cfg, mats)):
        if kind == "packed":
            nbytes += n * 16 * source_groups(m, height, width)
            ops += n * source_texels(m, height, width) * OPS_DECODE_PX
        else:
            nbytes += n * 4 * channels * source_texels(m, height, width)
        ops += warp_ops(channels, n, pixels)
        ops += pixels * ((OPS_K if kind == "rgba" else OPS_ALPHA) + (3 * OPS_OVER if i else 0))
    return nbytes, ops


def tick_stages(layers: list, out_fmt: str, width: int, height: int) -> list:
    """The stages of one channel tick.  ``layers``: bottom to top, each
    {"sources": [(format, width, height)], "matrix": (3, 3) or None}.

    The route is the frame program's: a stack of at least two DVE layers
    of one kind (v210 clips at channel size, decoded at the taps; or
    frames with their own alpha) is one composite, emitting v210 words,
    or a frame that the output format's pack takes; any other stack
    warps each DVE layer on its own, combines and packs."""
    stages = []
    words = [all(f == "v210" and (w, h) == (width, height) for f, w, h in ly["sources"])
             and ly["matrix"] is not None for ly in layers]
    all_dve = all(ly["matrix"] is not None for ly in layers)
    one_kind = all(words) or not any(words)
    whole = len(layers) >= 2 and all_dve and one_kind
    for li, ly in enumerate(layers):
        for fmt, w, h in ly["sources"]:
            if whole and words[li]:
                continue
            nb, ops = unpack_bytes_ops(fmt, w, h)
            stages.append(Stage(f"unpack.{_family(fmt)}", nb, ops))
            if (w, h) != (width, height):
                stages.append(Stage("fit", 16.0 * (w * h + width * height), OPS_FIT_PX * width * height))
    if whole:
        kind = "packed" if all(words) else "rgba"
        emit = "packed" if out_fmt == "v210" else "rgba"
        cfg = [len(ly["sources"]) for ly in layers]
        nb, ops = composite_bytes_ops(cfg, [ly["matrix"] for ly in layers], width, height, kind, emit)
        stages.append(Stage("composite", nb, ops))
        if emit == "rgba":
            stages.append(Stage(f"pack.{_family(out_fmt)}", *pack_bytes_ops(out_fmt, width, height)))
        return stages
    pixels = width * height
    for li, ly in enumerate(layers):
        if ly["matrix"] is None:
            continue
        n = len(ly["sources"])
        nb = n * 16 * source_texels(ly["matrix"], height, width) + 16.0 * pixels + 36 + 4 * (n == 2)
        stages.append(Stage("warp", nb, warp_ops(4, n, pixels)))
    stages.append(Stage("combine", 16.0 * pixels * (len(layers) + 1),
                        pixels * 3 * (1 + OPS_OVER) * (len(layers) - 1)))
    stages.append(Stage(f"pack.{_family(out_fmt)}", *pack_bytes_ops(out_fmt, width, height)))
    return stages
