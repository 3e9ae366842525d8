"""The per-channel frame program (counterpart of
phaneron_tpu/graph/pipeline.py, the staged branch of ``_channel_frame``).

    unpack -> colour -> per-layer DVE warp -> dissolve
           -> N-layer 'over' combine -> colour -> pack

Each stage with a TPU kernel in the JAX package goes through its CUDA
kernel wrapper (ops/kernels.py, ops/warp.py): every v210 source slot of
the frame in one unpack launch, planar 4:2:2 sources through the planar
unpack, DVE layers through the warp (a dissolve with a transform as one
pair launch), and the v210 pack.  The combine is plain tensor code, as
it is plain XLA in the JAX package.  A wrapper given CPU tensors runs
its plain version, so on the CPU the whole program is plain PyTorch.

The JAX package picks its TPU kernels by VMEM and scale-bucket gates
(warp_bucket, warp_fits, batch_unpack_fits, width % 128).  The port keys
only on correctness conditions: source format, transition, transform
(axis-aligned or not) and output format.  On a CUDA device a structure
without a ported kernel raises NotImplementedError naming the ROADMAP
item it waits for; it never runs plain code on the card unasked.
``make_channel_program(spec, plain=True)`` runs every stage's plain
version on the params' device: the reference the kernel path is checked
against on the card.

Specs are hashable NamedTuples with the JAX package's fields, so a JAX
spec converts with ``spec_from_fields(jax_spec._asdict())``
(graph/convert.py).  Params are ``{"layers": [per-layer dicts, bottom to
top]}`` with tensors on one device: "src"/"src_b" plane lists, "matrix"
(3, 3) float32, "mix" a 0-d float32 tensor.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import io as fio
from ..ops import kernels, warp as warp_mod
from ..ops.coeffs import make_saver
from ..ops.composite import combine, mix_frames
from ..ops.formats import FORMATS, get_format
from ..ops.geometry import warp_affine

__all__ = [
    "LayerSpec",
    "ChannelSpec",
    "make_channel_program",
    "missing_kernel",
    "check_structure",
]


class LayerSpec(NamedTuple):
    """Static structure of one layer slot (fields of the JAX LayerSpec)."""

    src_format: str
    transition: str = "none"  # 'none' | 'dissolve' | 'wipe'
    has_transform: bool = False  # run the DVE warp (MIXER ANCHOR/FILL/ROTATION)
    axis_aligned: bool = True  # no-rotation fast path
    mask_format: Optional[str] = None  # wipe mask source format
    src_b_format: Optional[str] = None  # transition target source format
    deinterlace: bool = False  # source is interlaced: inputs carry a ring
    warp_bucket: int = -1  # TPU scale bucket; the port ignores it
    warp_same_mat: bool = True  # dissolve sources share one transform
    rot_bucket: int = -1  # TPU rotation code; the port ignores it
    rot_bucket_b: int = -1
    src_size: Optional[tuple[int, int]] = None  # (w, h) of an off-geometry source
    src_opaque: bool = False  # the deinterlace ring's alpha is the constant 1


class ChannelSpec(NamedTuple):
    """Static structure of one channel's frame program (fields of the JAX
    ChannelSpec)."""

    width: int
    height: int
    out_format: str
    layers: tuple[LayerSpec, ...]
    col_spec: str = "709"
    out_col_spec: str = "709"
    gamma_mode: str = "analytic"
    tff: bool = True
    emit_rgba: bool = False
    pallas_stages: bool = False  # the JAX package's TPU switch; the port ignores it


_V210 = "v210"
_PLANAR422_8 = ("yuv422p", "yuv422p8")
_SOURCE_FORMATS = (_V210,) + _PLANAR422_8


def _slot_formats(ls: LayerSpec) -> list[tuple[str, str]]:
    slots = [("src", ls.src_format)]
    if ls.transition == "dissolve":
        slots.append(("src_b", ls.src_b_format or ls.src_format))
    return slots


def _unported(spec: ChannelSpec) -> Optional[str]:
    """The ROADMAP item a structure waits for when the port has no code
    for it at all (neither kernel nor plain version)."""
    if spec.emit_rgba:
        return "A4 (emit_rgba: the composited RGBA output)"
    for ls in spec.layers:
        if ls.deinterlace:
            return "A6 and B8/B9 (yadif deinterlace)"
        if ls.src_size is not None:
            return "A3 (resize_frame for src_size sources)"
        if ls.transition not in ("none", "dissolve"):
            return f"A3 and B4 wipe mode (transition '{ls.transition}')"
        for _, fmt in _slot_formats(ls):
            if fmt not in _SOURCE_FORMATS:
                return f"A2 and B10-B12 (source format '{fmt}')"
    if spec.out_format not in FORMATS:
        return f"A2 and B11/B13 (output format '{spec.out_format}')"
    return None


def missing_kernel(spec: ChannelSpec) -> Optional[str]:
    """The ROADMAP item a structure waits for when the port runs it only
    through plain code (no CUDA kernel yet), or None when every stage of
    the structure has its kernel."""
    reason = _unported(spec)
    if reason is not None:
        return reason
    if spec.out_format != _V210:
        return f"B11 (pack kernel for output format '{spec.out_format}')"
    for ls in spec.layers:
        if ls.has_transform and not ls.axis_aligned:
            return "B14 (rotation: a non-axis-aligned DVE)"
        if ls.has_transform and ls.transition == "dissolve" and not ls.warp_same_mat:
            return "B4 (dissolve pair with distinct matrices)"
    return None


def check_structure(spec: ChannelSpec, device: torch.device | str) -> None:
    """Raise NotImplementedError for a structure the port cannot run on
    ``device``: on CUDA every stage needs its kernel; on the CPU every
    stage needs a plain version."""
    on_cuda = torch.device(device).type == "cuda"
    reason = missing_kernel(spec) if on_cuda else _unported(spec)
    if reason is not None:
        where = "the GPU" if on_cuda else "PyTorch"
        raise NotImplementedError(
            f"channel structure not ported to {where} yet: ROADMAP.md {reason}"
        )


class _Stages(NamedTuple):
    """The stages that have a kernel: the wrappers or their plain versions."""

    v210_unpack: Callable
    planar422_unpack: Callable
    warp: Callable
    v210_pack: Callable


_KERNELS = _Stages(
    kernels.v210_unpack, kernels.planar422_unpack, warp_mod.warp, kernels.v210_pack
)
_PLAIN = _Stages(
    kernels.v210_unpack_plain, kernels.planar422_unpack_plain, warp_mod.warp_plain,
    kernels.v210_pack_plain,
)


def _params_device(params: dict) -> torch.device:
    if not params["layers"]:
        raise ValueError("channel params hold no layers")
    return params["layers"][0]["src"][0].device


def _unpack_sources(spec: ChannelSpec, params: dict, st: _Stages) -> dict:
    """Unpack every source slot: all v210 slots of the frame in ONE
    unpack call (the JAX package's _batch_unpack_slots), the planar 4:2:2
    slots one by one.  Returns {(layer index, slot key): rgba}."""
    w, h = spec.width, spec.height
    out = {}
    v210_slots = []
    for li, (ls, lp) in enumerate(zip(spec.layers, params["layers"])):
        for key, fmt in _slot_formats(ls):
            if fmt == _V210:
                v210_slots.append((li, key))
            else:
                out[(li, key)] = st.planar422_unpack(
                    lp[key], w, h, spec.col_spec, spec.out_col_spec
                )
    words = [params["layers"][li][key][0] for li, key in v210_slots]
    for slot, rgba in zip(
        v210_slots, st.v210_unpack(words, w, h, spec.col_spec, spec.out_col_spec)
    ):
        out[slot] = rgba
    return out


def _warp_one(ls: LayerSpec, rgba: torch.Tensor, mat, st: _Stages) -> torch.Tensor:
    if ls.axis_aligned:
        return st.warp(rgba, mat)
    return warp_affine(rgba, mat)  # plain only: check_structure keeps it off CUDA


def _process_layer(
    ls: LayerSpec, lp: dict, srcs: dict, li: int, st: _Stages
) -> torch.Tensor:
    rgba = srcs[(li, "src")]
    if ls.transition == "none":
        return _warp_one(ls, rgba, lp["matrix"], st) if ls.has_transform else rgba
    rgba_b = srcs[(li, "src_b")]
    mix = lp["mix"]
    if not ls.has_transform:
        return mix_frames(rgba, rgba_b, mix)
    mat = lp["matrix"]
    if ls.axis_aligned and ls.warp_same_mat:
        # dissolve pair: both sources warped and mixed in one launch
        return st.warp(rgba, mat, rgba_b, mix)
    return mix_frames(
        _warp_one(ls, rgba, mat, st),
        _warp_one(ls, rgba_b, lp.get("matrix_b", mat), st),
        mix,
    )


def _channel_frame(spec: ChannelSpec, params: dict, plain: bool = False) -> list:
    """params -> the packed output planes of one frame."""
    device = _params_device(params)
    check_structure(spec, device)
    st = _PLAIN if plain else _KERNELS
    srcs = _unpack_sources(spec, params, st)
    layers = [
        _process_layer(ls, lp, srcs, li, st)
        for li, (ls, lp) in enumerate(zip(spec.layers, params["layers"]))
    ]
    black = torch.zeros((4, spec.height, spec.width), dtype=torch.float32, device=device)
    composited = combine([black] + layers)
    if spec.out_format == _V210:
        return [st.v210_pack(composited, spec.out_col_spec)]
    out_fmt = get_format(spec.out_format)
    saver = make_saver(out_fmt.INFO, spec.out_col_spec, spec.gamma_mode, device)
    return fio.from_rgba(out_fmt, composited, saver, spec.width, spec.height)


@lru_cache(maxsize=None)
def make_channel_program(spec: ChannelSpec, plain: bool = False):
    """The frame program for a channel structure, cached per spec.
    Returned callable: params -> list of packed output planes, on the
    params' device.  ``plain=True`` runs the plain version of every
    kernel stage instead (the on-card reference)."""

    def program(params: dict) -> list:
        return _channel_frame(spec, params, plain)

    return program
