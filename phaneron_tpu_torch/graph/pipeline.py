"""The per-channel frame program and the stage programs (counterpart of
phaneron_tpu/graph/pipeline.py: ``_channel_frame`` with its kernel
routes, ``make_channel_program``'s selection of the fused v210 program,
and the modular stage programs the runtime and the bench drive).

    unpack [-> resize] | yadif ring | rgba_f32 field -> per-layer DVE warp
           -> dissolve -> N-layer 'over' combine -> colour -> pack

A source whose geometry differs from the channel's (``src_size``: a
720p clip in a 1080p channel; an off-size field or ``rgba_f32`` frame)
unpacks at its own size and is stretch-fit by ``resize_frame`` (torch
ops; XLA in the JAX package, ``_fit_channel``).

Routes, in the order they are chosen:

1. **fused v210** (B3, ``kernels.fused_v210``): a v210 output whose top
   layer is a v210 clip without DVE, as a cut or a dissolve.  It decodes
   opaque, so it covers every lower layer; ``make_channel_program``
   picks this route before it looks at the lower layers (JAX
   ``supported_spec``).  Not for ``emit_rgba``.
2. **packed composite, whole stack** (K5, ``packed_warp.packed_composite``):
   the dispatch plan (``_packed_composite_run``, JAX
   ``_packed_composite_run``) finds the longest contiguous run of at
   least two layers of one kind, each an axis-aligned DVE cut or
   same-matrix dissolve over v210 words decoded at the taps ('packed',
   the progressive multi-layer channel), over opaque (3, H, W) frames
   ('rgb3': deinterlaced fields, ``rgba_f32`` fields) or over (4, H, W)
   frames with their own alpha ('rgba': every other source, the
   file-media multi-box channel; JAX ``_layers_combine_ok``).  When that
   run is the whole stack, one launch makes the frame with the top
   layer's alpha (alpha 'top', JAX ``make_composite_program`` and
   ``make_layers_combine_program``): words into v210 (emit 'packed'),
   words and the frame under ``emit_rgba`` (emit 'both'), or the frame
   (emit 'rgba') that the output format's pack takes.
3. **staged**: each layer on its own, then ``kernels.combine_pack`` (B5)
   'over' black and packs.  A run that spans part of the stack is one
   packed composite launch emitting its RGBA frame with the run's
   coverage alpha (alpha 'coverage'), composited as one layer; the
   layers around it (the stragglers: a rotation, a wipe, a
   distinct-matrix dissolve, another source kind, and an 'rgba' top
   layer, whose own alpha the frame carries) take their own kernels.  A v210 DVE layer (a cut, or a
   dissolve under one shared or two distinct matrices) decodes at its
   warp taps in one ``packed_warp`` launch (B6) and its slots are not
   unpacked; every other v210 slot of the frame (wipe masks included)
   unpacks in one K1 launch, planar 4:2:2 slots (8 or 10 bit) through
   K3, 4:2:0 slots (yuv420p, nv12) through B12, RGB slots (rgba8, bgra8)
   through ``rgb8_unpack``, deinterlaced slots through the yadif ring kernel, other
   axis-aligned DVE layers, their dissolves and wipes through K4, rotated ones through
   ``rotate.rotate`` (B14).  Opaque alpha-free (3, H, W) sources take the
   3-channel route of the JAX package (``(rgb, wy, wx)`` tuples whose
   alpha is the separable warp alpha); other structures pad alpha to 1.
   With ``emit_rgba`` the tail is ``combine`` (torch ops) and K2, and
   the program returns ``{"packed": [...], "rgba": frame}`` whose alpha
   is the top layer's (``_top_alpha_fixup`` where a run holds the top).
   Other outputs take the staged layers, ``combine`` (torch ops) and
   the output format's pack.

The output format's pack (``_pack_frame``): K2 for v210, B11 for planar
4:2:2 (8 or 10 bit), B13 for yuv420p and nv12, torch ops for rgba8 and
bgra8 (whose unpack is ``rgb8_unpack``; their pack has no kernel).

A wrapper given CPU tensors runs its plain version, so on the CPU the
whole program is plain PyTorch.  The JAX package picks its TPU kernels
by VMEM and geometry gates (warp_bucket, warp_fits, packed_warp_fits,
combine_pack_fits, packed_composite_fits, layers_combine_fits, width %
128 or % 768) and flags (``ENABLE_FUSED_COMPOSITE`` and
``ENABLE_LAYERS_COMBINE`` are off there).  The port keys only on
correctness conditions: source format, transition, transform
(axis-aligned or not), ``warp_same_mat``, the channels of each source
and the output format.  So at 1080p the port takes B5, B6 and K5 where
the JAX package on a TPU stays staged; the numbers agree within each
contract.  On a CUDA device
a structure without a ported kernel raises NotImplementedError naming
the ROADMAP item it waits for; it never runs plain code on the card
unasked.  ``plain=True`` on the channel, unpack, pack and pair-deinterlace
programs runs every stage's plain version on the inputs' device: the
reference the kernel path is checked against on the card.

A row-sharded (sp) channel runs the same routes band by band
(parallel/bands.py ``make_sp_channel_program``): ``_channel_frame`` and
the fused program take a ``Band``, output rows [row0, row1) of the frame,
and every stage runs on the rows that band reads (``band_windows``): the
row-local kernels (K1, K3, B12 widened to whole row pairs, K2, B5, B11,
B13, B3) on the band's rows, and K4, B6, K5, B9 and B14 as band forms that
read windows of the rows their taps reach (ops/kernels.py ``Rows``).

Specs are hashable NamedTuples with the JAX package's fields, so a JAX
spec converts with ``spec_from_fields(jax_spec._asdict())``
(graph/convert.py).  Params are ``{"layers": [per-layer dicts, bottom to
top]}`` with tensors on one device: "src"/"src_b"/"mask" plane lists (or
a (C, H, W) float32 frame for ``rgba_f32``), "matrix" (3, 3) float32
(and "matrix_b" for a pair with distinct matrices), "mix" a 0-d float32
tensor; a wipe blends by the R channel of its unpacked "mask"; a
deinterlaced slot carries "<key>_ring", a tuple of three (C, H, W)
frames (prev, cur, next), and "parity", a 0-d int32 tensor or a Python
int.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import io as fio
from ..ops import kernels, packed_warp, rotate as rotate_mod, warp as warp_mod, yadif
from ..ops.composite import combine, combine_rgb, mix_frames, transparent, wipe_mask
from ..ops.formats import get_format
from ..ops.geometry import fit_rows, fit_window, resize_frame
from ..ops.kernels import Rows
from ..runtime.frame import RGBA_F32
from ..utils.metrics import tracer

__all__ = [
    "LayerSpec",
    "ChannelSpec",
    "make_channel_program",
    "missing_kernel",
    "check_structure",
    "make_unpack_program",
    "make_pack_program",
    "make_interlaced_pack_program",
    "make_interlaced_word_pack_program",
    "make_yadif_pair_field_program",
    "make_yadif_program",
    "Band",
    "band_windows",
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


_TRANSITIONS = ("none", "dissolve", "wipe")


def _slot_formats(ls: LayerSpec) -> list[tuple[str, str]]:
    """(key, format) of each source slot of a layer: src, then src_b for a
    dissolve or a wipe, then a wipe's mask."""
    slots = [("src", ls.src_format)]
    if ls.transition in ("dissolve", "wipe"):
        slots.append(("src_b", ls.src_b_format or ls.src_format))
    if ls.transition == "wipe":
        slots.append(("mask", ls.mask_format or ls.src_format))
    return slots


def missing_kernel(spec: ChannelSpec) -> Optional[str]:
    """The ROADMAP item a structure waits for, or None when the port runs
    it: every stage then has its kernel on the card and its plain version
    on the CPU.  A format the registry does not know raises KeyError, as
    ``get_format`` does in the JAX package."""
    for ls in spec.layers:
        if ls.transition not in _TRANSITIONS:
            return f"A4 (transition '{ls.transition}': not one of {_TRANSITIONS})"
        for _, fmt in _slot_formats(ls):
            if fmt != RGBA_F32:
                get_format(fmt)
    get_format(spec.out_format)
    return None


def _v210_clip(ls: LayerSpec) -> bool:
    """A layer of v210 clips at channel geometry, not deinterlaced, as a
    cut or a dissolve: what the kernels that decode v210 words read."""
    return (
        not ls.deinterlace
        and ls.src_size is None
        and ls.transition in ("none", "dissolve")
        and all(fmt == _V210 for _, fmt in _slot_formats(ls))
    )


def _packed_layer_ok(ls: LayerSpec) -> bool:
    """True when a layer runs the packed-source warp (B6): an axis-aligned
    DVE over a v210 clip, a dissolve pair under one shared or two
    distinct matrices (JAX ``_packed_layer_ok`` with its correctness
    conditions only).  Its slots are never unpacked on the staged route."""
    return ls.has_transform and ls.axis_aligned and _v210_clip(ls)


def check_structure(spec: ChannelSpec, device: torch.device | str) -> None:
    """Raise NotImplementedError for a structure the port cannot run on
    ``device`` (``missing_kernel``)."""
    reason = missing_kernel(spec)
    if reason is not None:
        where = "the GPU" if torch.device(device).type == "cuda" else "PyTorch"
        raise NotImplementedError(
            f"channel structure not ported to {where} yet: ROADMAP.md {reason}"
        )


class _Stages(NamedTuple):
    """The stages that have a kernel: the wrappers or their plain versions."""

    v210_unpack: Callable
    planar422_unpack: Callable
    planar420_unpack: Callable
    warp: Callable
    v210_pack: Callable
    planar422_pack: Callable
    planar420_pack: Callable
    yadif_ring: Callable
    yadif_pair: Callable
    packed_composite: Callable
    packed_warp: Callable
    combine_pack: Callable
    rotate: Callable
    rgb8_unpack: Callable


_KERNELS = _Stages(
    kernels.v210_unpack, kernels.planar422_unpack, kernels.planar420_unpack, warp_mod.warp,
    kernels.v210_pack, kernels.planar422_pack, kernels.planar420_pack, yadif.yadif_ring,
    yadif.yadif_pair, packed_warp.packed_composite, packed_warp.packed_warp,
    kernels.combine_pack, rotate_mod.rotate, kernels.rgb8_unpack,
)
_PLAIN = _Stages(
    kernels.v210_unpack_plain, kernels.planar422_unpack_plain, kernels.planar420_unpack_plain,
    warp_mod.warp_plain, kernels.v210_pack_plain, kernels.planar422_pack_plain,
    kernels.planar420_pack_plain, yadif.yadif_ring_plain, yadif.yadif_pair_plain,
    packed_warp.packed_composite_plain, packed_warp.packed_warp_plain,
    kernels.combine_pack_plain, rotate_mod.rotate_plain, kernels.rgb8_unpack_plain,
)


def _params_device(params: dict) -> torch.device:
    if not params["layers"]:
        raise ValueError("channel params hold no layers")
    layer = params["layers"][0]
    for key in ("src", "src_ring"):
        if key in layer:
            value = layer[key]
            return (value if isinstance(value, torch.Tensor) else value[0]).device
    raise ValueError("channel params: layer 0 holds neither 'src' nor 'src_ring'")


class Band(NamedTuple):
    """One band of a row-sharded channel frame: output rows [row0, row1)
    of the ``height``-row frame, computed on ``device``.  ``windows`` maps
    each source slot (layer index, key) to the rows [lo, hi) of its frame
    at channel geometry that the band reads (``band_windows``);
    ``fetch(leaf, lo, hi)`` gives rows [lo, hi) of a plane, frame or ring
    leaf of the params (along its rows axis) on ``device``: a view where
    the band holds them, else copied from the bands that do."""

    row0: int
    row1: int
    height: int
    device: torch.device
    windows: dict
    fetch: Callable

    @property
    def n(self) -> int:
        return self.row1 - self.row0

    def rows(self, src_row0=0) -> Rows:
        return Rows(self.row0, self.row1, self.height, src_row0)


def _warp_rows(mats, bounds, width: int, height: int, rotated: bool = False) -> list:
    """[(lo, hi)] a band of ``bounds`` [(row0, row1)]: the rows the valid
    taps of output rows [row0, row1) reach under any of the host matrices
    (the window of the band as one tile, worked out for every band at
    once: ops/packed_warp.py axis_window, the texel span the axis-aligned
    kernels' windows hold, or for a ``rotated`` layer ops/rotate.py
    affine_window, whose corners bound every tap); one row where no tap
    lands inside the frame.  A matrix whose top two rows are not all
    finite puts every tap off the frame (its texel coordinates are ±inf
    or NaN in x or in y everywhere), so it reaches no row."""
    r0 = torch.tensor([b[0] for b in bounds])
    r1 = torch.tensor([b[1] - 1 for b in bounds])
    window = rotate_mod.affine_window if rotated else packed_warp.axis_window
    lo, hi = [None] * len(bounds), [None] * len(bounds)
    for m in mats:
        m = torch.as_tensor(m, dtype=torch.float32)
        if not bool(torch.isfinite(m[:2]).all()):
            continue
        x0, x1, y0, y1 = (v.tolist() for v in torch.broadcast_tensors(
            *window(m, 0, width - 1, r0, r1, width, height)))
        for k, (a, b) in enumerate(zip(y0, y1)):
            if a <= b and x0[k] <= x1[k]:
                lo[k] = a if lo[k] is None else min(lo[k], a)
                hi[k] = b + 1 if hi[k] is None else max(hi[k], b + 1)
    out = []
    for (row0, _), a, b in zip(bounds, lo, hi):
        a = min(row0, height - 1) if a is None else a
        out.append((a, a + 1 if b is None else b))
    return out


def band_windows(spec: ChannelSpec, mats: list, bounds) -> list:
    """One {(layer index, slot key): (lo, hi)} a band of ``bounds``
    [(row0, row1)]: the rows of each source slot's frame at channel
    geometry that the band's output rows read.  A layer without DVE and a
    wipe's mask read their own rows; a DVE layer the rows its matrices'
    taps reach (``mats[li]``: host copies of the layer's "matrix" and, for
    a pair under two matrices, "matrix_b"; a rotated pair reads matrix_b
    whenever it is given, as ``_process_layer`` does), one window for both
    sources of a pair.  Under a rotation near 90 degrees a band's window
    spans most of the source frame."""
    out = [{} for _ in bounds]
    for li, ls in enumerate(spec.layers):
        wins = list(bounds)
        if ls.has_transform:
            m = mats[li]
            ms = [m["matrix"]]
            two = not ls.axis_aligned or not ls.warp_same_mat
            if two and ls.transition in ("dissolve", "wipe") and m.get("matrix_b") is not None:
                ms.append(m["matrix_b"])
            wins = _warp_rows(ms, bounds, spec.width, spec.height, rotated=not ls.axis_aligned)
        for k, win in enumerate(wins):
            for key, _ in _slot_formats(ls):
                out[k][(li, key)] = tuple(bounds[k]) if key == "mask" else win
    return out


def _fit_channel(frame: torch.Tensor, spec: ChannelSpec) -> torch.Tensor:
    """Stretch-fit an unpacked frame whose geometry differs from the
    channel's (JAX ``_fit_channel``)."""
    if tuple(frame.shape[-2:]) != (spec.height, spec.width):
        return resize_frame(frame, spec.height, spec.width)
    return frame


def _unpack_planes(
    st: _Stages, fmt_name: str, planes, width: int, height: int, col_spec: str,
    out_col_spec: str, gamma_mode: str = "analytic",
) -> torch.Tensor:
    """The planes of one non-v210 source -> linear RGBA (4, H, W): K3 for
    planar 4:2:2 (8 or 10 bit), B12 for 4:2:0, rgb8_unpack for the RGB
    formats (JAX ``_unpack``)."""
    if fmt_name in kernels.PLANAR422:
        return st.planar422_unpack(planes, width, height, col_spec, out_col_spec, fmt_name)
    if fmt_name in kernels.PLANAR420:
        return st.planar420_unpack(planes, width, height, col_spec, out_col_spec, fmt_name)
    return st.rgb8_unpack(planes, width, height, col_spec, out_col_spec, fmt_name, gamma_mode)


def _pack_frame(
    st: _Stages, fmt_name: str, rgb: torch.Tensor, out_col_spec: str,
    gamma_mode: str = "analytic",
) -> list:
    """A linear RGB(A) frame -> the output format's planes: K2 for v210,
    B11 for planar 4:2:2, B13 for 4:2:0, torch ops for the RGB formats."""
    if fmt_name == _V210:
        return [st.v210_pack(rgb, out_col_spec)]
    if fmt_name in kernels.PLANAR422:
        return st.planar422_pack(rgb, fmt_name, out_col_spec)
    if fmt_name in kernels.PLANAR420:
        return st.planar420_pack(rgb, fmt_name, out_col_spec)
    _, h, w = rgb.shape
    saver = kernels.format_saver(fmt_name, out_col_spec, rgb.device, gamma_mode)
    return fio.from_rgba(get_format(fmt_name), rgb, saver, w, h)


def _sources(
    spec: ChannelSpec, params: dict, st: _Stages, skip: frozenset = frozenset(),
    band: Optional[Band] = None,
) -> dict:
    """Every source slot of the frame -> {(layer index, slot key): frame}
    at channel geometry.  A deinterlaced slot runs yadif over its ring at
    the params' parity, an ``rgba_f32`` slot passes its frame through, the
    v210 slots of one size (wipe masks too) unpack in ONE call (the JAX
    package's _batch_unpack_slots at channel size) and every other slot
    on its own by its format (``_unpack_planes``, JAX ``_layer_source``).
    A layer's ``src_size`` is the size its src and src_b planes unpack at
    (a wipe mask unpacks at channel size, as in JAX); every frame not at
    channel geometry is then stretch-fit (``_fit_channel``).  The slots
    of the layers in ``skip`` are left raw: the packed warp or the packed
    composite decodes them.  With a ``band`` each slot's frame holds the
    rows ``band.windows`` gives (``_band_sources``)."""
    if band is not None:
        return _band_sources(spec, params, st, skip, band)
    out = {}
    v210_slots: dict[tuple[int, int], list] = {}  # (w, h) -> slots
    for li, (ls, lp) in enumerate(zip(spec.layers, params["layers"])):
        if li in skip:
            continue
        own = tuple(ls.src_size or (spec.width, spec.height))
        for key, fmt in _slot_formats(ls):
            ring = lp.get(f"{key}_ring") if ls.deinterlace else None
            size = (spec.width, spec.height) if key == "mask" else own
            if ring is not None:
                opaque = ls.src_opaque and ring[0].shape[0] == 4
                out[(li, key)] = st.yadif_ring(ring[0], ring[1], ring[2], lp["parity"], spec.tff,
                                               opaque=opaque)
            elif fmt == RGBA_F32:
                out[(li, key)] = lp[key]
            elif fmt == _V210:
                v210_slots.setdefault(size, []).append((li, key))
            else:
                out[(li, key)] = _unpack_planes(
                    st, fmt, lp[key], *size, spec.col_spec, spec.out_col_spec, spec.gamma_mode
                )
    for (w, h), slots in v210_slots.items():
        words = [params["layers"][li][key][0] for li, key in slots]
        out.update(zip(slots, st.v210_unpack(words, w, h, spec.col_spec, spec.out_col_spec)))
    return {slot: _fit_channel(frame, spec) for slot, frame in out.items()}


def _plane_rows(st: _Stages, fmt_name: str, planes, lo: int, hi: int, width: int, height: int,
                spec: ChannelSpec, band: Band) -> torch.Tensor:
    """Rows [lo, hi) of a non-v210 source, unpacked from the rows of its
    planes (the unpacks are row-local): a 4:2:0 source unpacks whole row
    pairs, its band widened to even rows, then cropped."""
    a, b = lo, hi
    sub = [1] * len(planes)
    if fmt_name in kernels.PLANAR420:
        a, b = lo - lo % 2, min(hi + hi % 2, height)
        sub = [1] + [2] * (len(planes) - 1)
    rows = [band.fetch(p, a // k, -(-b // k)) for p, k in zip(planes, sub)]
    frame = _unpack_planes(st, fmt_name, rows, width, b - a, spec.col_spec, spec.out_col_spec,
                           spec.gamma_mode)
    return frame if (a, b) == (lo, hi) else frame[:, lo - a:hi - a].contiguous()


def _band_sources(spec: ChannelSpec, params: dict, st: _Stages, skip: frozenset, band: Band) -> dict:
    """``_sources`` for one band: each slot's frame at channel geometry,
    rows ``band.windows[slot]`` of it.  A source at its own geometry
    makes the rows the stretch fit reads (``fit_window``) and fits them
    (``fit_rows``); a deinterlaced slot runs the yadif ring's band form
    over the ring rows those rows read (``yadif.ring_window``); v210 slots
    whose windows have as many rows unpack in one K1 launch."""
    out, fits = {}, {}
    v210_slots: dict[tuple[int, int], list] = {}  # (w, rows) -> [(slot, words)]
    for li, (ls, lp) in enumerate(zip(spec.layers, params["layers"])):
        if li in skip:
            continue
        own = tuple(ls.src_size or (spec.width, spec.height))
        for key, fmt in _slot_formats(ls):
            slot, (lo, hi) = (li, key), band.windows[(li, key)]
            ring = lp.get(f"{key}_ring") if ls.deinterlace else None
            frame = ring[0] if ring is not None else lp[key] if fmt == RGBA_F32 else None
            if frame is not None:
                sw, sh = frame.shape[-1], frame.shape[-2]
            else:
                sw, sh = (spec.width, spec.height) if key == "mask" else own
            fit = (sw, sh) != (spec.width, spec.height)
            a, b = fit_window(spec.height, sh, lo, hi) if fit else (lo, hi)
            if fit:
                fits[slot] = (a, sh)
            if ring is not None:
                ra, rb = yadif.ring_window(a, b, sh)
                opaque = ls.src_opaque and ring[0].shape[0] == 4
                out[slot] = st.yadif_ring(*(band.fetch(f, ra, rb) for f in ring), lp["parity"], spec.tff,
                                          opaque=opaque, rows=Rows(a, b, sh, ra))
            elif fmt == RGBA_F32:
                got = band.fetch(frame, a, b)
                # a layer without DVE hands its frame to the combine, which reads it whole
                out[slot] = got if ls.has_transform else got.contiguous()
            elif fmt == _V210:
                v210_slots.setdefault((sw, b - a), []).append((slot, band.fetch(lp[key][0], a, b)))
            else:
                out[slot] = _plane_rows(st, fmt, lp[key], a, b, sw, sh, spec, band)
    for (w, n), items in v210_slots.items():
        frames = st.v210_unpack([words for _, words in items], w, n, spec.col_spec, spec.out_col_spec)
        out.update(zip((slot for slot, _ in items), frames))
    for slot, (a, sh) in fits.items():
        lo, hi = band.windows[slot]
        out[slot] = fit_rows(out[slot], a, sh, spec.height, spec.width, lo, hi)
    return out


def _with_alpha_one(rgb3: torch.Tensor) -> torch.Tensor:
    """(3, H, W) -> (4, H, W) with alpha == 1: the route for layer
    structures whose warped alpha is not separable."""
    return torch.cat([rgb3, torch.ones_like(rgb3[:1])])


def _words(lp: dict, li: int, key: str, band: Optional[Band]) -> torch.Tensor:
    """A v210 slot's words (a band's: the rows of its window)."""
    return lp[key][0] if band is None else band.fetch(lp[key][0], *band.windows[(li, key)])


def _band_kw(band: Optional[Band], li: int) -> dict:
    """The band-form argument of layer li's DVE kernel: {} for a full
    frame, else ``rows`` from its sources' window."""
    return {} if band is None else dict(rows=band.rows(band.windows[(li, "src")][0]))


def _process_layer_rgb3(
    ls: LayerSpec, lp: dict, srcs: dict, li: int, spec: ChannelSpec, st: _Stages,
    band: Optional[Band] = None,
) -> Optional[tuple]:
    """3-channel route for an opaque alpha-free source (JAX
    ``_process_layer_rgb3``): warp RGB only and carry the separable warp
    alpha as (wy, wx) vectors.  Returns (rgb (3,H,W), wy (H,), wx (W,)),
    or None when the structure needs a real alpha plane (a band's rows
    with a ``band``)."""
    h, w = spec.height, spec.width
    rgb = srcs[(li, "src")]
    if not ls.has_transform:
        if ls.transition != "none":
            return None
        ones = lambda n: torch.ones((n,), dtype=torch.float32, device=rgb.device)
        return (rgb, ones(h if band is None else band.n), ones(w))
    if ls.transition not in ("none", "dissolve") or not ls.axis_aligned:
        return None  # a wipe or a rotation: alpha is not separable
    if ls.transition == "dissolve" and not ls.warp_same_mat:
        return None  # the mix of two warps: a sum of two outer products
    mat, kw = lp["matrix"], _band_kw(band, li)
    wy, wx = warp_mod.warp_alpha_vectors(h, w, mat, kw.get("rows"))
    if ls.transition == "dissolve":
        rgb_b = srcs[(li, "src_b")]
        if rgb_b.shape[0] == 4:
            rgb_b = rgb_b[:3]  # opaque contract: alpha == 1
        return (st.warp(rgb, mat, rgb_b, lp["mix"], **kw), wy, wx)
    return (st.warp(rgb, mat, **kw), wy, wx)


def _slot_kind(ls: LayerSpec, lp: dict, key: str, fmt: str) -> str:
    """What a slot gives ``_sources`` (at channel geometry, resized where
    off-size): 'rgb3' an opaque (3, H, W) frame (a 3-channel deinterlace
    ring, an ``rgba_f32`` field), 'rgba' a (4, H, W) frame (every format
    unpacks to RGBA; a 4-channel ring or field)."""
    ring = lp.get(f"{key}_ring") if ls.deinterlace else None
    frame = ring[0] if ring is not None else lp[key] if fmt == RGBA_F32 else None
    return "rgb3" if frame is not None and frame.shape[0] == 3 else "rgba"


def _composite_kind(ls: LayerSpec, lp: dict) -> Optional[str]:
    """A layer's source kind for the packed composite: an axis-aligned DVE
    cut or same-matrix dissolve over v210 words at channel geometry
    ('packed', decoded at the taps; JAX ``_packed_composite_layer_kind``),
    or whose slots all give one kind of frame (``_slot_kind``: 'rgb3', JAX
    ``_packed_composite_layer_kind``; 'rgba', JAX ``_layers_combine_ok``);
    else None."""
    if not (ls.has_transform and ls.axis_aligned):
        return None
    if ls.transition not in ("none", "dissolve"):
        return None
    if ls.transition == "dissolve" and not ls.warp_same_mat:
        return None
    if _packed_layer_ok(ls):
        return "packed"
    kinds = {_slot_kind(ls, lp, key, fmt) for key, fmt in _slot_formats(ls)}
    return kinds.pop() if len(kinds) == 1 else None


class _Run(NamedTuple):
    """The packed composite's dispatch plan: layers [start, end), what the
    launch emits ('packed', 'both' or 'rgba'), the source kind, and the
    frame's alpha: 'top' for a run that is the whole stack, else the
    run's 'coverage'."""

    start: int
    end: int
    emit: str
    kind: str
    alpha: str


def _packed_composite_run(spec: ChannelSpec, params: dict) -> Optional[_Run]:
    """The longest contiguous run of at least two layers of one composite
    kind (``_composite_kind``; a tie keeps the lowest run), or None (JAX
    ``_packed_composite_run`` with its correctness conditions only; the
    'rgba' kind is JAX's ``_layers_combine_ok``, which takes whole stacks
    only).  A run that is the whole stack has the top layer's alpha and
    emits 'packed' into v210 ('both' under ``emit_rgba``), 'rgba' into any
    other format.  Any other run emits 'rgba' with the run's coverage
    alpha, which the 'over' onto the layers around it needs, and those
    layers stay staged.  An 'rgba' top layer over a stack that is not all
    'rgba' stays staged as well: the frame's alpha is then its own warped
    alpha plane, which only its own warp gives (``_top_alpha_fixup``
    gives the separable alpha of an opaque layer).  A run longer than the
    kernel's MAX_LAYERS stays staged too."""
    kinds = [_composite_kind(ls, lp) for ls, lp in zip(spec.layers, params["layers"])]
    if kinds and kinds[-1] == "rgba" and any(k != "rgba" for k in kinds):
        kinds[-1] = None
    best = None
    i, n = 0, len(kinds)
    while i < n:
        if kinds[i] is None:
            i += 1
            continue
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        if best is None or j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    if best is None or not 2 <= best[1] - best[0] <= packed_warp.MAX_LAYERS:
        return None
    start, end = best
    if (start, end) != (0, n):
        return _Run(start, end, "rgba", kinds[start], "coverage")
    if spec.out_format == _V210:
        return _Run(start, end, "both" if spec.emit_rgba else "packed", kinds[start], "top")
    return _Run(start, end, "rgba", kinds[start], "top")


def _packed_composite_args(spec: ChannelSpec, params: dict, srcs: dict, run: _Run,
                           band: Optional[Band] = None) -> tuple:
    """(srcs, layer_cfg, mats, mixes) of the run's packed composite launch
    (JAX ``_dispatch_packed_composite``): the sources are the layers' v210
    words for the 'packed' kind (a band's: the window rows of them) and
    their frames in ``srcs`` for 'rgb3' and 'rgba'."""
    flat, cfg, mats, mixes = [], [], [], []
    for li in range(run.start, run.end):
        ls, lp = spec.layers[li], params["layers"][li]
        keys = [key for key, _ in _slot_formats(ls)]
        flat += [_words(lp, li, key, band) if run.kind == "packed" else srcs[(li, key)] for key in keys]
        cfg.append(len(keys))
        mats.append(lp["matrix"])
        mixes.append(lp["mix"] if len(keys) == 2 else None)
    return flat, tuple(cfg), mats, mixes


def _dispatch_packed_composite(
    spec: ChannelSpec, params: dict, srcs: dict, run: _Run, st: _Stages,
    band: Optional[Band] = None,
):
    """One packed composite launch over the run, emitting ``run.emit``
    with ``run.alpha`` (a band's rows, each source from its window's first
    row, with a ``band``)."""
    kw = {}
    if band is not None:
        kw["rows"] = band.rows(tuple(band.windows[(li, key)][0] for li in range(run.start, run.end)
                                     for key, _ in _slot_formats(spec.layers[li])))
    return st.packed_composite(
        *_packed_composite_args(spec, params, srcs, run, band), spec.out_col_spec,
        src_kind=run.kind, size=(spec.width, spec.height), col_spec=spec.col_spec,
        emit=run.emit, alpha=run.alpha, **kw,
    )


def _top_alpha_fixup(rgba: torch.Tensor, spec: ChannelSpec, params: dict, top: int,
                     band: Optional[Band] = None) -> torch.Tensor:
    """The emitted frame's alpha is the top layer's (combine.ts:47-59): when
    the packed composite run holds the stack top, its coverage alpha is
    replaced by that layer's separable warp alpha wy x wx (JAX
    ``_top_alpha_fixup``; exact for an axis-aligned warp of the constant-1
    plane, so for the opaque 'rgb3' and 'packed' kinds only).  A run that
    is the whole stack emits the top alpha itself; this serves a run that
    holds the top over staged layers."""
    wy, wx = warp_mod.warp_alpha_vectors(spec.height, spec.width, params["layers"][top]["matrix"],
                                         None if band is None else band.rows())
    ch = torch.arange(4, device=rgba.device)[:, None, None]
    return torch.where(ch == 3, (wy[:, None] * wx[None, :])[None], rgba)


def _packed_warp_layer(ls: LayerSpec, lp: dict, li: int, spec: ChannelSpec, st: _Stages,
                      band: Optional[Band] = None):
    """A B6 layer (``_packed_layer_ok``): decode at the warp taps straight
    from its words (JAX ``_process_layer``'s packed branch); with a
    ``band``, from the window rows of its words."""
    kw = dict(col_spec=spec.col_spec, out_col_spec=spec.out_col_spec, **_band_kw(band, li))
    src = _words(lp, li, "src", band)
    mat = lp["matrix"]
    if ls.transition == "none":
        return st.packed_warp(src, mat, spec.width, spec.height, **kw)
    mat_b = None if ls.warp_same_mat else lp.get("matrix_b", mat)
    return st.packed_warp(
        src, mat, spec.width, spec.height, _words(lp, li, "src_b", band), lp["mix"], mat_b, **kw
    )


def _process_layer(
    ls: LayerSpec, lp: dict, srcs: dict, li: int, spec: ChannelSpec, st: _Stages,
    band: Optional[Band] = None,
):
    """One layer -> a (4, H, W) RGBA frame or an (rgb, wy, wx) tuple.  A
    DVE layer runs K4 when axis-aligned and ``rotate`` (B14) when not, a
    dissolve or wipe pair in the same launch; without DVE a dissolve is
    ``mix_frames`` and a wipe ``wipe_mask`` (torch ops; XLA in JAX).  With
    a ``band``, its rows (K4, B6 and B14 as band forms)."""
    if _packed_layer_ok(ls):
        return _packed_warp_layer(ls, lp, li, spec, st, band)
    rgba = srcs[(li, "src")]
    if rgba.shape[0] == 3:
        out3 = _process_layer_rgb3(ls, lp, srcs, li, spec, st, band)
        if out3 is not None:
            return out3
        rgba = _with_alpha_one(rgba)
    dve = st.warp if ls.axis_aligned else st.rotate
    mat, kw = lp.get("matrix"), _band_kw(band, li)
    if ls.transition == "none":
        return dve(rgba, mat, **kw) if ls.has_transform else rgba
    rgba_b = srcs[(li, "src_b")]
    if rgba_b.shape[0] == 3:
        rgba_b = _with_alpha_one(rgba_b)
    mask = srcs[(li, "mask")] if ls.transition == "wipe" else None
    if not ls.has_transform:
        return mix_frames(rgba, rgba_b, lp["mix"]) if mask is None else wipe_mask(rgba, rgba_b, mask)
    # src_b's own matrix: a distinct-matrix pair, and any rotated pair
    # (JAX reads matrix_b for every pair it does not run as one shared
    # matrix; pipeline.py:409-476)
    mat_b = None if ls.axis_aligned and ls.warp_same_mat else lp.get("matrix_b", mat)
    if mask is None:
        return dve(rgba, mat, rgba_b, lp["mix"], mat_b, **kw)
    return dve(rgba, mat, rgba_b, mat_b=mat_b, mask=mask[0], **kw)


def _rgba_of(layer) -> torch.Tensor:
    """A layer as a (4, H, W) frame: an (rgb, wy, wx) tuple gets its
    separable alpha as a plane (JAX pipeline.py:886-898)."""
    if not isinstance(layer, tuple):
        return layer
    rgb, wy, wx = layer
    return torch.cat([rgb, (wy[:, None] * wx[None, :])[None]])


def _channel_frame(spec: ChannelSpec, params: dict, plain: bool = False,
                   band: Optional[Band] = None):
    """params -> the packed output planes of one frame, or under
    ``emit_rgba`` {"packed": planes, "rgba": the composited (4, H, W)
    frame} (routes 2 and 3 of the module docstring).  With a ``band``, its
    rows of them: its params hold their replicated leaves on the band's
    device and their planes, frames and rings as leaves ``band.fetch``
    reads."""
    device = _params_device(params) if band is None else band.device
    check_structure(spec, device)
    st = _PLAIN if plain else _KERNELS
    run = _packed_composite_run(spec, params)
    # B6 layers (a 'packed' run's among them) read their words raw; an
    # rgb3 run's slots (rgba_f32 fields, yadif rings) are made here
    b6 = frozenset(li for li, ls in enumerate(spec.layers) if _packed_layer_ok(ls))
    with tracer.span("program.sources"):
        srcs = _sources(spec, params, st, skip=b6, band=band)
    height = spec.height if band is None else band.n
    if _whole_stack(run):  # the whole stack in one launch
        with tracer.span("program.layers"):
            out = _dispatch_packed_composite(spec, params, srcs, run, st, band)
        if run.emit == "packed":
            return [out]
        if run.emit == "both":
            return {"packed": [out[0]], "rgba": out[1]}
        with tracer.span("program.pack"):
            packed = _pack_frame(st, spec.out_format, out, spec.out_col_spec, spec.gamma_mode)
        return {"packed": packed, "rgba": out} if spec.emit_rgba else packed
    layers = []
    with tracer.span("program.layers"):
        for li, (ls, lp) in enumerate(zip(spec.layers, params["layers"])):
            if run is not None and run.start <= li < run.end:
                if li == run.start:  # the run as one layer: RGB and coverage alpha
                    layers.append(_dispatch_packed_composite(spec, params, srcs, run, st, band))
                continue
            layers.append(_process_layer(ls, lp, srcs, li, spec, st, band))
    if spec.out_format == _V210 and not spec.emit_rgba:
        if len(layers) <= kernels.MAX_LAYERS:
            with tracer.span("program.pack"):  # B5 combines as it packs
                return [st.combine_pack(layers, spec.out_col_spec)]
        with tracer.span("program.combine"):
            rgb = combine_rgb(layers)
        with tracer.span("program.pack"):
            return [st.v210_pack(rgb, spec.out_col_spec)]
    with tracer.span("program.combine"):
        if spec.emit_rgba:
            layers = [_rgba_of(f) for f in layers]
        if any(isinstance(f, tuple) for f in layers):
            composited = _with_alpha_one(combine_rgb(layers))
        else:
            composited = combine([transparent(height, spec.width, device)] + layers)
            if run is not None and run.end == len(spec.layers):
                # the run holds the stack top: its coverage alpha drove the
                # 'over'; the emitted alpha is the top layer's
                composited = _top_alpha_fixup(composited, spec, params, run.end - 1, band)
    with tracer.span("program.pack"):
        packed = _pack_frame(st, spec.out_format, composited, spec.out_col_spec, spec.gamma_mode)
    return {"packed": packed, "rgba": composited} if spec.emit_rgba else packed


def _whole_stack(run: Optional[_Run]) -> bool:
    """The packed composite run is the whole stack: one launch (route 2)."""
    return run is not None and run.alpha == "top"


def _fused_v210_ok(spec: ChannelSpec) -> bool:
    """The fused v210 program covers the structure (JAX
    ``supported_spec``): a v210 output and a top layer that is a v210
    clip, not deinterlaced, without DVE, as a cut or a dissolve from a
    v210 clip.  It decodes opaque, so the lower layers never show."""
    if spec.out_format != _V210 or spec.emit_rgba or not spec.layers:
        return False
    return not spec.layers[-1].has_transform and _v210_clip(spec.layers[-1])


def _fused_v210_program(spec: ChannelSpec, plain: bool):
    """The channel as one fused v210 launch (JAX ``_monolithic_program``)."""
    fused = kernels.fused_v210_plain if plain else kernels.fused_v210
    kw = dict(col_spec=spec.col_spec, out_col_spec=spec.out_col_spec)
    dissolve = spec.layers[-1].transition == "dissolve"

    def program(params: dict, band: Optional[Band] = None) -> list:
        top = params["layers"][-1]
        # words to words, row by row: a band's rows of the words give its rows
        words = lambda key: top[key][0] if band is None else band.fetch(top[key][0], band.row0, band.row1)
        h = spec.height if band is None else band.n
        if dissolve:
            return [fused(words("src"), spec.width, h, words("src_b"), top["mix"], **kw)]
        return [fused(words("src"), spec.width, h, **kw)]

    def prepare(device) -> None:
        device = torch.device(device)
        if not plain and device.type == "cuda":
            kernels.fused_v210_corrections_on(spec.col_spec, spec.out_col_spec, device)

    program.prepare = prepare
    program.staged = lambda params: False
    return program


@lru_cache(maxsize=None)
def make_channel_program(spec: ChannelSpec, plain: bool = False):
    """The frame program for a channel structure, cached per spec.
    Returned callable: params -> list of packed output planes, on the
    params' device (under ``emit_rgba``: {"packed": planes, "rgba": the
    composited (4, H, W) frame, alpha the top layer's}).  A structure the
    fused v210 program covers gets it
    (route 1), whatever its lower layers; every other structure is
    checked (``check_structure``) and runs ``_channel_frame``.
    ``plain=True`` runs the plain version of every kernel stage instead
    (the on-card reference).  ``program(params, band)`` computes one
    band's rows (``Band``; parallel/bands.py).  ``program.prepare(device)`` does the
    one-time device work of the structure before its first frame (the
    fused v210 kernel's transfer corrections; the l2g corrections that the
    output's pack reads: K2 or B5 into v210, whose use the frame's sources
    decide, B11 or B13 into a planar format; the gamma'->linear table an
    RGB source's rgb8_unpack reads), so that no frame hides a launch, an
    upload or a host wait; frames run without it too.
    ``program.staged(params)`` is True where these params take the staged
    route (route 3, graph/replay.py captures only it).  Each program made
    (a cache miss) counts one ``program.structures`` on the tracer."""
    tracer.count("program.structures")
    if _fused_v210_ok(spec):
        return _fused_v210_program(spec, plain)

    def program(params: dict, band: Optional[Band] = None) -> list:
        return _channel_frame(spec, params, plain, band)

    encoded_out = spec.out_format in (_V210,) + kernels.PLANAR422 + kernels.PLANAR420
    rgb_formats = {fmt for ls in spec.layers for _, fmt in _slot_formats(ls) if fmt in kernels.RGB8}

    def prepare(device) -> None:
        device = torch.device(device)
        if plain or device.type != "cuda":
            return
        if encoded_out:
            kernels.l2g_corrections_on(spec.out_col_spec, device)
        for fmt in rgb_formats:
            kernels.rgb8_unpack_args(fmt, spec.col_spec, spec.out_col_spec, spec.gamma_mode, device)

    program.prepare = prepare
    program.staged = lambda params: not _whole_stack(_packed_composite_run(spec, params))
    return program


# ------------------------- modular stage programs (runtime pipelines) --
#
# Cached plain Python callables, one per static configuration; each runs
# on the device of its inputs.  The JAX package jits them; PyTorch runs
# eagerly.


def _analytic_only(gamma_mode: str) -> None:
    if gamma_mode != "analytic":
        raise ValueError(
            f"gamma_mode '{gamma_mode}': the port's unpack and pack kernels compute the "
            "analytic transfer"
        )


@lru_cache(maxsize=None)
def make_unpack_program(
    fmt_name: str, width: int, height: int, col_spec: str, out_col_spec: str,
    gamma_mode: str = "analytic", channels: int = 4, plain: bool = False,
):
    """Producer-side ToRGBA as its own stage (io.ts:26-114): planes ->
    linear (channels, H, W) float32.  ``channels=3`` emits alpha-free
    frames for opaque wire formats (alpha would be the constant 1), the
    frames of the 3-channel deinterlace ring.  v210 goes through K1; every
    other format through ``_unpack_planes`` (K3, B12 or rgb8_unpack),
    sliced to 3 channels where asked (as the JAX package's off-route path
    does)."""
    _analytic_only(gamma_mode)
    if channels not in (3, 4):
        raise ValueError(f"make_unpack_program: channels must be 3 or 4, got {channels}")
    get_format(fmt_name)
    st = _PLAIN if plain else _KERNELS

    def program(planes):
        if fmt_name == _V210:
            return st.v210_unpack(
                [planes[0]], width, height, col_spec, out_col_spec, channels
            )[0]
        return _unpack_planes(st, fmt_name, planes, width, height, col_spec, out_col_spec)[
            :channels
        ]

    return program


@lru_cache(maxsize=None)
def make_pack_program(
    fmt_name: str, width: int, height: int, col_spec: str, gamma_mode: str = "analytic",
    plain: bool = False,
):
    """Consumer-side FromRGBA as its own stage (io.ts:116-179): a linear
    RGB(A) (C, H, W) frame -> the packed planes (``_pack_frame``: K2, B11,
    B13 or torch ops)."""
    _analytic_only(gamma_mode)
    get_format(fmt_name)
    st = _PLAIN if plain else _KERNELS

    def program(rgba):
        if tuple(rgba.shape[-2:]) != (height, width):
            raise ValueError(f"pack program: frame {tuple(rgba.shape)} is not {height}x{width}")
        return _pack_frame(st, fmt_name, rgba, col_spec)

    return program


@lru_cache(maxsize=None)
def make_interlaced_pack_program(
    fmt_name: str, width: int, height: int, col_spec: str, gamma_mode: str = "analytic",
    plain: bool = False,
):
    """Pack two field-rate frames into one interlaced packed frame: even
    lines from the top-field frame, odd from the bottom, the functional
    form of the reference consumer's two write passes
    (macadamConsumer.ts:224-244, v210.ts:126-129).  A 4:2:0 format takes
    its chroma from the even (top-field) lines (JAX io.py
    interleave_rgba_fields)."""
    pack = make_pack_program(fmt_name, width, height, col_spec, gamma_mode, plain)

    def program(top_rgba, bottom_rgba):
        return pack(fio.interleave_rgba_fields(top_rgba, bottom_rgba))

    return program


@lru_cache(maxsize=None)
def make_interlaced_word_pack_program(fmt_name: str):
    """Field-pair interlaced output in the PACKED domain, or None.

    For a format without vertical chroma subsampling (sub_y == 1: v210,
    planar 4:2:2, RGB) every packed row depends only on its own image row, so
    the interlaced wire frame is a row-parity select over the two field
    ticks' packed planes, equal to interleave_rgba_fields + pack with no
    second encode.  sub_y > 1 formats (4:2:0) return None and keep the
    RGBA path."""
    if get_format(fmt_name).INFO.sub_y != 1:
        return None

    def program(top_planes, bottom_planes):
        outs = []
        for t, b in zip(top_planes, bottom_planes):
            # every sub_y == 1 format packs planes with image rows as the
            # leading dim: v210 and planar (H, words | pitch), RGB (H, W, 4);
            # a row copy, which every sample type has on CUDA (torch.where
            # has no uint16 kernel there)
            out = b.clone()
            out[0::2] = t[0::2]
            outs.append(out)
        return outs

    return program


@lru_cache(maxsize=None)
def make_yadif_pair_field_program(
    height: int, width: int, tff: bool, channels: int = 4, skip_spatial: bool = False,
    plain: bool = False,
):
    """Producer-side pair deinterlace: BOTH field ticks of a frame period
    from one launch and one ring read (the yadif pair kernel).

    Returns fn(prev, cur, next_) -> (first, second) in field EMISSION
    order (tff: parity 0 then 1; bff: 1 then 0, the runtime/layer.py
    parity law).  Each output equals the in-program yadif ring path at
    that parity.  The channel program then takes the fields as
    ``rgba_f32`` sources."""
    st = _PLAIN if plain else _KERNELS
    shape = (channels, height, width)

    def program(prev, cur, next_):
        if tuple(cur.shape) != shape:
            raise ValueError(f"yadif pair program: frame {tuple(cur.shape)}, expected {shape}")
        o0, o1 = st.yadif_pair(prev, cur, next_, tff, skip_spatial)
        return (o0, o1) if tff else (o1, o0)

    return program


@lru_cache(maxsize=None)
def make_yadif_program(tff: bool, skip_spatial: bool):
    """Standalone deinterlace step over a 3-frame ring:
    fn(prev, cur, next_, parity) -> the frame at that parity (the yadif
    ring kernel)."""

    def program(prev, cur, next_, parity):
        return yadif.yadif_ring(prev, cur, next_, parity, tff, skip_spatial)

    return program
