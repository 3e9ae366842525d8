"""The packed-source warp and the packed composite: DVE layers that read
v210 words (the warp decodes each bilinear tap; the composite decodes
each tile's source window once), opaque 3-channel frames or RGBA frames
with their own alpha.

Counterpart of phaneron_tpu/ops/pallas_packed_warp.py,
pallas_composite.py and pallas_warp.py's all-layers combine:

| wrapper          | CUDA source               | replaces                                                   |
|------------------|---------------------------|------------------------------------------------------------|
| packed_warp      | csrc/packed_warp.cu       | pallas_packed_warp.py _make_program (make_packed_warp_program, make_packed_warp_pair_program, n_mat 1 and 2) |
| packed_composite | csrc/packed_composite.cu  | pallas_packed_warp.py make_packed_composite_program (emit 'packed', 'rgba', 'both'; src_kind 'rgb3' and 'packed', alpha 'coverage'); pallas_composite.py make_composite_program (src_kind 'packed', alpha 'top'); pallas_warp.py make_layers_combine_program (src_kind 'rgba', alpha 'top') |

``packed_warp`` decodes one v210 source (or a dissolve pair under one
shared or two distinct matrices) at the taps of an axis-aligned warp and
returns linear RGBA; its alpha is the warp of the constant-1 plane.  Its
kernel decodes each output tile's source window once into shared memory
(``warp_window_counts`` is the plain version of its choice between a
window and decoding each tap from the words); the tile rows and window
size live here (WARP_TILE_ROWS, WARP_WINDOW_TEXELS) and reach nvcc as -D
defines (``nvcc_defines``).
``packed_composite`` runs a run of DVE layers (cuts or same-matrix
dissolves) in one launch, into v210 words, into the composited RGBA
frame, or both (an ``emit_rgba`` channel), from opaque (3, H, W) float32
sources (``src_kind='rgb3'``, the deinterlaced fields of the interlaced
default load), from v210 words (``'packed'``, the progressive
multi-layer channel) or from (4, H, W) float32 RGBA frames that carry
their own alpha (``'rgba'``, the file-media multi-box channel).  The
frame's alpha is the run's coverage (``alpha='coverage'``: a run that
spans part of the stack, composited with the layers around it) or the
top layer's (``'top'``: a run that is the whole stack).  Each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors; ``.launches`` counts kernel launches.

The plain versions are the staged paths the kernels fuse: the v210
unpack, the warp (a dissolve pair mixed after the warp), and for the
composite the layer's alpha (the separable ``warp_alpha_vectors`` of an
opaque source, the warped and mixed alpha plane of an RGBA one),
``combine_rgb`` and the v210 pack.  The TPU kernels premix a
shared-matrix pair before one warp, in bf16 hi/lo products, and the
composite decodes with a polynomial gamma; the port keeps the staged
order and the exact decode, within 1 code of them
(tests/test_torch_packed_warp.py, tests/test_torch_packed_source.py,
tests/test_torch_fused_composite.py, tests/test_torch_layers_combine.py).
The TPU gates (``packed_warp_fits``, ``packed_composite_fits``,
``composite_supported``, ``layers_combine_fits``: widths a multiple of
128 or 768, VMEM plans, HD padded to 384 groups) are not ported: the
kernels take any geometry, so at 1080p the port takes these routes where
the JAX package on a TPU stays staged, with the same numbers within each
contract.

Band forms (``rows``, ops/kernels.py Rows; a row-sharded channel,
parallel/bands.py): each source is a window of the rows the band's taps
reach (``axis_window``; v210 words or frames), and the result is the
band's output rows, each equal to that row of the full-frame call; the
plain versions compute from the windows alone.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import library
from .composite import combine_rgb, mix_frames
from .formats import v210 as v210fmt
from .geometry import warp_axis_aligned
from .kernels import (
    Rows,
    _check_mix,
    _encode_coeffs,
    check_arg,
    check_launch,
    check_window,
    is_cpu,
    launched,
    stream_handle,
    v210_decode_args,
    v210_pack_plain,
    v210_unpack_plain,
)
from .warp import warp_alpha_vectors, warp_plain

__all__ = [
    "packed_warp",
    "packed_warp_plain",
    "packed_composite",
    "packed_composite_plain",
    "coverage",
    "MAX_LAYERS",
    "axis_window",
    "warp_window_counts",
    "nvcc_defines",
]

MAX_LAYERS = 8  # layers per launch (kMaxLayers in csrc/packed_composite.cu)
_KINDS = ("rgb3", "packed", "rgba")  # kind codes 0, 1, 2 of csrc/packed_composite.cu
_EMITS = ("packed", "rgba", "both")
_ALPHAS = ("coverage", "top")
# csrc/packed_warp.cu's output tiles are WARP_TILE_W columns (32 v210
# groups, one thread a column) by WARP_TILE_ROWS rows; a source's window
# spans whole groups and fits in shared memory when its texels are at most
# WARP_WINDOW_TEXELS
WARP_TILE_W = 192
WARP_TILE_ROWS = 4
WARP_WINDOW_TEXELS = 1536


def nvcc_defines() -> tuple:
    """The constants above as the -D flags csrc/packed_warp.cu is built
    with."""
    return (f"-DPHN_PACKED_WARP_TILE_ROWS={WARP_TILE_ROWS}",
            f"-DPHN_PACKED_WARP_WINDOW_TEXELS={WARP_WINDOW_TEXELS}")


def _span(m, off, lo, hi, size: int) -> tuple:
    """[first, last] of the texels the valid taps of output indices
    [lo, hi] reach along one axis (phn_common.cuh span_of): the floors
    of the ends' texel coordinates, computed in float32 as
    warp_axis_aligned computes them (x / size - 0.5 by a tensor divisor,
    then (m * c + off + 0.5) * size - 0.5), bound every floor between them
    because each step rounds monotonically; the taps are floor and
    floor + 1, clipped to the frame.  Empty where first > last."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=m.device)
    fs = f32(float(size))

    def floor_at(i):
        c = f32(i) / fs - 0.5
        return torch.floor((m * c + off + 0.5) * fs - 0.5)

    a, b = torch.broadcast_tensors(floor_at(lo), floor_at(hi))
    first = torch.clamp(torch.minimum(a, b), min=0.0)
    last = torch.clamp(torch.maximum(a, b) + 1.0, max=fs - 1.0)
    empty = first > last
    return (torch.where(empty, 0.0, first).to(torch.int64), torch.where(empty, -1.0, last).to(torch.int64))


def axis_window(mat, x_lo, x_hi, y_lo, y_hi, width: int, height: int) -> tuple:
    """The source window of the output tile of columns [x_lo, x_hi] by rows
    [y_lo, y_hi] under the axis-aligned matrix ``mat`` (3, 3)
    (phn_common.cuh tile_window before its alignment): (x_first, x_last,
    y_first, y_last) as int64 tensors, the texels the tile's valid taps
    reach; empty where first > last on either axis.  The tile bounds may
    be tensors (one tile each, broadcast together).  It holds every valid
    tap of every pixel of the tile (tests/test_torch_warp_windows.py)."""
    mat = torch.as_tensor(mat, dtype=torch.float32)
    x0, x1 = _span(mat[0, 0], mat[0, 2], x_lo, x_hi, width)
    y0, y1 = _span(mat[1, 1], mat[1, 2], y_lo, y_hi, height)
    return x0, x1, y0, y1


def warp_window_counts(mat, width: int, height: int, rows: Rows | None = None) -> list:
    """[window, direct]: the tiles in which the packed warp kernel samples
    one source under ``mat`` from its decoded shared-memory window and
    straight from the words.  A tile's window (``axis_window``, its
    columns whole 6-texel groups) fits when its texels are at most
    WARP_WINDOW_TEXELS, as csrc/packed_warp.cu decides tile by tile.  An
    empty window fits.  With ``rows`` (a band form) the tiles start at the
    band's first row and the last is clipped to its last."""
    mat = torch.as_tensor(mat, dtype=torch.float32)
    row0, row1 = (0, height) if rows is None else (rows.row0, rows.row1)
    xl = torch.arange(0, width, WARP_TILE_W, device=mat.device)
    yl = torch.arange(row0, row1, WARP_TILE_ROWS, device=mat.device)[:, None]
    x0, x1, y0, y1 = axis_window(mat, xl, torch.clamp(xl + WARP_TILE_W - 1, max=width - 1), yl,
                                 torch.clamp(yl + WARP_TILE_ROWS - 1, max=row1 - 1), width, height)
    cols = (x1 // 6 - x0 // 6 + 1) * 6
    texels = torch.where((x0 > x1) | (y0 > y1), 0, (y1 - y0 + 1) * cols).expand(yl.shape[0], xl.shape[0])
    fits = int((texels <= WARP_WINDOW_TEXELS).sum())
    return [fits, texels.numel() - fits]


def _mat_on(mat, device: torch.device, name: str) -> torch.Tensor:
    mat = torch.as_tensor(mat, dtype=torch.float32, device=device)
    check_arg(mat, name, device, torch.float32, (3, 3))
    return mat


# ------------------------------------------------------ B6 packed warp


def packed_warp_plain(
    words: torch.Tensor, mat, width: int, height: int, words_b: torch.Tensor | None = None,
    mix=None, mat_b=None, col_spec: str = "709", out_col_spec: str = "709",
    rows: Rows | None = None,
) -> torch.Tensor:
    """Plain version of packed_warp: v210_unpack_plain (4 ch) ->
    warp_axis_aligned (-> mix_frames); with ``rows`` the unpack decodes the
    words' window rows only (it is row-local) and the warp is its band
    form."""
    srcs = v210_unpack_plain(
        [words] + ([words_b] if words_b is not None else []), width, words.shape[0],
        col_spec, out_col_spec,
    )
    out = warp_axis_aligned(srcs[0], mat, rows)
    if words_b is None:
        return out
    return mix_frames(out, warp_axis_aligned(srcs[1], mat if mat_b is None else mat_b, rows), mix)


def packed_warp(
    words: torch.Tensor, mat, width: int, height: int, words_b: torch.Tensor | None = None,
    mix=None, mat_b=None, col_spec: str = "709", out_col_spec: str = "709",
    branches: torch.Tensor | None = None, rows: Rows | None = None,
) -> torch.Tensor:
    """Axis-aligned bilinear DVE warp of a v210 source, (H, pitch_bytes/4)
    int32 words, by the (3, 3) matrix ``mat`` (m00, m02, m11, m12 read),
    border zero, decoding each tap -> linear RGBA (4, H, W) float32.  With
    ``words_b`` and ``mix``: the dissolve pair warp(a)*mix +
    warp(b)*(1-mix), b under ``mat_b`` (default: ``mat``).

    ``branches``, a (2,) int64 tensor on the words' device, gets the
    (tile, source) pairs the kernel sampled from a decoded shared-memory
    window and straight from the words added: [window, direct] (a
    measurement hook, read by chip_smoke.py).

    Band form: with ``rows`` (ops/kernels.py Rows, ``rows.height`` ==
    ``height``) the words hold frame rows from ``rows.src_row0`` on and the
    result is (4, rows, W), output rows [rows.row0, rows.row1)."""
    if (words_b is None) != (mix is None):
        raise ValueError("packed_warp: words_b and mix go together")
    if words_b is None and mat_b is not None:
        raise ValueError("packed_warp: mat_b needs words_b")
    if rows is not None and rows.height != height:
        raise ValueError(f"packed_warp: rows of a {rows.height}-row frame, height {height}")
    if rows is not None:
        rows.check("packed_warp", words.shape[0])
    if is_cpu(words, "packed_warp"):
        return packed_warp_plain(
            words, mat, width, height, words_b, mix, mat_b, col_spec, out_col_spec, rows
        )
    # a full-frame call holds every row; a band's window, the rows it reaches
    shape = (height if rows is None else words.shape[0], v210fmt.pitch(width) // 6 * 4)
    rows = Rows.full(height) if rows is None else rows
    dev = words.device
    groups = shape[1] // 4
    check_arg(words, "packed_warp words", dev, torch.int32, shape, align=16)
    mat = _mat_on(mat, dev, "packed_warp mat")
    b_ptr = mat_b_ptr = mix_ptr = None
    if words_b is not None:
        check_arg(words_b, "packed_warp words_b", dev, torch.int32, shape, align=16)
        mat_b = mat if mat_b is None else _mat_on(mat_b, dev, "packed_warp mat_b")
        mix = _check_mix(mix, dev)
        b_ptr, mat_b_ptr, mix_ptr = words_b.data_ptr(), mat_b.data_ptr(), mix.data_ptr()
    if branches is not None:
        check_arg(branches, "packed_warp branches", dev, torch.int64, (2,), align=8)
    out = torch.empty((4, rows.n, width), dtype=torch.float32, device=dev)
    coeffs, g2l = v210_decode_args(col_spec, out_col_spec, dev)
    with torch.cuda.device(dev):
        rc = library().phn_packed_warp(
            words.data_ptr(), b_ptr, mat.data_ptr(), mat_b_ptr, mix_ptr, out.data_ptr(),
            width, height, groups, rows.row0, rows.n, rows.src_row0, shape[0], coeffs, g2l,
            None if branches is None else branches.data_ptr(), stream_handle(dev),
        )
    check_launch(rc, "packed_warp")
    launched(packed_warp)
    return out


packed_warp.launches = 0


# ------------------------------------------------- K5 packed composite


def _check_layers(srcs: Sequence[torch.Tensor], layer_cfg: Sequence[int], mats, mixes,
                  src_kind: str, size, emit: str, alpha: str,
                  rows: Rows | None = None) -> tuple[int, int]:
    """(height, width) of the frame, after the structural checks (with
    ``rows``, the band form's: each source's window inside the frame)."""
    if src_kind not in _KINDS:
        raise ValueError(f"packed_composite: src_kind must be one of {_KINDS}, got {src_kind!r}")
    if emit not in _EMITS:
        raise ValueError(f"packed_composite: emit must be one of {_EMITS}, got {emit!r}")
    if alpha not in _ALPHAS:
        raise ValueError(f"packed_composite: alpha must be one of {_ALPHAS}, got {alpha!r}")
    if not layer_cfg or any(n not in (1, 2) for n in layer_cfg):
        raise ValueError(f"packed_composite: layer_cfg entries must be 1 or 2, got {layer_cfg}")
    if len(srcs) != sum(layer_cfg):
        raise ValueError(f"packed_composite: {len(srcs)} sources for layer_cfg {layer_cfg}")
    if len(mats) != len(layer_cfg) or len(mixes) != len(layer_cfg):
        raise ValueError("packed_composite: one matrix and one mix per layer")
    for n, mix in zip(layer_cfg, mixes):
        if n == 2 and mix is None:
            raise ValueError("packed_composite: a dissolve layer needs its mix")
    shape = tuple(srcs[0].shape)
    if src_kind == "packed":
        if size is None:
            raise ValueError("packed_composite: packed sources need size=(width, height)")
        h, w = size[1], size[0]
    else:
        channels = 4 if src_kind == "rgba" else 3
        if len(shape) != 3 or shape[0] != channels:
            raise ValueError(f"packed_composite: expected ({channels}, H, W) sources, got {shape}")
        h, w = shape[1], shape[2]
    if rows is not None:
        if src_kind == "packed" and rows.height != h:
            raise ValueError(f"packed_composite: rows of a {rows.height}-row frame, size {size}")
        h = rows.height
        for s, r0 in zip(srcs, _src_rows0(rows, len(srcs))):
            rows.check("packed_composite", s.shape[-2 if src_kind != "packed" else 0], r0)
    return h, w


def _src_rows0(rows: Rows | None, n: int) -> tuple:
    """Each source's first frame row: ``rows.src_row0``, one for all or a
    tuple of n (0 for a full-frame call)."""
    if rows is None:
        return (0,) * n
    r0 = rows.src_row0
    r0 = tuple(r0) if isinstance(r0, (tuple, list)) else (r0,) * n
    if len(r0) != n:
        raise ValueError(f"packed_composite: {len(r0)} source rows for {n} sources")
    return r0


def _layer_alpha(layer) -> torch.Tensor:
    """A layer's (H, W) alpha: wy[:, None] * wx of an (rgb, wy, wx) tuple,
    channel 3 of a (4, H, W) frame."""
    if isinstance(layer, tuple):
        _, wy, wx = layer
        return wy[:, None] * wx[None, :]
    return layer[3]


def coverage(layers: Sequence) -> torch.Tensor:
    """The 'over'-accumulated alpha of layers, bottom to top, each an (rgb,
    wy, wx) tuple or a (4, H, W) frame (``_layer_alpha``): a = a*(1 - a_m)
    + a_m from a_0, i.e. 1 - prod(1 - a_m) (pallas_packed_warp.py
    make_packed_composite_program, emit 'rgba')."""
    cover = None
    for layer in layers:
        a = _layer_alpha(layer)
        cover = a if cover is None else cover * (1.0 - a) + a
    return cover


def packed_composite_plain(
    srcs: Sequence[torch.Tensor], layer_cfg: Sequence[int], mats, mixes,
    out_col_spec: str = "709", src_kind: str = "rgb3", size=None, col_spec: str = "709",
    emit: str = "packed", alpha: str = "coverage", rows: Rows | None = None,
):
    """Plain version of packed_composite: [v210_unpack_plain (3 ch) ->] the
    staged warp (all four channels for 'rgba' sources) -> combine_rgb ->
    v210 pack path, and for the rgba emits the frame (combine_rgb, then
    ``coverage`` or the top layer's alpha).  With ``rows`` the unpack
    decodes each source's window rows (it is row-local), the warps are
    their band forms, and the rest is row-local."""
    h, w = _check_layers(srcs, layer_cfg, mats, mixes, src_kind, size, emit, alpha, rows)
    if src_kind == "packed":
        srcs = [v210_unpack_plain([s], w, s.shape[0], col_spec, out_col_spec, channels=3)[0] for s in srcs]
    band = [None if rows is None else rows._replace(src_row0=r0) for r0 in _src_rows0(rows, len(srcs))]
    layers, s = [], 0
    for n, mat, mix in zip(layer_cfg, mats, mixes):
        v = warp_plain(srcs[s], mat, rows=band[s])
        if n == 2:
            v = mix_frames(v, warp_plain(srcs[s + 1], mat, rows=band[s + 1]), mix)
        layers.append(v if src_kind == "rgba" else (v, *warp_alpha_vectors(h, w, mat, rows)))
        s += n
    rgb = combine_rgb(layers)
    words = v210_pack_plain(rgb, out_col_spec) if emit != "rgba" else None
    if emit == "packed":
        return words
    a = _layer_alpha(layers[-1]) if alpha == "top" else coverage(layers)
    rgba = torch.cat([rgb, a[None]])
    return rgba if emit == "rgba" else (words, rgba)


def packed_composite(
    srcs: Sequence[torch.Tensor], layer_cfg: Sequence[int], mats, mixes,
    out_col_spec: str = "709", src_kind: str = "rgb3", size=None, col_spec: str = "709",
    emit: str = "packed", alpha: str = "coverage", branches: torch.Tensor | None = None,
    rows: Rows | None = None,
):
    """Layers bottom to top -> v210 words (H, pitch_bytes/4) int32
    (``emit='packed'``), the composited (4, H, W) float32 frame
    (``'rgba'``: RGB over black, alpha the run's coverage, see
    ``coverage``, or with ``alpha='top'`` the top layer's), or (words,
    frame) (``'both'``).

    ``src_kind='rgb3'``: opaque (3, H, W) float32 sources.  ``'packed'``:
    v210 words (H, pitch_bytes/4) int32 of a ``size=(width, height)``
    frame, decoded (``col_spec`` -> ``out_col_spec``) as K1 decodes them.
    ``'rgba'``: (4, H, W) float32 premultiplied RGBA sources.
    ``layer_cfg[m]`` is layer m's source count (1 a cut, 2 a dissolve
    pair); ``srcs`` lists them flat.  ``mats[m]`` is its (3, 3) matrix
    (only m00, m02, m11, m12 are read), ``mixes[m]`` its mix (a 0-d
    tensor or float; None for a cut).  A layer's alpha is its separable
    warp alpha (opaque sources) or its warped, mixed alpha plane
    ('rgba'); the bottom layer composites over black.

    The kernel brings v210 and rgb3 sources into shared memory once per
    tile of the output (a window of the texels the tile's taps reach,
    decoded from the words or copied from the frames), and samples a
    window too large for it straight from device memory.  ``branches``, a
    (2,) int64 tensor on the sources' device, gets the (tile, source) pairs
    of each branch added: [window, direct] (for 'packed' and 'rgb3'
    sources; a measurement hook, read by chip_smoke.py).

    Band form: with ``rows`` (ops/kernels.py Rows) each source holds frame
    rows from its own first row on (``rows.src_row0``: one for all, or a
    tuple with one a source; frames each row contiguous, the planes any
    stride apart) and the outputs are output rows [rows.row0, rows.row1)
    of the ``rows.height``-row frame."""
    h, w = _check_layers(srcs, layer_cfg, mats, mixes, src_kind, size, emit, alpha, rows)
    if is_cpu(srcs[0], "packed_composite"):
        return packed_composite_plain(
            srcs, layer_cfg, mats, mixes, out_col_spec, src_kind, size, col_spec, emit, alpha, rows
        )
    if len(layer_cfg) > MAX_LAYERS:
        raise ValueError(f"packed_composite: at most {MAX_LAYERS} layers per launch")
    dev = srcs[0].device
    groups = v210fmt.pitch(w) // 6
    packed = src_kind == "packed"
    starts, band = _src_rows0(rows, len(srcs)), rows is not None
    rows = Rows.full(h) if rows is None else rows
    for s in srcs:
        # a full-frame call holds every row; a band's window, the rows it reaches
        src_rows = s.shape[0 if packed else 1] if band else h
        if packed:
            check_arg(s, "packed_composite words", dev, torch.int32, (src_rows, groups * 4), align=16)
        else:
            check_window(s, "packed_composite src", dev, (srcs[0].shape[0], src_rows, w))
    mats = [_mat_on(m, dev, "packed_composite mat") for m in mats]
    mixes = [None if n == 1 else _check_mix(x, dev) for n, x in zip(layer_cfg, mixes)]
    words = rgba = None
    if emit != "rgba":
        words = torch.empty((rows.n, groups * 4), dtype=torch.int32, device=dev)
    if emit != "packed":
        rgba = torch.empty((4, rows.n, w), dtype=torch.float32, device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(None if t is None else t.data_ptr() for t in ts))
    src_p, mat_p, mix_p = ptrs(srcs), ptrs(mats), ptrs(mixes)
    n_src = (ctypes.c_int * len(layer_cfg))(*layer_cfg)
    src_row0s = (ctypes.c_int * len(srcs))(*starts)
    planes = (ctypes.c_longlong * len(srcs))(*(0 if packed else s.stride(0) for s in srcs))
    dec, g2l = v210_decode_args(col_spec, out_col_spec, dev) if packed else (None, None)
    if branches is not None:
        check_arg(branches, "packed_composite branches", dev, torch.int64, (2,), align=8)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = library().phn_packed_composite(
            ctypes.addressof(src_p), ctypes.addressof(mat_p), ctypes.addressof(mix_p),
            ctypes.addressof(n_src), len(layer_cfg), _KINDS.index(src_kind), ptr(words), ptr(rgba),
            w, h, groups, rows.row0, rows.n, ctypes.addressof(src_row0s), ctypes.addressof(planes),
            dec, g2l, ctypes.addressof(_encode_coeffs(out_col_spec)),
            int(alpha == "top"), ptr(branches), stream_handle(dev),
        )
    check_launch(rc, "packed_composite")
    launched(packed_composite)
    if emit == "packed":
        return words
    return rgba if emit == "rgba" else (words, rgba)


packed_composite.launches = 0
