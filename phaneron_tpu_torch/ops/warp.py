"""The axis-aligned DVE warp kernel (single source, dissolve pair, wipe
pair).

Counterpart of phaneron_tpu/ops/pallas_warp.py (``_make_program`` in all
its modes: single, dissolve pair and wipe pair, one shared matrix or two,
``n_ch`` 4 and 3).  ``warp`` launches csrc/warp.cu for CUDA tensors and
runs ``warp_plain`` (ops/geometry.py warp_axis_aligned, then mix_frames
or wipe_mask) for CPU tensors; ``warp.launches`` counts kernel launches.
Frames are (C, H, W) float32 with C = 4 (RGBA) or 3 (opaque alpha-free
frames, whose warped alpha is ``warp_alpha_vectors``).

Band form (``rows``, ops/kernels.py Rows; a row-sharded channel,
parallel/bands.py): the sources are windows of the rows the band's taps
reach and the result is the band's output rows, each equal to that row of
the full-frame warp; ``warp_plain`` computes from the windows alone.

The TPU kernel's scale buckets, DMA windows and one-hot weights exist
for VMEM; the CUDA kernel gathers its taps directly, so it takes any
geometry and any axis-aligned matrix.
"""

from __future__ import annotations

import torch

from ._build import library
from .composite import mix_frames, wipe_mask
from .geometry import _bilinear_setup, _out_coords, warp_axis_aligned
from .kernels import Rows, _check_mix, check_arg, check_launch, check_window, is_cpu, launched, stream_handle

__all__ = ["warp", "warp_plain", "warp_alpha_vectors", "pair_args", "mix_pair", "launch_pair"]


def warp_alpha_vectors(height: int, width: int, mat: torch.Tensor, rows: Rows | None = None) -> tuple:
    """(wy (H,), wx (W,)) float32 with warp(ones)(y, x) == wy[y] * wx[x]
    (pallas_warp.py warp_alpha_vectors); with ``rows``, wy of output rows
    [rows.row0, rows.row1) only.

    An axis-aligned bilinear warp of the constant-1 plane is separable:
    each output pixel's alpha is (row-weight sum) x (column-weight sum),
    1 in the projected interior, a bilinear feather at the edge, 0
    outside (border zero).  Opaque sources therefore never carry an alpha
    plane through yadif or the warp; the combine rebuilds alpha as this
    outer product.  Plain tensor code on ``mat``'s device."""
    mat = torch.as_tensor(mat, dtype=torch.float32)

    def weight_sum(pos, size):
        p0, f = _bilinear_setup(pos, size)
        w0 = torch.where((p0 >= 0) & (p0 < size), 1.0 - f, 0.0)
        w1 = torch.where((p0 + 1 >= 0) & (p0 + 1 < size), f, 0.0)
        return w0 + w1

    lo, hi = (0, height) if rows is None else (rows.row0, rows.row1)
    px = mat[0, 0] * _out_coords(width, mat.device) + mat[0, 2] + 0.5
    py = mat[1, 1] * _out_coords(height, mat.device, lo, hi) + mat[1, 2] + 0.5
    return weight_sum(py, height), weight_sum(px, width)


def mix_pair(out: torch.Tensor, out_b: torch.Tensor, mix, mask) -> torch.Tensor:
    """The pair step after two warps: the dissolve
    out*mix + out_b*(1-mix), or with a (H, W) ``mask`` the wipe
    out_b*m + out*(1-m) (the JAX package's XLA expressions,
    pipeline.py:466-476)."""
    if mask is not None:
        return wipe_mask(out, out_b, mask[None])
    return mix_frames(out, out_b, mix)


def pair_args(name: str, src: torch.Tensor, src_b, mix, mat_b, mask) -> None:
    """The argument rules shared by the pair kernels: a single source
    takes none of src_b, mix, mat_b, mask; a pair takes src_b and
    exactly one of mix (dissolve) or mask (wipe)."""
    if src.ndim != 3 or src.shape[0] not in (3, 4):
        raise ValueError(f"{name}: expected (3|4, H, W), got {tuple(src.shape)}")
    if src_b is None:
        if mix is not None or mask is not None or mat_b is not None:
            raise ValueError(f"{name}: mix, mask and mat_b need src_b")
    elif (mix is None) == (mask is None):
        raise ValueError(f"{name}: src_b takes either mix (dissolve) or mask (wipe)")


def warp_plain(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
    mat_b: torch.Tensor | None = None, mask: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> torch.Tensor:
    """Plain version of warp: warp(src), or the pair step (``mix_pair``)
    over warp(src, mat) and warp(src_b, mat_b); a band form with ``rows``."""
    out = warp_axis_aligned(src, mat, rows)
    if src_b is None:
        return out
    return mix_pair(out, warp_axis_aligned(src_b, mat if mat_b is None else mat_b, rows), mix, mask)


def warp(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
    mat_b: torch.Tensor | None = None, mask: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> torch.Tensor:
    """Axis-aligned bilinear DVE warp of a (C, H, W) float32 frame, C = 3
    or 4, by the (3, 3) matrix ``mat`` (only m00, m02, m11, m12 are
    read), border zero.  With ``src_b``, under ``mat_b`` (default:
    ``mat``): the dissolve pair warp(src)*mix + warp(src_b)*(1-mix), or
    with an (H, W) float32 ``mask`` in place of ``mix`` the wipe pair
    warp(src_b)*m + warp(src)*(1-m).

    Band form: with ``rows`` (ops/kernels.py Rows) ``src`` and ``src_b``
    hold frame rows from ``rows.src_row0`` on (each row contiguous, the
    planes any stride apart: a view of a taller frame), ``mask`` is the
    band's (rows, W), and the result is (C, rows, W), output rows
    [rows.row0, rows.row1) of the ``rows.height``-row frame."""
    pair_args("warp", src, src_b, mix, mat_b, mask)
    if rows is not None:
        rows.check("warp", src.shape[1])
    if is_cpu(src, "warp"):
        return warp_plain(src, mat, src_b, mix, mat_b, mask, rows)
    out = launch_pair("warp", "phn_warp", src, mat, src_b, mix, mat_b, mask,
                      Rows.full(src.shape[1]) if rows is None else rows)
    launched(warp)
    return out


def launch_pair(
    name: str, entry: str, src: torch.Tensor, mat, src_b, mix, mat_b, mask, rows: Rows,
    extra: tuple = (),
) -> torch.Tensor:
    """Check the CUDA arguments of a pair kernel (csrc/warp.cu phn_warp,
    csrc/rotate.cu phn_rotate: one C interface, to which ``entry`` may add
    the arguments ``extra`` before the stream), launch ``entry`` on the
    current stream and return its output.  ``rows`` is the band (a full
    frame: ``Rows.full``): the sources are windows read through their
    plane stride (one for both), and the band's rows, window and stride go
    before ``extra``."""
    dev = src.device
    c, h, w = src.shape
    out_h = rows.n
    check_window(src, f"{name} src", dev, (c, h, w))
    mat = torch.as_tensor(mat, dtype=torch.float32, device=dev)
    check_arg(mat, f"{name} mat", dev, torch.float32, (3, 3))
    ptrs = dict(b=None, mat_b=None, mix=None, mask=None)
    if src_b is not None:
        check_window(src_b, f"{name} src_b", dev, (c, h, w))
        ptrs["b"] = src_b.data_ptr()
        if mat_b is not None:
            mat_b = torch.as_tensor(mat_b, dtype=torch.float32, device=dev)
            check_arg(mat_b, f"{name} mat_b", dev, torch.float32, (3, 3))
            ptrs["mat_b"] = mat_b.data_ptr()
        if mask is not None:
            check_arg(mask, f"{name} mask", dev, torch.float32, (out_h, w))
            ptrs["mask"] = mask.data_ptr()
        else:
            mix = _check_mix(mix, dev)
            ptrs["mix"] = mix.data_ptr()
    out = torch.empty((c, out_h, w), dtype=torch.float32, device=dev)
    if src_b is not None and src_b.stride(0) != src.stride(0):  # the kernel takes one plane stride
        src, src_b = src.contiguous(), src_b.contiguous()
        ptrs["b"] = src_b.data_ptr()
    frame = (c, rows.height, w, rows.row0, rows.n, rows.src_row0, h, src.stride(0))
    with torch.cuda.device(dev):
        rc = getattr(library(), entry)(
            src.data_ptr(), ptrs["b"], mat.data_ptr(), ptrs["mat_b"], ptrs["mix"], ptrs["mask"],
            out.data_ptr(), *frame, *extra, stream_handle(dev),
        )
    check_launch(rc, name)
    return out


warp.launches = 0
