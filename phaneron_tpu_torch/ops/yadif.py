"""Yadif deinterlacer: spatial + temporal field interpolation
(counterpart of phaneron_tpu/ops/yadif.py and ops/pallas_yadif.py).

For every pixel of the missing field, a spatial predictor searches
three edge directions (x±1..3) across the adjacent lines, then a
temporal predictor clamps it against prev/cur/next frame statistics
(yadifCl.ts:34-167, FFmpeg's yadif_cuda).  Frames are planar (C, H, W)
float32, C = 4 (RGBA) or 3 (opaque alpha-free rings).  ``parity`` is a
Python int or a 0-d int32 tensor: rows ``y % 2 == parity`` keep ``cur``,
the others are predicted; a tensor parity needs no host sync.

- ``yadif_frame``: the plain full-frame formulation (JAX
  ``_yadif_full``, which JAX's ``yadif_frame`` dispatches to or to the
  bit-identical ``_yadif_half`` that exists for XLA fusion), tap for
  tap in the reference's order, so it equals the JAX package bit for
  bit.
- ``yadif_ring`` / ``yadif_ring_plain``: one parity over a 3-frame ring
  (replaces pallas_yadif.py ``_make_kernel`` via
  ``make_yadif_ring_program``).
- ``yadif_pair`` / ``yadif_pair_plain``: both parities from one pass over
  the ring -> (parity 0, parity 1) (replaces ``_make_pair_kernel`` via
  ``make_yadif_pair_program``, and ``_make_pair_split_kernel``, the same
  function on another grid).

The wrappers launch csrc/yadif.cu for CUDA tensors and run the plain
versions for CPU tensors; ``wrapper.launches`` counts kernel launches.
With ``opaque`` (C = 4 only) the alpha written is the constant 1, as
every non-RGB unpack emits.  Halving is ``/ 2.0``, which is exact in
IEEE arithmetic whether PyTorch divides or multiplies by 0.5.

Band form of the ring (``rows``, ops/kernels.py Rows; a row-sharded
channel, parallel/bands.py): the ring frames are windows of the frame's
rows from ``rows.src_row0`` on that hold the band's rows and two more on
each side where the frame has them (``ring_window``), and the result is
output rows [rows.row0, rows.row1).  A row's field parity is its frame
row's and the clamp is at the frame's edges, never the band's, so each
row equals that row of the full-frame pass.
"""

from __future__ import annotations

import torch

from ._build import library
from .kernels import Rows, check_arg, check_launch, check_window, is_cpu, launched, stream_handle

__all__ = [
    "yadif_frame",
    "yadif_ring",
    "yadif_ring_plain",
    "yadif_pair",
    "yadif_pair_plain",
    "ring_window",
]


def ring_window(row0: int, row1: int, height: int) -> tuple[int, int]:
    """[first, last + 1) of the ring rows that output rows [row0, row1)
    read: two more each side, within the frame (the taps reach y-2..y+2)."""
    return max(row0 - 2, 0), min(row1 + 2, height)


def _shift(img: torch.Tensor, dx: int, dy: int, rows: Rows | None = None) -> torch.Tensor:
    """out[..., y, x] = img[..., clamp(y+dy), clamp(x+dx)]: the kernel's
    CLK_ADDRESS_CLAMP_TO_EDGE sampling (yadifCl.ts:29-32).  With ``rows``
    (a band form) img holds frame rows from rows.src_row0 on and out the
    frame rows [rows.row0, rows.row1), clamped at the frame's edges."""
    h, w = img.shape[-2], img.shape[-1]
    if rows is not None:
        y = torch.arange(rows.row0, rows.row1, device=img.device) + dy
        img = img.index_select(-2, torch.clamp(y, 0, rows.height - 1) - rows.src_row0)
    elif dy:
        idx = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
        img = img.index_select(-2, idx)
    if dx:
        cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
        img = img.index_select(-1, cols)
    return img


def _spatial_from_taps(a, b, c, d, e, f, g, h, i, j, k, l, m, n):
    """Edge-directed spatial interpolation (yadifCl.ts:34-62); a..g are
    the line-above taps at x-3..x+3, h..n the line below."""
    pred = (d + k) / 2.0
    score = torch.abs(c - j) + torch.abs(d - k) + torch.abs(e - l)

    s1 = torch.abs(b - k) + torch.abs(c - l) + torch.abs(d - m)
    cmp1 = s1 < score
    pred = torch.where(cmp1, (c + l) / 2.0, pred)
    score = torch.where(cmp1, s1, score)
    s2 = torch.abs(a - l) + torch.abs(b - m) + torch.abs(c - n)
    s2 = torch.where(cmp1, s2, s1)
    cmp2 = cmp1 & (s2 < score)
    pred = torch.where(cmp2, (b + m) / 2.0, pred)
    score = torch.where(cmp2, s2, score)

    s3 = torch.abs(d - i) + torch.abs(e - j) + torch.abs(f - k)
    cmp3 = s3 < score
    pred = torch.where(cmp3, (e + j) / 2.0, pred)
    score = torch.where(cmp3, s3, score)
    s4 = torch.abs(e - h) + torch.abs(f - i) + torch.abs(g - j)
    s4 = torch.where(cmp3, s4, s3)
    cmp4 = cmp3 & (s4 < score)
    pred = torch.where(cmp4, (f + i) / 2.0, pred)
    return pred


def _fmax3(a, b, c):
    return torch.maximum(torch.maximum(a, b), c)


def _fmin3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def _temporal_clamp(A, B, C, D, E, F, G, H, I, J, K, L, spatial, skip_spatial):
    """Temporal predictor clamp (yadifCl.ts:72-103)."""
    p0 = (C + H) / 2.0
    p1 = F
    p2 = (D + I) / 2.0
    p3 = G
    p4 = (E + J) / 2.0

    tdiff0 = torch.abs(D - I)
    tdiff1 = (torch.abs(A - F) + torch.abs(B - G)) / 2.0
    tdiff2 = (torch.abs(K - F) + torch.abs(G - L)) / 2.0
    diff = _fmax3(tdiff0, tdiff1, tdiff2)

    if not skip_spatial:
        p2mp3 = p2 - p3
        p2mp1 = p2 - p1
        p0mp1 = p0 - p1
        p4mp3 = p4 - p3
        maxi = _fmax3(p2mp3, p2mp1, torch.minimum(p0mp1, p4mp3))
        mini = _fmin3(p2mp3, p2mp1, torch.maximum(p0mp1, p4mp3))
        diff = _fmax3(diff, mini, -maxi)

    pred = torch.where(spatial > p2 + diff, p2 + diff, spatial)
    pred = torch.where(pred < p2 - diff, p2 - diff, pred)
    return pred


def yadif_frame(prev, cur, next_, parity, tff: bool, skip_spatial: bool = False,
                rows: Rows | None = None):
    """One yadif pass over a full frame (yadifCl.ts:105-167): (C, H, W)
    prev/cur/next -> (C, H, W).  Rows ``y % 2 == parity`` keep ``cur``;
    the other field's rows get the spatial prediction clamped by the
    temporal predictor.  With ``rows`` the band form (module docstring):
    the frames are windows, the result (C, rows, W)."""
    parity = torch.as_tensor(parity, dtype=torch.int32, device=cur.device)
    is_second = (parity ^ int(tff)) == 0  # yadifCl.ts:144

    s = lambda dx, dy: _shift(cur, dx, dy, rows)
    spatial = _spatial_from_taps(
        *(s(dx, -1) for dx in (-3, -2, -1, 0, 1, 2, 3)),
        *(s(dx, 1) for dx in (-3, -2, -1, 0, 1, 2, 3)),
    )

    sv = lambda img, dy: _shift(img, 0, dy, rows)
    pick = lambda a, b: torch.where(is_second, a, b)
    cur_rows = sv(cur, 0)
    A = sv(prev, -1)
    B = sv(prev, 1)
    C = pick(sv(cur, -2), sv(prev, -2))
    D = pick(cur_rows, sv(prev, 0))
    E = pick(sv(cur, 2), sv(prev, 2))
    F = sv(cur, -1)
    G = sv(cur, 1)
    H = pick(sv(next_, -2), sv(cur, -2))
    I = pick(sv(next_, 0), cur_rows)
    J = pick(sv(next_, 2), sv(cur, 2))
    K = sv(next_, -1)
    L = sv(next_, 1)

    pred = _temporal_clamp(A, B, C, D, E, F, G, H, I, J, K, L, spatial, skip_spatial)
    if cur.shape[0] == 4:
        pred[3] = cur_rows[3]  # alpha passes through from cur (yadifCl.ts:163-164)

    row0, row1 = (0, cur.shape[-2]) if rows is None else (rows.row0, rows.row1)
    y = torch.arange(row0, row1, dtype=torch.int32, device=cur.device)
    keep = ((y % 2) == parity)[None, :, None]
    return torch.where(keep, cur_rows, pred)


def _check_ring(name: str, prev, cur, next_) -> None:
    if cur.ndim != 3 or cur.shape[0] not in (3, 4):
        raise ValueError(f"{name}: expected (3|4, H, W) frames, got {tuple(cur.shape)}")
    if prev.shape != cur.shape or next_.shape != cur.shape:
        raise ValueError(f"{name}: ring frames differ in shape")


def yadif_ring_plain(prev, cur, next_, parity, tff: bool, skip_spatial: bool = False,
                     opaque: bool = False, rows: Rows | None = None) -> torch.Tensor:
    """Plain version of yadif_ring."""
    out = yadif_frame(prev, cur, next_, parity, tff, skip_spatial, rows)
    if opaque and out.shape[0] == 4:
        out[3] = 1.0
    return out


def yadif_pair_plain(prev, cur, next_, tff: bool, skip_spatial: bool = False,
                     opaque: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of yadif_pair."""
    return tuple(
        yadif_ring_plain(prev, cur, next_, p, tff, skip_spatial, opaque) for p in (0, 1)
    )


def _ring_args(name: str, prev, cur, next_):
    dev = cur.device
    c, h, w = cur.shape
    for t, arg in ((prev, "prev"), (cur, "cur"), (next_, "next_")):
        check_arg(t, f"{name} {arg}", dev, torch.float32, (c, h, w))
    return dev, c, h, w


def yadif_ring(prev, cur, next_, parity, tff: bool, skip_spatial: bool = False,
               opaque: bool = False, rows: Rows | None = None) -> torch.Tensor:
    """Yadif at one parity (0 or 1) over the ring (prev, cur, next_),
    each (C, H, W) float32 -> (C, H, W).  ``parity`` is read from device
    memory on the card, so alternating fields needs no host sync.

    Band form: with ``rows`` (ops/kernels.py Rows) the ring frames hold
    frame rows from ``rows.src_row0`` on, at least ``ring_window``'s (each
    row contiguous, the planes any stride apart, the same for the three),
    and the result is (C, rows, W), output rows [rows.row0, rows.row1)."""
    _check_ring("yadif_ring", prev, cur, next_)
    if rows is not None:
        rows.check("yadif_ring", cur.shape[1])
        lo, hi = ring_window(rows.row0, rows.row1, rows.height)
        if rows.src_row0 > lo or rows.src_row0 + cur.shape[1] < hi:
            raise ValueError(f"yadif_ring: the window of rows from {rows.src_row0} misses rows "
                             f"[{lo}, {hi}) that the band reads")
    if is_cpu(cur, "yadif_ring"):
        return yadif_ring_plain(prev, cur, next_, parity, tff, skip_spatial, opaque, rows)
    if rows is None:
        dev, c, h, w = _ring_args("yadif_ring", prev, cur, next_)
        rows = Rows.full(h)
    else:
        dev, (c, h, w) = cur.device, cur.shape
        for t, arg in ((prev, "prev"), (cur, "cur"), (next_, "next_")):
            check_window(t, f"yadif_ring {arg}", dev, (c, h, w))
        if not prev.stride(0) == cur.stride(0) == next_.stride(0):
            prev, cur, next_ = (t.contiguous() for t in (prev, cur, next_))
    par = torch.as_tensor(parity, dtype=torch.int32, device=dev).reshape(1)
    out = torch.empty((c, rows.n, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = library().phn_yadif_ring(
            prev.data_ptr(), cur.data_ptr(), next_.data_ptr(), par.data_ptr(), out.data_ptr(),
            c, rows.height, w, rows.row0, rows.n, rows.src_row0, h, prev.stride(0), cur.stride(0),
            next_.stride(0), int(tff), int(skip_spatial), int(opaque), stream_handle(dev),
        )
    check_launch(rc, "yadif_ring")
    launched(yadif_ring)
    return out


yadif_ring.launches = 0


def yadif_pair(prev, cur, next_, tff: bool, skip_spatial: bool = False,
               opaque: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Both parities of yadif over the ring in one launch ->
    (out_parity0, out_parity1), each equal to yadif_ring at that parity.
    The outputs are new tensors: they never alias a ring frame."""
    _check_ring("yadif_pair", prev, cur, next_)
    if is_cpu(cur, "yadif_pair"):
        return yadif_pair_plain(prev, cur, next_, tff, skip_spatial, opaque)
    dev, c, h, w = _ring_args("yadif_pair", prev, cur, next_)
    out0, out1 = torch.empty_like(cur), torch.empty_like(cur)
    with torch.cuda.device(dev):
        rc = library().phn_yadif_pair(
            prev.data_ptr(), cur.data_ptr(), next_.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            c, h, w, int(tff), int(skip_spatial), int(opaque), stream_handle(dev),
        )
    check_launch(rc, "yadif_pair")
    launched(yadif_pair)
    return out0, out1


yadif_pair.launches = 0
