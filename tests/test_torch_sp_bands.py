"""The band forms of the four kernels on a row-sharded channel's path
(K4 warp, B6 packed_warp, K5 packed_composite, B9 yadif_ring), their
plain versions on the CPU: each band, computed from the window of rows
its taps reach and nothing else, equals those rows of the full-frame
call, max |delta| 0.  The shapes break halos: 96x72 at sp 2, 3, 4, 8 and 9
(bands of 36, 24, 18, 9 and 8 rows: odd band starts at sp 8), and every
band of 1x1 to 13x7 frames; the matrices are the UHD dry run's, a flip,
a minifying 0.25 box (B6's and K5's direct branch on the card) and an
offset past the frame's edge.  The channel-level windows
(graph/pipeline.py band_windows) hold every tap the bands read."""

import numpy as np
import pytest
import torch

from phaneron_tpu_torch.graph.pipeline import _warp_rows
from phaneron_tpu_torch.ops import packed_warp as PW
from phaneron_tpu_torch.ops import warp as warp_mod
from phaneron_tpu_torch.ops import yadif as Y
from phaneron_tpu_torch.ops.formats import v210
from phaneron_tpu_torch.ops.geometry import transform_matrix
from phaneron_tpu_torch.ops.kernels import Rows
from phaneron_tpu_torch.parallel.mesh import band_bounds

torch.set_num_threads(1)

SIZES = [(96, 72, sp) for sp in (2, 3, 4, 8, 9)] + [
    (w, h, sp) for w, h in ((1, 1), (2, 3), (5, 2), (7, 5), (13, 7)) for sp in (2, 3) if sp <= h]
MATS = {
    "dry run": dict(scale_x=1.2, scale_y=1.3, offset_y=0.05),
    "flip": dict(flip_h=True, flip_v=True, scale_x=0.9, scale_y=0.95),
    "box 0.25": dict(scale_x=0.25, scale_y=0.25, offset_x=0.1, offset_y=-0.2),
    "past the edge": dict(offset_x=0.3, offset_y=1.3),
}
MIX = torch.tensor(0.37)


def _mat(w, h, name):
    return torch.from_numpy(transform_matrix(w, h, **MATS[name]))


def _bands(h, sp):
    return [(r0, r1) for r0, r1 in band_bounds(h, sp) if r1 > r0]


def _window(mats, r0, r1, w, h):
    return _warp_rows([m.numpy() for m in mats], [(r0, r1)], w, h)[0]


def _words(rng, w, h):
    return torch.from_numpy(rng.integers(0, 2 ** 32, (h, v210.pitch(w) // 6 * 4), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("w, h, sp", SIZES)
@pytest.mark.parametrize("channels", [3, 4])
def test_warp_bands(w, h, sp, channels):
    """K4: single, dissolve and wipe pairs, one matrix or two."""
    rng = np.random.default_rng(w * 100 + h * 10 + sp)
    a, b = (torch.from_numpy(rng.random((channels, h, w), dtype=np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.random((h, w), dtype=np.float32))
    for name in MATS:
        m, mb = _mat(w, h, name), _mat(w, h, "dry run")
        cases = {"single": ((a, m), {}), "dissolve": ((a, m, b, MIX), {}),
                 "dissolve two matrices": ((a, m, b, MIX, mb), {}),
                 "wipe": ((a, m, b), dict(mask=mask)), "wipe two matrices": ((a, m, b), dict(mat_b=mb, mask=mask))}
        for case, (args, kw) in cases.items():
            full = warp_mod.warp(*args, **kw)
            mats = [m] + ([mb] if len(args) > 4 or "mat_b" in kw else [])
            for r0, r1 in _bands(h, sp):
                lo, hi = _window(mats, r0, r1, w, h)
                bargs = (args[0][:, lo:hi], args[1]) + ((args[2][:, lo:hi],) + args[3:] if len(args) > 2 else ())
                bkw = dict(kw, mask=kw["mask"][r0:r1]) if "mask" in kw else kw
                got = warp_mod.warp(*bargs, **bkw, rows=Rows(r0, r1, h, lo))
                assert torch.equal(got, full[:, r0:r1]), (name, case, r0, r1)


@pytest.mark.parametrize("w, h, sp", SIZES)
def test_packed_warp_bands(w, h, sp):
    """B6: single, shared-matrix and distinct-matrix pairs over v210 words."""
    rng = np.random.default_rng(7 + w * 100 + h * 10 + sp)
    a, b = _words(rng, w, h), _words(rng, w, h)
    for name in MATS:
        m, mb = _mat(w, h, name), _mat(w, h, "flip")
        for args in ((a, m, w, h), (a, m, w, h, b, MIX), (a, m, w, h, b, MIX, mb)):
            full = PW.packed_warp(*args)
            mats = [m] + ([mb] if len(args) > 6 else [])
            for r0, r1 in _bands(h, sp):
                lo, hi = _window(mats, r0, r1, w, h)
                bargs = (args[0][lo:hi],) + args[1:4] + ((args[4][lo:hi],) + args[5:] if len(args) > 4 else ())
                got = PW.packed_warp(*bargs, rows=Rows(r0, r1, h, lo))
                assert torch.equal(got, full[:, r0:r1]), (name, len(args), r0, r1)


@pytest.mark.parametrize("w, h, sp", SIZES)
@pytest.mark.parametrize("kind", ["packed", "rgb3", "rgba"])
def test_packed_composite_bands(w, h, sp, kind):
    """K5 over words, rgb3 and rgba frames: a dissolve, a cut and a
    dissolve, each layer under its own matrix, so each source has its own
    window; emits packed, both and rgba, coverage and top alpha."""
    rng = np.random.default_rng(11 + w * 100 + h * 10 + sp)
    if kind == "packed":
        srcs = [_words(rng, w, h) for _ in range(5)]
    else:
        srcs = [torch.from_numpy(rng.random((3 if kind == "rgb3" else 4, h, w), dtype=np.float32))
                for _ in range(5)]
    cfg, layer_of = (2, 1, 2), (0, 0, 1, 2, 2)
    mats = [_mat(w, h, "dry run"), _mat(w, h, "box 0.25"), _mat(w, h, "past the edge")]
    mixes = [MIX, None, torch.tensor(0.8)]
    for emit, alpha in (("packed", "top"), ("both", "top"), ("rgba", "coverage"), ("rgba", "top")):
        full = PW.packed_composite(srcs, cfg, mats, mixes, src_kind=kind, size=(w, h), emit=emit, alpha=alpha)
        full = full if isinstance(full, tuple) else (full,)
        for r0, r1 in _bands(h, sp):
            wins = [_window([mats[li]], r0, r1, w, h) for li in layer_of]
            cut = [s[lo:hi] if kind == "packed" else s[:, lo:hi] for s, (lo, hi) in zip(srcs, wins)]
            got = PW.packed_composite(cut, cfg, mats, mixes, src_kind=kind, size=(w, h), emit=emit, alpha=alpha,
                                      rows=Rows(r0, r1, h, tuple(lo for lo, _ in wins)))
            got = got if isinstance(got, tuple) else (got,)
            for f, g in zip(full, got):
                assert torch.equal(g, f[r0:r1] if f.dtype == torch.int32 else f[:, r0:r1]), (emit, alpha, r0, r1)


@pytest.mark.parametrize("w, h, sp", SIZES)
@pytest.mark.parametrize("channels, opaque", [(3, False), (4, False), (4, True)])
def test_yadif_ring_bands(w, h, sp, channels, opaque):
    """B9: tff and bff, both parities, with and without skip_spatial; a
    band's parity is its frame rows' and the clamp the frame's."""
    rng = np.random.default_rng(13 + w * 100 + h * 10 + sp)
    ring = [torch.from_numpy(rng.random((channels, h, w), dtype=np.float32)) for _ in range(3)]
    for tff in (True, False):
        for parity in (0, 1):
            for skip in (False, True):
                full = Y.yadif_ring(*ring, parity, tff, skip, opaque)
                for r0, r1 in _bands(h, sp):
                    lo, hi = Y.ring_window(r0, r1, h)
                    got = Y.yadif_ring(*(f[:, lo:hi] for f in ring), torch.tensor(parity, dtype=torch.int32),
                                       tff, skip, opaque, rows=Rows(r0, r1, h, lo))
                    assert torch.equal(got, full[:, r0:r1]), (tff, parity, skip, r0, r1)


def test_band_windows_hold_every_tap():
    """_warp_rows (band_windows' DVE window) holds the row of every valid
    tap (row and column inside the frame) of its band's output rows under
    200 seeded axis-aligned matrices."""
    rng = np.random.default_rng(5)
    w, h = 96, 72
    for _ in range(200):
        m = transform_matrix(w, h, flip_v=bool(rng.integers(2)), scale_x=float(rng.uniform(0.2, 2)),
                             scale_y=float(rng.uniform(0.2, 2)), offset_x=float(rng.uniform(-1, 1)),
                             offset_y=float(rng.uniform(-1.5, 1.5)))
        r0 = int(rng.integers(0, h - 1))
        r1 = int(rng.integers(r0 + 1, h + 1))
        lo, hi = _warp_rows([m], [(r0, r1)], w, h)[0]
        y = torch.arange(r0, r1, dtype=torch.float32)
        py = (torch.tensor(m[1, 1]) * (y / torch.full_like(y, float(h)) - 0.5) + torch.tensor(m[1, 2]) + 0.5) * h - 0.5
        x = torch.arange(w, dtype=torch.float32)
        px = (torch.tensor(m[0, 0]) * (x / torch.full_like(x, float(w)) - 0.5) + torch.tensor(m[0, 2]) + 0.5) * w - 0.5
        cols = torch.cat([torch.floor(px), torch.floor(px) + 1])
        taps = torch.cat([torch.floor(py), torch.floor(py) + 1]).to(torch.int64)
        taps = taps[(taps >= 0) & (taps < h)]
        if taps.numel() and bool(((cols >= 0) & (cols < w)).any()):
            assert lo <= int(taps.min()) and int(taps.max()) < hi, (m, r0, r1, lo, hi)


def test_band_forms_refuse_windows_outside_the_frame():
    """Rows.check: a band or window that leaves the frame raises."""
    a = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError):
        warp_mod.warp(a, torch.eye(3), rows=Rows(0, 4, 10, 5))  # window rows 5..12 of a 10-row frame
    with pytest.raises(ValueError):
        Y.yadif_ring(a, a, a, 0, True, rows=Rows(4, 8, 8, 3))  # misses row 2, which row 4 reads
