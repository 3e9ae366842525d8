"""The plain reference of one channel tick: decode every source to
linear RGBA, stretch-fit an off-size clip, warp each DVE layer (its MIX
pair under one matrix), composite the layers 'over' each other bottom
to top, and pack into the channel's output format.

The maths is the CasparCG / phaneron model (io.ts, transform.ts,
resize.ts, combine.ts, transition.ts): codes through the 3x4 matrix,
gamma'->linear from the table at the 16-bit index rte(x * 65535), the
3x3 gamut; a bilinear warp sampling the input at (m @ (x / W - 0.5,
y / H - 0.5, 1) + 0.5) * size - 0.5 with transparent-black borders,
separable for an axis-aligned matrix (rows, then columns); premultiplied
'over'; linear->gamma' at the 16-bit index, the encode matrix, rte and
saturation.  An opaque v210 layer under DVE takes the warp of the
constant-1 plane as the outer product of its row and column weight sums.

``dtype`` sets the precision of every value (float32 is the reference;
torch.bfloat16 gives the benchmark's lower-precision control); texel
positions and indices stay float32.  TF32 plays no part: nothing here
multiplies matrices on the device.  Nothing here imports the program
under test.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import colour
from .formats import INFO, codes, pack_codes, rgba8_codes, v210_fields

__all__ = ["Source", "Layer", "channel_frame", "transform_matrix", "code_gap"]


class Source(NamedTuple):
    fmt: str
    planes: list
    width: int
    height: int


class Layer(NamedTuple):
    sources: tuple  # one Source, or two for a MIX (from, to)
    matrix: Optional[np.ndarray]  # (3, 3) float32 of MIXER FILL, None without DVE
    mix: Optional[float]  # the MIX weight of the first source


def transform_matrix(width: int, height: int, offset_x=0.0, offset_y=0.0, scale_x=1.0, scale_y=1.0,
                     rotate=0.0) -> np.ndarray:
    """The 3x3 output -> input matrix of a DVE (transform.ts:119-175),
    anchor (0, 0), no flip; ``rotate`` in turns."""
    a = width / height
    r = rotate * 2.0 * np.pi
    m = (np.array([[1.0 / (scale_x * a), 0, 0], [0, 1.0 / scale_y, 0], [0, 0, 1]])
         @ np.array([[np.cos(r), -np.sin(r), 0], [np.sin(r), np.cos(r), 0], [0, 0, 1]])
         @ np.array([[1, 0, offset_x * a], [0, 1, offset_y], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]])
         @ np.array([[a, 0, 0], [0, 1, 0], [0, 0, 1]]))
    return m.astype(np.float32)


def _u16_rte(x: torch.Tensor) -> torch.Tensor:
    """rte, then saturation to [0, 65535] (in float32: 65535 has no
    bfloat16 value)."""
    return torch.clamp(torch.round(x).float(), 0, 65535).to(torch.int32)


class _Colour:
    """The constants of one format and colour spec on a device, in ``dt``."""

    def __init__(self, fmt: str, spec: str, device, dt):
        info = INFO[fmt]
        self.dt = dt
        self.table = torch.from_numpy(colour.g2l_table(spec).copy()).to(device).to(dt)
        self.gamut = torch.from_numpy(colour.rgb2rgb(spec, spec)).to(device).to(dt)
        args = (spec, info.bits, info.black, info.white, info.chroma_range)
        self.dec = torch.from_numpy(colour.ycbcr2rgb(*args)).to(device).to(dt)
        self.enc = torch.from_numpy(colour.rgb2ycbcr(*args)).to(device).to(dt)
        self.l2g = colour.l2g_consts(spec)

    def g2l(self, x: torch.Tensor) -> torch.Tensor:
        return self.table[_u16_rte(x * 65535.0).long()]

    def gamut3(self, r, g, b) -> list:
        gm = self.gamut
        return [gm[i, 0] * r + gm[i, 1] * g + gm[i, 2] * b for i in range(3)]

    def l2g_of(self, x: torch.Tensor) -> torch.Tensor:
        inv_max, beta, delta, alpha, alpha_m1, gamma = self.l2g
        fi = _u16_rte(x * 65535.0).to(self.dt) * inv_max
        return torch.where(fi < beta, fi * delta, alpha * torch.pow(fi, gamma) - alpha_m1)


def decode(src: Source, spec: str, dt) -> torch.Tensor:
    """A source's planes -> linear RGBA (4, H, W) at its own size."""
    dev = src.planes[0].device
    c = _Colour(src.fmt, spec, dev, dt)
    if INFO[src.fmt].rgb:
        # index rte(code * 65535 / 255) == code * 257; alpha takes the transfer too
        v = c.table[(rgba8_codes(src.planes) * 257).long()]
        return torch.stack(c.gamut3(v[0], v[1], v[2]) + [v[3]])
    y, cb, cr = (t.to(dt) for t in codes(src.fmt, src.planes, src.width, src.height))
    m = c.dec
    r, g, b = (c.g2l(m[i, 0] * y + m[i, 1] * cb + m[i, 2] * cr + m[i, 3]) for i in range(3))
    return torch.stack(c.gamut3(r, g, b) + [torch.ones_like(r)])


def _coords(size: int, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device)
    return x / torch.full_like(x, float(size))


def _taps(pos: torch.Tensor, size: int):
    u = pos * size - 0.5
    i0 = torch.floor(u)
    return i0.to(torch.int64), u - i0


def _interp(src: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear interpolation of (C, H, W) along ``dim`` at normalized
    positions, border zero."""
    size = src.shape[dim]
    i0, frac = _taps(pos, size)
    shape = [1] * src.ndim
    shape[dim] = -1

    def tap(idx):
        valid = ((idx >= 0) & (idx < size)).to(src.dtype).reshape(shape)
        return torch.index_select(src, dim, torch.clamp(idx, 0, size - 1)) * valid

    f = frac.to(src.dtype).reshape(shape)
    return tap(i0) * (1.0 - f) + tap(i0 + 1) * f


def _weight_sum(pos: torch.Tensor, size: int, dt) -> torch.Tensor:
    p0, f = _taps(pos, size)
    f = f.to(dt)
    w0 = torch.where((p0 >= 0) & (p0 < size), 1.0 - f, torch.zeros_like(f))
    w1 = torch.where((p0 + 1 >= 0) & (p0 + 1 < size), f, torch.zeros_like(f))
    return w0 + w1


def _positions(mat: torch.Tensor, width: int, height: int) -> tuple:
    px = mat[0, 0] * (_coords(width, mat.device) - 0.5) + mat[0, 2] + 0.5
    py = mat[1, 1] * (_coords(height, mat.device) - 0.5) + mat[1, 2] + 0.5
    return px, py


def warp(frame: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bilinear warp: rows, then columns."""
    px, py = _positions(mat, frame.shape[-1], frame.shape[-2])
    return _interp(_interp(frame, py, 1), px, 2)


def resize(frame: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The stretch-fit of an off-size source (resize.ts, no scale, offset
    or flip): columns, then rows."""
    dev = frame.device
    one, zero, half = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (1.0, 0.0, 0.5))
    off = ((-half - zero) / one + 0.5) * one + zero
    px = _coords(width, dev) * (one / one) + off
    py = _coords(height, dev) * (one / one) + off
    return _interp(_interp(frame, px, 2), py, 1)


def _layer(layer: Layer, width: int, height: int, spec: str, dt) -> tuple:
    """(RGB (3, H, W), alpha (H, W)) of one layer at channel geometry."""
    frames = []
    for src in layer.sources:
        f = decode(src, spec, dt)
        if (src.width, src.height) != (width, height):
            f = resize(f, height, width)
        frames.append(f)
    dev = frames[0].device
    opaque_words = all(s.fmt == "v210" and (s.width, s.height) == (width, height) for s in layer.sources)
    mat = None if layer.matrix is None else torch.from_numpy(layer.matrix).to(dev)
    if mat is not None:
        frames = [warp(f, mat) for f in frames]
    if len(frames) == 2:
        mix = torch.tensor(np.float32(layer.mix), device=dev).to(dt)
        out = frames[0] * mix + frames[1] * (1.0 - mix)
    else:
        out = frames[0]
    alpha = out[3]
    if mat is not None and opaque_words:
        px, py = _positions(mat, width, height)
        alpha = _weight_sum(py, height, dt)[:, None] * _weight_sum(px, width, dt)[None, :]
    return out[:3], alpha


def channel_frame(layers: list, out_fmt: str, width: int, height: int, spec: str = "709",
                  dt=torch.float32) -> list:
    """One tick's packed output planes."""
    rgb, _ = _layer(layers[0], width, height, spec, dt)
    for layer in layers[1:]:
        top, a = _layer(layer, width, height, spec, dt)
        rgb = rgb * (1.0 - a)[None] + top
    c = _Colour(out_fmt, spec, rgb.device, dt)
    rp, gp, bp = (c.l2g_of(rgb[i]) for i in range(3))
    m = c.enc
    y, cb, cr = (_u16_rte(m[i, 0] * rp + m[i, 1] * gp + m[i, 2] * bp + m[i, 3]) for i in range(3))
    return pack_codes(out_fmt, y, cb, cr, width)


def code_gap(fmt: str, planes: list, ref: list, width: int) -> int:
    """The largest difference between two packings' codes: v210's stored
    10-bit fields, or the planar formats' samples."""
    if fmt == "v210":
        pairs = zip(v210_fields(planes[0], width), v210_fields(ref[0], width))
    else:
        pairs = zip(planes, ref)
    return max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max()) for a, b in pairs)
