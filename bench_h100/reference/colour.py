"""Colour constants of the plain reference: the 3x4 YCbCr <-> R'G'B'
matrices, the 3x3 gamut matrix, and the transfer functions at a 16-bit
index.

A frozen copy of the plain maths the CasparCG / phaneron colour model
defines (colourMaths.ts:130-394): every matrix row is stored in float32
after a float64 product, gamma'->linear is a table over the 65536
indices whose power term is the C library's float32 ``powf``, and
linear->gamma' is the float32 formula at the index.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = ["SPECS", "ycbcr2rgb", "rgb2ycbcr", "rgb2rgb", "g2l_table", "l2g_consts"]

LUT_ENTRIES = 2**16


@dataclass(frozen=True)
class Spec:
    kR: float
    kB: float
    rx: float
    ry: float
    gx: float
    gy: float
    bx: float
    by: float
    wx: float
    wy: float
    alpha: float
    beta: float
    gamma: float
    delta: float


# ITU-R BT.709-6 (the configurations' colour spec) and BT.2020-2
SPECS = {
    "709": Spec(0.2126, 0.0722, 0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.329,
                1.099, 0.018, 0.45, 4.5),
    "2020": Spec(0.2627, 0.0593, 0.708, 0.292, 0.17, 0.797, 0.131, 0.046, 0.3127, 0.329,
                 1.099, 0.018, 0.45, 4.5),
}


def _f32(rows) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32)


def _mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float64 accumulation, float32 storage."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _inv3(a: np.ndarray) -> np.ndarray:
    """3x3 inverse by minors and adjugate with float32 storage between steps."""
    a64 = a.astype(np.float64)
    minors = np.empty((3, 3), dtype=np.float64)
    for i in range(3):
        for j in range(3):
            ys = [i - 1, i + 1] if i == 1 else [(i + 1) % 3, (i + 2) % 3]
            xs = [j - 1, j + 1] if j == 1 else [(j + 1) % 3, (j + 2) % 3]
            m = a64[np.ix_(ys, xs)]
            minors[i, j] = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    m32 = minors.astype(np.float32)
    signs = np.array([[1, -1, 1], [-1, 1, -1], [1, -1, 1]], dtype=np.float64)
    adj = (m32.astype(np.float64) * signs).astype(np.float32).T.astype(np.float32)
    m64 = m32.astype(np.float64)
    det = a64[0, 0] * m64[0, 0] - a64[0, 1] * m64[0, 1] + a64[0, 2] * m64[0, 2]
    return (adj.astype(np.float64) * (1.0 / det)).astype(np.float32)


def _rgb2xyz(spec: str) -> np.ndarray:
    p = SPECS[spec]
    w = _f32([[p.wx], [p.wy], [1.0 - p.wx - p.wy]])
    white = (w.astype(np.float64) * (1.0 / np.float64(w[1, 0]))).astype(np.float32)
    xyz = _f32([[p.rx, p.gx, p.bx], [p.ry, p.gy, p.by],
                [1.0 - p.rx - p.ry, 1.0 - p.gx - p.gy, 1.0 - p.bx - p.by]])
    scale = _mm(_inv3(xyz), white)
    return _mm(xyz, np.diag(scale[:, 0]).astype(np.float32))


def rgb2rgb(src: str, dst: str) -> np.ndarray:
    """(3, 3) linear gamut matrix src -> dst."""
    return _mm(_inv3(_rgb2xyz(dst)), _rgb2xyz(src))


def ycbcr2rgb(spec: str, bits: int, black: int, white: int, chroma_range: int) -> np.ndarray:
    """(3, 4) matrix from integer (Y, Cb, Cr, 1) codes to R'G'B'."""
    p = SPECS[spec]
    null = float(128 << (bits - 8))
    luma = float(white - black)
    kG = 1.0 - p.kR - p.kB
    col = _f32([[1.0, 0.0, 1.0 - p.kR],
                [1.0, (-(1.0 - p.kB) * p.kB) / kG, (-(1.0 - p.kR) * p.kR) / kG],
                [1.0, 1.0 - p.kB, 0.0]])
    scale = _f32([[1.0 / luma, 0.0, 0.0, -black / luma],
                  [0.0, 2.0 / chroma_range, 0.0, -(null / chroma_range) * 2.0],
                  [0.0, 0.0, 2.0 / chroma_range, -(null / chroma_range) * 2.0]])
    return _mm(col, scale)


def rgb2ycbcr(spec: str, bits: int, black: int, white: int, chroma_range: int) -> np.ndarray:
    """(3, 4) matrix from (R', G', B', 1) to integer Y, Cb, Cr codes."""
    p = SPECS[spec]
    null = float(128 << (bits - 8))
    luma = float(white - black)
    kG = 1.0 - p.kR - p.kB
    scale = _f32([[luma, 0.0, 0.0], [0.0, chroma_range / 2.0, 0.0], [0.0, 0.0, chroma_range / 2.0]])
    col = _f32([[p.kR, kG, p.kB, black / luma],
                [-p.kR / (1.0 - p.kB), -kG / (1.0 - p.kB), 1.0, (null / chroma_range) * 2.0],
                [1.0, -kG / (1.0 - p.kR), -p.kB / (1.0 - p.kR), (null / chroma_range) * 2.0]])
    return _mm(scale, col)


@lru_cache(maxsize=None)
def g2l_table(spec: str) -> np.ndarray:
    """gamma'->linear at each of the 65536 indices, float32: idx / 65535
    over delta below beta * delta, else ((fi + alpha - 1) / alpha) **
    (1 / gamma), the power by the C library's powf."""
    p = SPECS[spec]
    fi = np.arange(LUT_ENTRIES, dtype=np.float32) * np.float32(1.0 / (LUT_ENTRIES - 1))
    lo = fi * np.float32(1.0 / p.delta)
    base = (fi + np.float32(p.alpha - 1.0)) * np.float32(1.0 / p.alpha)
    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.restype = ctypes.c_float
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    e = float(np.float32(1.0 / p.gamma))
    hi = np.array([powf(b, e) for b in base.tolist()], dtype=np.float32)
    table = np.where(fi < np.float32(p.beta * p.delta), lo, hi).astype(np.float32)
    table.setflags(write=False)
    return table


def l2g_consts(spec: str) -> tuple:
    """(1 / 65535, beta, delta, alpha, alpha - 1, gamma) as float32 values."""
    p = SPECS[spec]
    return tuple(float(np.float32(v)) for v in
                 (1.0 / (LUT_ENTRIES - 1), p.beta, p.delta, p.alpha, p.alpha - 1.0, p.gamma))
