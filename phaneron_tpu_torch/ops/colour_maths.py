"""Colour science: colourimetry tables, gamma LUTs and colour matrices.

Capability parity with the reference's pure-math module
(src/process/colourMaths.ts:42-394): five colour
specifications (BT.601-625, BT.601-525, BT.709, BT.2020, sRGB), the
ITU-R transfer-function LUTs (2^16 entries), the bit-depth-scaled
YCbCr<->R'G'B' 3x4 matrices and the CIE-XYZ white-point-scaled
R'G'B'<->R'G'B' gamut matrices.

Numerical discipline: the reference stores every intermediate matrix row
in a Float32Array while accumulating dot products in double precision
(JS numbers).  We reproduce that exactly — float64 accumulation,
float32 storage after every matrix product — so matrix entries are
bit-identical to the reference and packed 8/10-bit outputs round-trip
bit-exactly.

All functions here are host-side (numpy); results are copied to the
device once, or passed to the kernels as launch arguments.  This module
is the JAX package's ops/colour_maths.py unchanged, so both packages
build bit-identical tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = [
    "COLOUR_SPECS",
    "ColourSpec",
    "gamma2linear_lut",
    "linear2gamma_lut",
    "ycbcr2rgb_matrix",
    "rgb2ycbcr_matrix",
    "rgb2rgb_matrix",
    "LUT_ENTRIES",
]

LUT_ENTRIES = 2**16


@dataclass(frozen=True)
class ColourSpec:
    """ITU colourimetry parameters for one colour specification."""

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

    @property
    def kG(self) -> float:
        return 1.0 - self.kR - self.kB


# Parameter values from the ITU recommendations cited in the reference
# (colourMaths.ts:42-128): BT.601-7 (625/525 line), BT.709-6, BT.2020-2,
# and IEC sRGB.
COLOUR_SPECS: dict[str, ColourSpec] = {
    "601-625": ColourSpec(
        kR=0.299, kB=0.114,
        rx=0.64, ry=0.33, gx=0.29, gy=0.60, bx=0.15, by=0.06,
        wx=0.3127, wy=0.329,
        alpha=1.099, beta=0.018, gamma=0.45, delta=4.5,
    ),
    "601_525": ColourSpec(
        kR=0.299, kB=0.114,
        rx=0.63, ry=0.34, gx=0.31, gy=0.595, bx=0.155, by=0.07,
        wx=0.3127, wy=0.329,
        alpha=1.099, beta=0.018, gamma=0.45, delta=4.5,
    ),
    "709": ColourSpec(
        kR=0.2126, kB=0.0722,
        rx=0.64, ry=0.33, gx=0.30, gy=0.60, bx=0.15, by=0.06,
        wx=0.3127, wy=0.329,
        alpha=1.099, beta=0.018, gamma=0.45, delta=4.5,
    ),
    "2020": ColourSpec(
        kR=0.2627, kB=0.0593,
        rx=0.708, ry=0.292, gx=0.17, gy=0.797, bx=0.131, by=0.046,
        wx=0.3127, wy=0.329,
        alpha=1.099, beta=0.018, gamma=0.45, delta=4.5,
    ),
    "sRGB": ColourSpec(
        kR=0.0, kB=0.0,
        rx=0.64, ry=0.33, gx=0.30, gy=0.60, bx=0.15, by=0.06,
        wx=0.3127, wy=0.329,
        alpha=1.055, beta=0.0031308, gamma=1.0 / 2.4, delta=12.92,
    ),
}


def _spec(col_spec: str) -> ColourSpec:
    if col_spec not in COLOUR_SPECS:
        # The reference warns and falls back to BT.709 (colourMaths.ts:131-133).
        col_spec = "709"
    return COLOUR_SPECS[col_spec]


@lru_cache(maxsize=None)
def gamma2linear_lut(col_spec: str) -> np.ndarray:
    """2^16-entry gamma -> linear LUT, float32 (colourMaths.ts:130-149)."""
    p = _spec(col_spec)
    alpha, delta, gamma = p.alpha, p.delta, p.gamma
    beta = p.beta * delta
    fi = np.arange(LUT_ENTRIES, dtype=np.float64) / (LUT_ENTRIES - 1)
    lo = fi / delta
    hi = ((fi + (alpha - 1.0)) / alpha) ** (1.0 / gamma)
    lut = np.where(fi < beta, lo, hi)
    return lut.astype(np.float32)


@lru_cache(maxsize=None)
def linear2gamma_lut(col_spec: str) -> np.ndarray:
    """2^16-entry linear -> gamma LUT, float32 (colourMaths.ts:151-169)."""
    p = _spec(col_spec)
    alpha, beta, gamma, delta = p.alpha, p.beta, p.gamma, p.delta
    fi = np.arange(LUT_ENTRIES, dtype=np.float64) / (LUT_ENTRIES - 1)
    lo = fi * delta
    hi = alpha * fi**gamma - (alpha - 1.0)
    lut = np.where(fi < beta, lo, hi)
    return lut.astype(np.float32)


def _f32(rows: list[list[float]]) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32)


def _matmul_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product with float64 accumulation, float32 storage.

    Mirrors the reference's matrixMultiply (colourMaths.ts:171-178):
    JS accumulates in doubles, the result row is a Float32Array.
    """
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _invert3x3_f32(a: np.ndarray) -> np.ndarray:
    """3x3 inverse via minors/cofactors/adjugate with f32 intermediate
    storage, as the reference does (colourMaths.ts:199-238)."""
    a64 = a.astype(np.float64)
    minors = np.empty((3, 3), dtype=np.float64)
    for i in range(3):
        for j in range(3):
            ys = [i - 1, i + 1] if i == 1 else [(i + 1) % 3, (i + 2) % 3]
            xs = [j - 1, j + 1] if j == 1 else [(j + 1) % 3, (j + 2) % 3]
            m = a64[np.ix_(ys, xs)]
            minors[i, j] = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    minors32 = minors.astype(np.float32)
    signs = np.array([[1, -1, 1], [-1, 1, -1], [1, -1, 1]], dtype=np.float64)
    cofactors = (minors32.astype(np.float64) * signs).astype(np.float32)
    adjugate = cofactors.T.astype(np.float32)
    m64 = minors32.astype(np.float64)
    det = a64[0, 0] * m64[0, 0] - a64[0, 1] * m64[0, 1] + a64[0, 2] * m64[0, 2]
    return (adjugate.astype(np.float64) * (1.0 / det)).astype(np.float32)


@lru_cache(maxsize=None)
def _rgb2xyz_matrix(col_spec: str) -> _Hashable32:
    """RGB -> CIE XYZ from primaries + white point (colourMaths.ts:240-266)."""
    p = _spec(col_spec)
    w = _f32([[p.wx], [p.wy], [1.0 - p.wx - p.wy]])
    W = (w.astype(np.float64) * (1.0 / np.float64(w[1, 0]))).astype(np.float32)

    xyz = _f32(
        [
            [p.rx, p.gx, p.bx],
            [p.ry, p.gy, p.by],
            [1.0 - p.rx - p.ry, 1.0 - p.gx - p.gy, 1.0 - p.bx - p.by],
        ]
    )
    scale_factors = _matmul_f32(_invert3x3_f32(xyz), W)
    xyz_scale = np.zeros((3, 3), dtype=np.float32)
    for i in range(3):
        xyz_scale[i, i] = scale_factors[i, 0]
    return _Hashable32(_matmul_f32(xyz, xyz_scale))


class _Hashable32:
    """Tiny wrapper so lru_cache can hold ndarray results."""

    __slots__ = ("a",)

    def __init__(self, a: np.ndarray):
        self.a = a


def rgb2rgb_matrix(src_col_spec: str, dst_col_spec: str) -> np.ndarray:
    """3x3 gamut conversion src RGB -> dst RGB via XYZ
    (colourMaths.ts:392-394)."""
    src = _rgb2xyz_matrix(src_col_spec).a
    dst = _invert3x3_f32(_rgb2xyz_matrix(dst_col_spec).a)
    return _matmul_f32(dst, src)


def ycbcr2rgb_matrix(
    col_spec: str,
    num_bits: int,
    luma_black: int,
    luma_white: int,
    chroma_range: int,
) -> np.ndarray:
    """3x4 matrix mapping integer (Y, Cb, Cr, 1) codes to R'G'B' in [0,1].

    Column 3 carries the offsets; apply as mat @ [Y, U, V, 1]
    (colourMaths.ts:276-332).
    """
    p = _spec(col_spec)
    chr_null = float(128 << (num_bits - 8))
    luma_range = float(luma_white - luma_black)
    kR, kB, kG = p.kR, p.kB, p.kG

    col_matrix = _f32(
        [
            [1.0, 0.0, 1.0 - kR],
            [1.0, (-(1.0 - kB) * kB) / kG, (-(1.0 - kR) * kR) / kG],
            [1.0, 1.0 - kB, 0.0],
        ]
    )
    scale_matrix = _f32(
        [
            [1.0 / luma_range, 0.0, 0.0, -luma_black / luma_range],
            [0.0, 2.0 / chroma_range, 0.0, -(chr_null / chroma_range) * 2.0],
            [0.0, 0.0, 2.0 / chroma_range, -(chr_null / chroma_range) * 2.0],
        ]
    )
    return _matmul_f32(col_matrix, scale_matrix)


def rgb2ycbcr_matrix(
    col_spec: str,
    num_bits: int,
    luma_black: int,
    luma_white: int,
    chroma_range: int,
) -> np.ndarray:
    """3x4 matrix mapping (R', G', B', 1) in [0,1] to integer Y/Cb/Cr codes
    (colourMaths.ts:334-390)."""
    p = _spec(col_spec)
    chr_null = float(128 << (num_bits - 8))
    luma_range = float(luma_white - luma_black)
    kR, kB, kG = p.kR, p.kB, p.kG

    scale_matrix = _f32(
        [
            [luma_range, 0.0, 0.0],
            [0.0, chroma_range / 2.0, 0.0],
            [0.0, 0.0, chroma_range / 2.0],
        ]
    )
    col_matrix = _f32(
        [
            [kR, kG, kB, luma_black / luma_range],
            [-kR / (1.0 - kB), -kG / (1.0 - kB), 1.0, (chr_null / chroma_range) * 2.0],
            [1.0, -kG / (1.0 - kR), -kB / (1.0 - kR), (chr_null / chroma_range) * 2.0],
        ]
    )
    return _matmul_f32(scale_matrix, col_matrix)
