"""v210: 10-bit 4:2:2 YCbCr packed, 6 pixels per four 32-bit words.

Counterpart of phaneron_tpu/ops/formats/v210.py, with the bit layout of
the reference's v210 kernels (v210.ts:24-195):

word 0: [Cr0 | Y0 | Cb0]   (bits 29-20 | 19-10 | 9-0)
word 1: [Y2  | Cb1 | Y1 ]
word 2: [Cb2 | Y3  | Cr1]
word 3: [Y5  | Cr2 | Y4 ]

Lines are padded to a 48-pixel pitch (v210.ts:198-204); pad words are
zero.  Every pixel, tail pixels included, takes the same arithmetic, so
the round trip is bit-exact at every width.

Words are carried as int32 tensors holding the uint32 bit pattern
(``np.uint32`` arrays convert with ``.view(np.int32)``): torch's uint32
lacks shifts on most backends.  Every right shift is masked, so the
sign extension of a word with bit 31 set never reaches a field.  The
host-side helpers (``fill_buf``, ``black_buf``, ``from_bytes``) return
numpy uint32 arrays, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import FormatInfo, pad_axis1, upsample_422

INFO = FormatInfo(
    name="v210",
    num_bits=10,
    luma_black=64,
    luma_white=940,
    chroma_range=896,
    is_rgb=False,
    sub_x=2,
    sub_y=1,
)

_MASK = 0x3FF


def pitch(width: int) -> int:
    """Line pitch in pixels, rounded up to 48 (v210.ts:198-200)."""
    return width + 47 - ((width - 1) % 48)


def pitch_bytes(width: int) -> int:
    return (pitch(width) * 8) // 3


def num_bytes(width: int, height: int) -> list[int]:
    return [pitch_bytes(width) * height]


def plane_shapes(width: int, height: int) -> list[tuple[tuple[int, int], np.dtype]]:
    return [((height, pitch_bytes(width) // 4), np.dtype(np.uint32))]


def from_bytes(data: bytes | np.ndarray, width: int, height: int) -> list[np.ndarray]:
    """Host bytes -> the uint32 word array (H, pitch_bytes/4)."""
    arr = np.frombuffer(data, dtype=np.uint32) if not isinstance(data, np.ndarray) else data
    return [arr.reshape(height, pitch_bytes(width) // 4)]


def unpack_codes(
    planes: list[torch.Tensor], width: int, height: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int32 words (H, pitch/6*4) -> full-res (Y, Cb, Cr) int32 planes."""
    words = planes[0]
    h = words.shape[0]
    groups = words.reshape(h, -1, 4)
    w0, w1, w2, w3 = groups[..., 0], groups[..., 1], groups[..., 2], groups[..., 3]

    y = torch.stack([w0 >> 10, w1, w1 >> 20, w2 >> 10, w3, w3 >> 20], dim=-1) & _MASK
    cb = torch.stack([w0, w1 >> 10, w2 >> 20], dim=-1) & _MASK
    cr = torch.stack([w0 >> 20, w2, w3 >> 10], dim=-1) & _MASK

    y = y.reshape(h, -1)[:, :width]
    n_chroma = (width + 1) // 2
    cb = cb.reshape(h, -1)[:, :n_chroma]
    cr = cr.reshape(h, -1)[:, :n_chroma]
    return y, upsample_422(cb, width), upsample_422(cr, width)


def pack_codes(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, width: int, height: int
) -> list[torch.Tensor]:
    """Full-res (Y, Cb, Cr) int32 code planes -> int32 word plane.

    Chroma is subsampled from even pixels (v210.ts:158-162).  Codes are
    masked to 10 bits; pitch padding packs as zero words.  Fields reach
    bit 29 at most, so the words never overflow int32.
    """
    p = pitch(width)
    h = y.shape[0]
    yg = pad_axis1(y & _MASK, p).reshape(h, -1, 6)
    cbg = pad_axis1(cb[:, 0::2] & _MASK, p // 2).reshape(h, -1, 3)
    crg = pad_axis1(cr[:, 0::2] & _MASK, p // 2).reshape(h, -1, 3)

    w0 = (crg[..., 0] << 20) | (yg[..., 0] << 10) | cbg[..., 0]
    w1 = (yg[..., 2] << 20) | (cbg[..., 1] << 10) | yg[..., 1]
    w2 = (cbg[..., 2] << 20) | (yg[..., 3] << 10) | crg[..., 1]
    w3 = (yg[..., 5] << 20) | (crg[..., 2] << 10) | yg[..., 4]
    return [torch.stack([w0, w1, w2, w3], dim=-1).reshape(h, -1).to(torch.int32)]


def _pack_groups_np(yp: np.ndarray, cbp: np.ndarray, crp: np.ndarray) -> np.ndarray:
    height = yp.shape[0]
    yg = yp.reshape(height, -1, 6)
    cbg = cbp.reshape(height, -1, 3)
    crg = crp.reshape(height, -1, 3)
    w0 = (crg[..., 0] << 20) | (yg[..., 0] << 10) | cbg[..., 0]
    w1 = (yg[..., 2] << 20) | (cbg[..., 1] << 10) | yg[..., 1]
    w2 = (cbg[..., 2] << 20) | (yg[..., 3] << 10) | crg[..., 1]
    w3 = (yg[..., 5] << 20) | (crg[..., 2] << 10) | yg[..., 4]
    return np.stack([w0, w1, w2, w3], axis=-1).reshape(height, -1)


def black_buf(width: int, height: int) -> list[np.ndarray]:
    """True-black v210 words (Y=64, Cb=Cr=512 in every sample slot; zero
    pitch-pad words): all-zero words would decode sub-black with extreme
    chroma, and pacing frames must be black (blackSilence.ts)."""
    p = pitch(width)
    yp = np.zeros((height, p), dtype=np.uint32)
    yp[:, :width] = 64
    cp = np.zeros((height, p // 2), dtype=np.uint32)
    cp[:, : (width + 1) // 2] = 512
    return [_pack_groups_np(yp, cp, cp)]


def fill_buf(width: int, height: int) -> list[np.ndarray]:
    """Deterministic synthetic ramp, byte-identical to the reference's
    fillBuf (v210.ts:206-236): Y ramps 64..940 per 6-pixel group across
    lines, Cb=Cr=512, zero pitch padding."""
    words_per_line = pitch_bytes(width) // 4
    buf = np.zeros((height, words_per_line), dtype=np.uint32)
    cb = cr = 512
    y_counter = 0
    full_groups = (width - (width % 6)) // 6
    remain = width % 6
    for line in range(height):
        ys = (64 + ((y_counter + np.arange(full_groups)) % 877)).astype(np.uint32)
        y_counter += full_groups
        w = np.zeros((full_groups, 4), dtype=np.uint32)
        w[:, 0] = (cr << 20) | (ys << 10) | cb
        w[:, 1] = (ys << 20) | (cb << 10) | ys
        w[:, 2] = (cb << 20) | (ys << 10) | cr
        w[:, 3] = (ys << 20) | (cr << 10) | ys
        buf[line, : full_groups * 4] = w.reshape(-1)
        if remain:
            yv = 64 + (y_counter % 877)
            off = full_groups * 4
            buf[line, off] = (cr << 20) | (yv << 10) | cb
            if remain == 2:
                buf[line, off + 1] = yv
            elif remain == 4:
                buf[line, off + 1] = (yv << 20) | (cb << 10) | yv
                buf[line, off + 2] = (yv << 10) | cr
    return [buf]
