"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
the same numpy inputs go through a JAX function on the CPU and its
counterpart in phaneron_tpu_torch, and the results are compared under a
stated contract."""

from __future__ import annotations

import numpy as np
import torch

from phaneron_tpu_torch.ops.formats import v210 as tv210


def words_to_planes(words: np.ndarray) -> np.ndarray:
    """(H, G*4) uint32 words -> (4, H, G) word planes, the host-split form
    the JAX batched unpack kernel takes."""
    h = words.shape[0]
    return np.ascontiguousarray(words.reshape(h, -1, 4).transpose(2, 0, 1))


def random_words(rng: np.random.Generator, width: int, height: int) -> np.ndarray:
    """uint32 words over the full 32-bit range: every 10-bit field takes
    every code, and bits 30-31 are set at random."""
    return rng.integers(0, 2**32, size=(height, tv210.pitch_bytes(width) // 4), dtype=np.uint32)


def v210_codes(words: np.ndarray, width: int, height: int) -> list[np.ndarray]:
    t = torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32))
    return [c.numpy().astype(np.int64) for c in tv210.unpack_codes([t], width, height)]


def max_code_delta(a: np.ndarray, b: np.ndarray, width: int, height: int) -> int:
    """Largest difference of any Y/Cb/Cr field between two v210 frames."""
    return max(
        int(np.abs(x - y).max())
        for x, y in zip(v210_codes(a, width, height), v210_codes(b, width, height))
    )


def graphic_rgba8(width: int, height: int) -> np.ndarray:
    """(H, W, 4) rgba8 keyed lower third, premultiplied (chip_smoke.py
    graphic_rgba8): alpha 255 in a band of rows, 128 on its edge rows, 0
    elsewhere."""
    alpha = np.zeros(height, np.float64)
    top, bottom = int(0.7 * height), int(0.85 * height)
    alpha[top:bottom] = 255.0
    alpha[[top - 1, bottom]] = 128.0
    colour = np.stack(np.broadcast_arrays(np.linspace(20, 235, width)[None, :], 160.0, 60.0), -1)
    px = np.zeros((height, width, 4), np.uint8)
    px[..., :3] = np.round(colour * alpha[:, None, None] / 255.0)
    px[..., 3] = alpha[:, None]
    return px


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (same-sign finite values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)
