"""yadif_ring at the staged ring kernel's tile edges: the plain version
(ops/yadif.py yadif_ring_plain, what the kernel is held to on the card)
against the JAX package, bit for bit.  The kernel (csrc/yadif.cu
yadif_ring_kernel) owns kRingCols columns by 2 * kRingRowGroups *
kRingSteps rows a block and stages every second row, so the geometries
here sit one below, at and one above one and two tiles' rows and one
tile's columns, at odd heights, at widths off 16 bytes, and down to
rings of 1-5 rows by 1-7 columns.  Where JAX's Pallas ring kernel takes
the geometry (``yadif_ring_fits``) it is the reference, in interpret
mode, one build per geometry; elsewhere JAX's XLA ``yadif_frame``, one
compile per shape, tff and skip_spatial.  Parity goes in as a 0-d int32
tensor, as the channel program hands it over."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops.pallas_yadif import make_yadif_ring_program, yadif_ring_fits
from phaneron_tpu.ops.yadif import yadif_frame as jax_yadif_frame
from phaneron_tpu_torch.ops import yadif as ty

torch.set_num_threads(1)

_SOURCE = (Path(__file__).resolve().parents[1] / "phaneron_tpu_torch" / "csrc" / "yadif.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


TILE_COLS = _const("kRingCols")
TILE_ROWS = 2 * _const("kRingRowGroups") * _const("kRingSteps")
EDGE_HEIGHTS = (TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, 2 * TILE_ROWS - 1, 2 * TILE_ROWS, 2 * TILE_ROWS + 1)
EDGE_WIDTHS = (TILE_COLS - 1, TILE_COLS, TILE_COLS + 1, TILE_COLS + 2)  # the last one off 16 bytes
# (channels, opaque) in turn: 3 channels, 4 with their own alpha, 4 opaque
KINDS = ((3, False), (4, False), (4, True))

_jax_yadif = jax.jit(jax_yadif_frame, static_argnums=(4, 5))


def _ring(seed: int, channels: int, h: int, w: int, opaque: bool) -> list:
    rng = np.random.default_rng(seed)
    frames = [rng.random((channels, h, w), dtype=np.float32) for _ in range(3)]
    if opaque:  # an opaque ring's alpha is 1, so JAX's pass-through alpha is the kernel's constant
        for f in frames:
            f[3] = 1.0
    return frames


def _port(frames, parity: int, tff: bool, skip: bool, opaque: bool) -> np.ndarray:
    par = torch.tensor(parity, dtype=torch.int32)
    got = ty.yadif_ring(*(torch.from_numpy(f.copy()) for f in frames), par, tff, skip_spatial=skip, opaque=opaque)
    return got.numpy()


def _check_xla(frames, tff: bool, skip: bool, opaque: bool) -> None:
    for parity in (0, 1):
        want = np.asarray(_jax_yadif(*(jnp.asarray(f) for f in frames), jnp.int32(parity), tff, skip))
        np.testing.assert_array_equal(_port(frames, parity, tff, skip, opaque), want)


@pytest.mark.parametrize("h,w,channels,tff,skip,opaque", [
    (TILE_ROWS, 2 * TILE_COLS, 4, True, False, False),
    (2 * TILE_ROWS, 2 * TILE_COLS, 3, False, True, False),
    (TILE_ROWS, 4 * TILE_COLS, 4, False, False, True),
])
def test_ring_at_tile_rows_equals_pallas(h, w, channels, tff, skip, opaque):
    """Where the Pallas ring kernel takes the geometry: one interpret build,
    both parities."""
    assert yadif_ring_fits(h, w, channels)
    frames = _ring(h * 7 + w + channels, channels, h, w, opaque)
    prog = make_yadif_ring_program(h, w, tff, skip_spatial=skip, interpret=True, opaque=opaque,
                                   channels=channels)
    for parity in (0, 1):
        want = np.asarray(prog(*(jnp.asarray(f) for f in frames), jnp.int32(parity)))
        np.testing.assert_array_equal(_port(frames, parity, tff, skip, opaque), want)


@pytest.mark.parametrize("h", EDGE_HEIGHTS)
@pytest.mark.parametrize("w", EDGE_WIDTHS)
def test_ring_at_tile_edges_equals_xla(h, w):
    """Heights one below, at and one above one and two tiles' rows, widths
    one below, at and above a tile's columns: both tff, skip_spatial in
    turn, each kind of ring in turn."""
    i = EDGE_HEIGHTS.index(h) * len(EDGE_WIDTHS) + EDGE_WIDTHS.index(w)
    channels, opaque = KINDS[i % 3]
    frames = _ring(1000 + i, channels, h, w, opaque)
    for tff in (True, False):
        _check_xla(frames, tff, skip=(i + tff) % 2 == 1, opaque=opaque)


@pytest.mark.parametrize("h", [1, 2, 3, 4, 5])
def test_tiny_rings_equal_xla(h):
    """Rings of 1-5 rows by 1-7 columns: every index clamps, and a ring
    shorter than the staged rows repeats its edge rows."""
    for w in range(1, 8):
        i = h * 7 + w
        channels, opaque = KINDS[i % 3]
        _check_xla(_ring(2000 + i, channels, h, w, opaque), tff=i % 2 == 0, skip=i % 4 >= 2, opaque=opaque)


@pytest.mark.parametrize("h,w,channels,opaque", [(1081, 20, 3, False), (1079, 66, 4, True), (45, 1918, 4, False)])
def test_odd_heights_and_unaligned_widths_equal_xla(h, w, channels, opaque):
    """Odd heights (the last tile partial, its last row kept or predicted
    by parity) and 1918 columns (rows off 16 bytes: the kernel's 4-byte
    copies and stores)."""
    frames = _ring(h + w, channels, h, w, opaque)
    for tff in (True, False):
        _check_xla(frames, tff, skip=not tff, opaque=opaque)
