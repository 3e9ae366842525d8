"""Port parity: the plain yadif of phaneron_tpu_torch (ops/yadif.py, the
plain version of the yadif ring and pair kernels) against the JAX
package's ``yadif_frame`` and its Pallas ring and pair kernels in
interpret mode on the CPU.  The contract is bit-exact: the arithmetic is
only + - abs /2 min max and compares, in the reference's order.  On CPU
tensors the wrappers run the plain versions and launch nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops.pallas_yadif import (
    make_yadif_pair_program,
    make_yadif_ring_program,
    yadif_pair_fits,
)
from phaneron_tpu.ops.yadif import yadif_frame as jax_yadif_frame
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import yadif as ty

torch.set_num_threads(1)

# one compile per (shape, tff, skip_spatial); parity stays traced
_jax_yadif = jax.jit(jax_yadif_frame, static_argnums=(4, 5))


def _ring(seed, c, h, w, opaque=False):
    rng = np.random.default_rng(seed)
    frames = [rng.random((c, h, w), dtype=np.float32) for _ in range(3)]
    if opaque:
        for f in frames:
            f[3] = 1.0
    return frames


def _jax(frames):
    return [jnp.asarray(f) for f in frames]


def _torch(frames):
    return [torch.from_numpy(f.copy()) for f in frames]


# (96, 128) and (120, 256): the Pallas test geometries, where JAX runs
# its half-height formulation; 10 rows (under 16) and 33 rows (odd),
# where it runs the full one
@pytest.mark.parametrize(
    "h,w,channels,tff",
    [(96, 128, 4, True), (96, 128, 3, False), (120, 256, 3, True), (120, 256, 4, False),
     (10, 24, 3, True), (10, 24, 4, False), (33, 40, 4, True), (33, 40, 3, False)],
)
def test_plain_equals_jax_yadif_frame(h, w, channels, tff):
    """Both parities, with and without the spatial check, with parity as
    a Python int and as a 0-d int32 tensor."""
    frames = _ring(h * w + channels, channels, h, w)
    for skip in (False, True):
        for parity in (0, 1):
            want = np.asarray(_jax_yadif(*_jax(frames), jnp.int32(parity), tff, skip))
            for par in (parity, torch.tensor(parity, dtype=torch.int32)):
                got = ty.yadif_frame(*_torch(frames), par, tff, skip_spatial=skip)
                assert got.dtype == torch.float32 and tuple(got.shape) == (channels, h, w)
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,tff,channels", [(96, 128, True, 4), (120, 256, False, 3)])
def test_ring_plain_equals_pallas_ring_kernel(h, w, tff, channels):
    frames = _ring(7 + h, channels, h, w)
    prog = make_yadif_ring_program(h, w, tff, interpret=True, channels=channels)
    for parity in (0, 1):
        want = np.asarray(prog(*_jax(frames), jnp.int32(parity)))
        got = ty.yadif_ring(*_torch(frames), parity, tff)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ring_opaque_equals_pallas():
    """opaque (alpha written as 1) on an alpha-one ring, bff."""
    h, w = 96, 128
    frames = _ring(9, 4, h, w, opaque=True)
    opaq = make_yadif_ring_program(h, w, False, interpret=True, opaque=True)
    for parity in (0, 1):
        want = np.asarray(opaq(*_jax(frames), jnp.int32(parity)))
        got = ty.yadif_ring(*_torch(frames), parity, False, opaque=True)
        np.testing.assert_array_equal(got.numpy(), want)


def test_opaque_writes_alpha_one():
    """With opaque the alpha plane is 1 on every row, whatever cur holds;
    RGB is unchanged."""
    frames = _torch(_ring(4, 4, 16, 24))
    for parity in (0, 1):
        full = ty.yadif_ring(*frames, parity, True)
        opaq = ty.yadif_ring(*frames, parity, True, opaque=True)
        assert torch.equal(opaq[:3], full[:3])
        assert torch.equal(opaq[3], torch.ones_like(opaq[3]))
        assert torch.equal(full[3], frames[1][3])


@pytest.mark.parametrize("h,w,tff,channels", [(96, 128, False, 3), (120, 256, True, 4)])
def test_pair_plain_equals_pallas_pair_kernel(h, w, tff, channels):
    frames = _ring(17 + w, channels, h, w)
    o0, o1 = make_yadif_pair_program(h, w, tff, interpret=True, channels=channels)(
        *_jax(frames)
    )
    g0, g1 = ty.yadif_pair(*_torch(frames), tff)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(o0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(o1))


@pytest.mark.parametrize("tff", [True, False])
def test_pair_equals_ring_at_both_parities(tff):
    frames = _torch(_ring(23, 4, 15, 24, opaque=True))
    pair = ty.yadif_pair(*frames, tff, opaque=True)
    for parity, got in enumerate(pair):
        assert torch.equal(got, ty.yadif_ring(*frames, parity, tff, opaque=True))
    # the outputs are new tensors, never a ring frame
    assert all(p.data_ptr() != f.data_ptr() for p in pair for f in frames)


@pytest.mark.parametrize("tff", [True, False])
def test_pair_field_program_emission_order(tff):
    """tff emits parity 0 then 1, bff 1 then 0 (JAX pipeline.py:1175-1178);
    make_yadif_program is the ring at a given parity."""
    frames = _torch(_ring(29, 3, 12, 20))
    first, second = tpipe.make_yadif_pair_field_program(12, 20, tff, channels=3)(*frames)
    order = (0, 1) if tff else (1, 0)
    ring = tpipe.make_yadif_program(tff, False)
    assert torch.equal(first, ring(*frames, order[0]))
    assert torch.equal(second, ring(*frames, order[1]))
    with pytest.raises(ValueError, match="expected"):
        tpipe.make_yadif_pair_field_program(12, 20, tff, channels=4)(*frames)


def test_cpu_wrappers_launch_nothing_and_refuse_other_devices():
    frames = _torch(_ring(31, 3, 8, 16))
    before = (ty.yadif_ring.launches, ty.yadif_pair.launches)
    assert torch.equal(ty.yadif_ring(*frames, 1, True), ty.yadif_ring_plain(*frames, 1, True))
    a = ty.yadif_pair(*frames, False)
    b = ty.yadif_pair_plain(*frames, False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (ty.yadif_ring.launches, ty.yadif_pair.launches) == before
    assert _build._load.cache_info().currsize == 0
    meta = [torch.empty((3, 8, 16), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ty.yadif_ring(*meta, 0, True)
    with pytest.raises(ValueError, match="no kernel for device"):
        ty.yadif_pair(*meta, True)
    with pytest.raises(ValueError, match="3\\|4"):
        ty.yadif_ring(*(f[:2] for f in frames), 0, True)


# The pair kernel's tile edges (csrc/yadif.cu stages 64 x 32 tiles of
# 16-byte rows, clamping rows and columns as it copies): rings down to one
# row and one column, and heights and widths off the tiles and off 4
# columns (1918 is the odd width chip_smoke.py holds the kernel to)
EDGE_SIZES = [(1, 1), (1, 7), (2, 3), (3, 5), (4, 2), (5, 7), (5, 1), (33, 70), (6, 1918)]


@pytest.mark.parametrize("h,w", EDGE_SIZES)
def test_pair_plain_equals_jax_yadif_frame_at_tile_edges(h, w):
    """yadif_pair_plain, which chip_smoke.py holds the pair kernel to at
    these geometries, against JAX's yadif_frame at both parities, tff and
    bff, with and without the spatial check; C 3, 4 and 4 opaque in turn."""
    channels, opaque = ((3, False), (4, False), (4, True))[(h + w) % 3]
    frames = _ring(h * 31 + w, channels, h, w, opaque=opaque)
    for tff in (True, False):
        for skip in (False, True):
            pair = ty.yadif_pair_plain(*_torch(frames), tff, skip_spatial=skip, opaque=opaque)
            for parity, got in enumerate(pair):
                want = np.asarray(_jax_yadif(*_jax(frames), jnp.int32(parity), tff, skip))
                assert tuple(got.shape) == (channels, h, w)
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,tff,channels", [(32, 128, True, 3), (48, 128, False, 4)])
def test_pair_plain_equals_pallas_pair_kernel_skip_spatial(h, w, tff, channels):
    """With skip_spatial, at the smallest geometries yadif_pair_fits admits."""
    assert yadif_pair_fits(h, w, channels)
    frames = _ring(41 + h, channels, h, w)
    o0, o1 = make_yadif_pair_program(h, w, tff, skip_spatial=True, interpret=True, channels=channels)(
        *_jax(frames)
    )
    g0, g1 = ty.yadif_pair(*_torch(frames), tff, skip_spatial=True)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(o0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(o1))
