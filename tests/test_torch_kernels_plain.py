"""Port parity: the plain PyTorch version of each CUDA kernel on the
channel frame path against the JAX Pallas kernel it replaces, run in
interpret mode on the CPU.  (The CUDA kernels themselves are held to
these plain versions on the card by chip_smoke.py.)  On CPU tensors the
kernel wrappers run the plain versions and launch nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_kernels import (
    make_planar422_unpack_rgba,
    make_v210_pack_rgba,
    make_v210_unpack_rgba,
    make_v210_unpack_rgba_batch,
)
from phaneron_tpu.ops.pallas_warp import bucket_of, make_warp_pair_program, make_warp_program
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops.warp import warp, warp_plain
from torch_parity import max_code_delta, random_words, words_to_planes

torch.set_num_threads(1)

# one LUT step at the top of the BT.709 curve (2.022 / 65535): the table
# equals JAX's transfer function, but XLA contracts the colour matrix's
# multiply-adds into FMAs, which moves a few LUT indices by one
TOL_UNPACK = 3.1e-5
TOL_WARP = 5e-5  # the Pallas warp's bf16 hi/lo split, ~2^-17
V210 = jget_format("v210")


def _words(a):
    return torch.from_numpy(a.view(np.int32).copy())


def test_v210_unpack_matches_batch_kernel():
    """K1 against the batched spatial kernel, two sources per launch."""
    w, h = 256, 16
    rng = np.random.default_rng(1)
    srcs = [random_words(rng, w, h), V210.fill_buf(w, h)[0]]
    want = make_v210_unpack_rgba_batch(w, h, 2, interpret=True)(
        [jnp.asarray(words_to_planes(s)) for s in srcs]
    )
    got = K.v210_unpack([_words(s) for s in srcs], w, h)
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.shape == (4, h, w) and a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL_UNPACK


@pytest.mark.parametrize("width", [100, 1270, 1280])
def test_v210_unpack_matches_phase_kernel(width):
    """K1 at widths with a pitch pad: 100 and 1270 (which ends mid-group
    and mid-block of the CUDA kernel's 192-pixel tiles) take the phase
    kernel (pallas_kernels.py:465), 1280 the spatial kernel."""
    h = 16
    rng = np.random.default_rng(width)
    for src in (random_words(rng, width, h), V210.fill_buf(width, h)[0]):
        want = np.asarray(make_v210_unpack_rgba(width, h, interpret=True)(jnp.asarray(src)))
        got = K.v210_unpack([_words(src)], width, h)[0].numpy()
        assert np.abs(got - want).max() <= TOL_UNPACK


@pytest.mark.parametrize("width,channels", [(256, 4), (100, 4), (1280, 3)])
def test_v210_pack_matches_kernel(width, channels):
    """K2: equal codes on the ramps, <= 1 code on random inputs."""
    h = 16
    fill = V210.fill_buf(width, h)[0]
    ramp = np.asarray(make_v210_unpack_rgba(width, h, interpret=True)(jnp.asarray(fill)))
    rng = np.random.default_rng(7)
    rand = rng.uniform(-0.05, 1.05, size=(4, h, width)).astype(np.float32)
    jpack = make_v210_pack_rgba(width, h, interpret=True, channels=channels)
    for rgb, tol in ((ramp, 0), (rand, 1)):
        rgb = np.array(rgb[:channels])
        want = np.asarray(jpack(jnp.asarray(rgb)))
        got = K.v210_pack(torch.from_numpy(rgb))
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        got = got.numpy().view(np.uint32)
        assert max_code_delta(got, want, width, h) <= tol
        if tol == 0:
            assert np.array_equal(got, fill)


@pytest.mark.parametrize("width", [256, 720])
def test_planar422_unpack_matches_kernel(width):
    """K3: the spatial kernel at 256, the phase kernel at 720."""
    h = 16
    fmt = jget_format("yuv422p8")
    rng = np.random.default_rng(width)
    rand = [rng.integers(0, 256, size=s, dtype=np.uint8) for s, _ in fmt.plane_shapes(width, h)]
    jfn = make_planar422_unpack_rgba("yuv422p8", width, h, interpret=True)
    for planes in (fmt.fill_buf(width, h), rand):
        want = np.asarray(jfn([jnp.asarray(p) for p in planes]))
        got = K.planar422_unpack([torch.from_numpy(p.copy()) for p in planes], width, h)
        assert np.abs(got.numpy() - want).max() <= TOL_UNPACK


WH, WW = 64, 256
MATS = [  # tests/test_pallas_warp.py:17-27
    dict(scale_x=0.9, scale_y=0.9, offset_x=0.02),
    dict(scale_x=0.5, scale_y=2.0, offset_y=-0.1),
    dict(flip_h=True, scale_x=1.3),
    dict(flip_v=True),
    dict(anchor_x=0.3, scale_x=1.5, scale_y=0.7, offset_y=0.1),
    dict(scale_x=0.26, scale_y=0.26),
    dict(),
]


def _frames(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.random((4, WH, WW), dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("kwargs", MATS)
def test_warp_matches_kernel(kwargs):
    (src,) = _frames(3, 1)
    m = transform_matrix(WW, WH, **kwargs)
    want = np.asarray(
        make_warp_program(WH, WW, bucket_of(m), interpret=True)(jnp.asarray(src), jnp.asarray(m))
    )
    got = warp(torch.from_numpy(src), torch.from_numpy(m)).numpy()
    assert np.abs(got - want).max() <= TOL_WARP


@pytest.mark.parametrize("kwargs", [MATS[0], dict(scale_x=0.9, scale_y=0.8, offset_x=0.05)])
def test_warp_pair_matches_kernel(kwargs):
    a, b = _frames(7)
    m = transform_matrix(WW, WH, **kwargs)
    mix = 0.3
    pair = make_warp_pair_program(WH, WW, bucket_of(m), same_mat=True, interpret=True)
    want = np.asarray(pair(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), jnp.asarray(m), jnp.float32(mix)))
    got = warp(
        torch.from_numpy(a), torch.from_numpy(m), torch.from_numpy(b), torch.tensor(mix)
    ).numpy()
    assert np.abs(got - want).max() <= TOL_WARP


def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    w, h = 100, 8
    rng = np.random.default_rng(0)
    words = _words(random_words(rng, w, h))
    counters = (K.v210_unpack, K.v210_pack, K.planar422_unpack, warp)
    before = [fn.launches for fn in counters]
    rgba = K.v210_unpack([words], w, h)[0]
    assert torch.equal(rgba, K.v210_unpack_plain([words], w, h)[0])
    assert torch.equal(K.v210_pack(rgba), K.v210_pack_plain(rgba))
    m = torch.from_numpy(transform_matrix(w, h, scale_x=0.9))
    assert torch.equal(warp(rgba, m, rgba, 0.5), warp_plain(rgba, m, rgba, 0.5))
    planes = [torch.from_numpy(p.copy()) for p in jget_format("yuv422p8").fill_buf(w, h)]
    assert torch.equal(K.planar422_unpack(planes, w, h), K.planar422_unpack_plain(planes, w, h))
    assert [fn.launches for fn in counters] == before


def test_wrappers_refuse_other_devices():
    t = torch.empty((4, 8, 96), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.v210_pack(t)
    with pytest.raises(ValueError, match="no kernel for device"):
        warp(t, torch.eye(3))


def test_build_sources_and_flags():
    """The build compiles exactly the package's CUDA sources for sm_90a,
    without FMA contraction; importing never builds (this test imports
    the wrappers on a machine that may have no nvcc)."""
    names = sorted(p.name for p in _build.sources())
    assert names == [
        "combine_pack.cu", "fused_v210.cu", "graph_rebind.cu", "l2g_corrections.cu", "packed_composite.cu",
        "packed_warp.cu",
        "phn_common.cuh", "planar420_pack.cu", "planar420_unpack.cu", "planar422_pack.cu",
        "planar422_unpack.cu", "rgb8_unpack.cu", "rotate.cu", "v210_unpack.cu", "warp.cu", "yadif.cu",
    ]
    flags = " ".join(_build.nvcc_flags())
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build._load.cache_info().currsize == 0
