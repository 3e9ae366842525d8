"""The planar unpacks at the edges of the CUDA kernels' blocks, on the
CPU: K3/B10 (yuv422p8, yuv422p10le) and B12 (yuv420p, nv12) plain
versions against phaneron_tpu's Pallas kernels (interpret mode) at widths
that are not a multiple of a warp's 128 pixels (130, 258, the 1918 pitch
pad) and at odd heights; 4:2:0 odd heights, which the Pallas kernels
refuse, against JAX's XLA to_rgba.

Contract: within one LUT step (TOL_UNPACK), the contract of
tests/test_torch_planar.py: the Pallas kernels split codes into bf16
hi/lo parts and XLA contracts the colour matrix into FMAs, which moves
a few table indices by one.  The CUDA kernels equal the plain versions
(max |delta| 0) on the card, where chip_smoke.py holds them at these
edges and at 1x1 to 3840x2160."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import coeffs as jcoeffs
from phaneron_tpu.ops import io as jio
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.pallas_kernels import make_planar420_unpack_rgba, make_planar422_unpack_rgba
from phaneron_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

TOL_UNPACK = 3.1e-5  # one LUT step at the top of the BT.709 curve
FORMS = ["yuv422p8", "yuv422p10le", "yuv420p", "nv12"]
# (width, height): a partial last quad or warp of 128 pixels, the 1918
# pitch pad; odd heights where the Pallas kernel takes them (4:2:2)
GEOMETRIES = {
    "yuv422p8": [(130, 3), (258, 2), (1918, 1)],
    "yuv422p10le": [(130, 3), (258, 2), (1918, 1)],
    "yuv420p": [(130, 4), (258, 2), (1918, 2)],
    "nv12": [(130, 4), (258, 2), (1918, 2)],
}
ODD_420 = [(130, 3), (1918, 1)]


@lru_cache(maxsize=None)
def _jax_unpack(name, width, height):
    """The Pallas unpack (interpret) of one format and geometry, one build
    shared by the cases that use it: the build is most of its cost."""
    make = make_planar420_unpack_rgba if jget_format(name).INFO.sub_y == 2 else make_planar422_unpack_rgba
    return make(name, width, height, interpret=True)


def _plain(name):
    return K.planar420_unpack_plain if jget_format(name).INFO.sub_y == 2 else K.planar422_unpack_plain


def _cases(name, width, height, seed):
    """The fill_buf ramp and seeded full-range random planes."""
    fmt = jget_format(name)
    rng = np.random.default_rng(seed)
    hi = 1 << fmt.INFO.num_bits
    return [fmt.fill_buf(width, height),
            [rng.integers(0, hi, size=s, dtype=dt) for s, dt in fmt.plane_shapes(width, height)]]


def _t(planes):
    return [torch.from_numpy(np.array(p, copy=True)) for p in planes]


@pytest.mark.parametrize("name,width,height", [(n, w, h) for n in FORMS for w, h in GEOMETRIES[n]])
def test_plain_matches_pallas_at_block_edges(name, width, height):
    jfn = _jax_unpack(name, width, height)
    for planes in _cases(name, width, height, width + height):
        want = np.asarray(jfn([jnp.asarray(p) for p in planes]))
        got = _plain(name)(_t(planes), width, height, fmt_name=name)
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, height, width)
        assert np.abs(got.numpy() - want).max() <= TOL_UNPACK


@pytest.mark.parametrize("name", ["yuv420p", "nv12"])
@pytest.mark.parametrize("width,height", ODD_420)
def test_plain_420_odd_height_matches_xla(name, width, height):
    """An odd height's last row pair has one row; the Pallas 4:2:0
    kernels assert even heights, so JAX's XLA path is the reference."""
    jf = jget_format(name)
    loader = jcoeffs.make_loader(jf.INFO, "709", "709")
    for planes in _cases(name, width, height, width * height):
        want = np.asarray(jio.to_rgba(jf, [jnp.asarray(p) for p in planes], loader, width, height))
        got = _plain(name)(_t(planes), width, height, fmt_name=name)
        assert tuple(got.shape) == (4, height, width)
        assert np.abs(got.numpy() - want).max() <= TOL_UNPACK

