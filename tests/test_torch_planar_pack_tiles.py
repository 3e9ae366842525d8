"""The planar packs at the edges of the CUDA kernels' blocks, on the CPU:
B11 (yuv422p8, yuv422p10le) and B13 (yuv420p, nv12) plain versions
against phaneron_tpu's Pallas kernels (interpret mode) at widths that are
not a multiple of a warp's 128 pixels (130, 258, the 1918 pitch pad, whose
last quad is part pad) and partial quads (widths 3, 5 and 6), with 4 and 3
channels in; 4:2:0 odd heights, which the Pallas kernels refuse, against
JAX's XLA from_rgba; and the channel program's prepare(), which builds
the kernels' l2g corrections on a CUDA device only.

Contract: the decoded fill_buf ramps pack exactly, equal to the fill_buf
planes (pad included; at an odd 4:2:2 width fill_buf fills the missing
pixel of the last pair, which the pack writes as black); random RGBA in
[-0.05, 1.05] within 1 code, JAX's own spread between its paths
(tests/test_torch_planar.py: torch.pow and XLA's power round a few table
indices apart).  The CUDA kernels are held
to these plain versions on the card by chip_smoke.py, at these edges and
at 1x1 to 3840x2160."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import coeffs as jcoeffs
from phaneron_tpu.ops import io as jio
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.pallas_kernels import make_planar420_pack_rgba, make_planar422_pack_rgba
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

FORMS = ["yuv422p8", "yuv422p10le", "yuv420p", "nv12"]
# (width, height): a partial last warp of 128 pixels (130, 258), the 1918
# pitch pad, partial quads (3, 5, 6); odd heights where the Pallas kernel
# takes them (4:2:2)
GEOMETRIES = {
    "yuv422p8": [(130, 3), (258, 2), (1918, 1), (6, 2), (5, 3)],
    "yuv422p10le": [(130, 3), (258, 2), (1918, 1), (6, 2), (3, 1)],
    "yuv420p": [(130, 4), (258, 2), (1918, 2), (6, 2), (5, 2)],
    "nv12": [(130, 4), (258, 2), (1918, 2), (6, 2), (3, 2)],
}
ODD_420 = [(130, 3), (1918, 1), (5, 1)]


def _is_420(name):
    return jget_format(name).INFO.sub_y == 2


@lru_cache(maxsize=None)
def _jax_pack(name, width, height):
    """The Pallas pack (interpret) of one format and geometry, one build
    shared by the cases that use it: the build is most of its cost."""
    make = make_planar420_pack_rgba if _is_420(name) else make_planar422_pack_rgba
    return make(name, width, height, interpret=True)


def _plain(name):
    return K.planar420_pack_plain if _is_420(name) else K.planar422_pack_plain


def _cases(name, width, height, seed):
    """(RGBA (4, H, W), tolerance in codes): the decoded fill_buf ramp,
    exact, and seeded random RGBA in [-0.05, 1.05], within 1 code."""
    unpack = K.planar420_unpack_plain if _is_420(name) else K.planar422_unpack_plain
    planes = [torch.from_numpy(np.array(p, copy=True)) for p in jget_format(name).fill_buf(width, height)]
    ramp = unpack(planes, width, height, fmt_name=name)
    rng = np.random.default_rng(seed)
    rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, height, width)).astype(np.float32))
    return [(ramp, 0), (rand, 1)]


def _delta(got, want):
    return max(int(np.abs(np.asarray(g, np.int32) - np.asarray(w, np.int32)).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("name,width,height", [(n, w, h) for n in FORMS for w, h in GEOMETRIES[n]])
def test_plain_matches_pallas_at_block_edges(name, width, height):
    jfn = _jax_pack(name, width, height)
    fill = jget_format(name).fill_buf(width, height)
    for rgba, tol in _cases(name, width, height, width + height):
        want = [np.asarray(p) for p in jfn(jnp.asarray(rgba.numpy()))]
        for c in (4, 3):
            got = [p.numpy() for p in _plain(name)(rgba[:c].contiguous(), name)]
            assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
            assert _delta(got, want) <= tol
            if tol == 0 and (width % 2 == 0 or _is_420(name)):
                assert all(np.array_equal(g, f) for g, f in zip(got, fill))


@pytest.mark.parametrize("name", ["yuv420p", "nv12"])
@pytest.mark.parametrize("width,height", ODD_420)
def test_plain_420_odd_height_matches_xla(name, width, height):
    """An odd height's last row pair has one row, whose chroma the pack
    takes; the Pallas 4:2:0 kernels assert even heights, so JAX's XLA
    path is the reference."""
    jf = jget_format(name)
    saver = jcoeffs.make_saver(jf.INFO, "709")
    fill = jf.fill_buf(width, height)
    for rgba, tol in _cases(name, width, height, width * height):
        want = [np.asarray(p) for p in jio.from_rgba(jf, jnp.asarray(rgba.numpy()), saver, width, height)]
        for c in (4, 3):
            got = [p.numpy() for p in K.planar420_pack_plain(rgba[:c].contiguous(), name)]
            assert [g.shape for g in got] == [w.shape for w in want]
            assert _delta(got, want) <= tol
            if tol == 0:
                assert all(np.array_equal(g, f) for g, f in zip(got, fill))


@pytest.mark.parametrize("out_format", ["yuv422p10le", "yuv422p8", "yuv420p", "nv12"])
def test_planar_output_prepare_builds_nothing_on_the_cpu(out_format):
    """A planar-output channel program's prepare(device) builds the packs'
    l2g corrections on a CUDA device only: on the CPU, and for the plain
    program, it launches and builds nothing."""
    spec = tpipe.ChannelSpec(64, 16, out_format, layers=(tpipe.LayerSpec("yuv422p8"),))
    before = K.l2g_corrections_on.launches
    for plain in (False, True):
        assert tpipe.make_channel_program(spec, plain=plain).prepare("cpu") is None
    assert K.l2g_corrections_on.launches == before
    assert K.l2g_corrections_on.cache_info().currsize == 0
    assert _build._load.cache_info().currsize == 0
