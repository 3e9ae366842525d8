"""The v210 packs at the edges of the CUDA kernels' row segments, on the
CPU: K2 (v210_pack) and B5 (combine_pack) plain versions against
phaneron_tpu's Pallas kernels (interpret mode), and where the Pallas
combine + pack refuses the geometry (combine_pack_fits: a width a
multiple of 768), against JAX's XLA combine_rgb and v210 pack.  Widths
that end a 6-pixel group part-way (1-13), a 192-pixel segment part-way
(200), the 1918 pitch pad and 768 at a few rows; K2 with 4 and 3
channels in; B5 with 1, 2 and MAX_LAYERS layers alternating
premultiplied RGBA frames and (rgb, wy, wx) layers.  And the channel
program's prepare(), which builds the l2g corrections that K2 and B5
read on a CUDA device only, for every v210 output but the fused route.

Contract: the decoded fill_buf ramp packs exactly (equal to the fill_buf
words at the even widths: at an odd one fill_buf leaves fields of the
last pixel pair 0 that the pack fills); random input within 1 code, JAX's
own spread between torch.pow and XLA's power at a few table indices.
The CUDA kernels are held to these plain versions on the card by
chip_smoke.py, at these edges and at 1920x1080 and 3840x2160, and to
the kernels before their redesign, word for word, by
tools/kernel_variants.py."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops import composite as jcomposite
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_kernels import combine_pack_fits, make_v210_combine_pack, make_v210_pack_rgba
from phaneron_tpu.ops.pallas_warp import warp_alpha_vectors as jax_alpha_vectors
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import to_tensor, words_to_numpy
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops.formats import v210
from torch_parity import max_code_delta

torch.set_num_threads(1)

# (width, height): partial groups (1-13), a partial last segment (200),
# the 1918 pitch pad, whole 768-pixel chunks (the Pallas combine + pack's
# geometry)
K2_GEOMETRIES = [(w, 2) for w in range(1, 14)] + [(200, 3), (1918, 2), (768, 8)]
B5_GEOMETRIES = [(1, 2), (5, 2), (6, 3), (7, 2), (13, 2), (200, 3), (1918, 2), (768, 8)]
B5_LAYERS = [1, 2, K.MAX_LAYERS]
CPU = torch.device("cpu")


@lru_cache(maxsize=None)
def _jax_pack(width, height, channels):
    """The Pallas K2 (interpret) of one geometry and channel count, one
    build shared by the cases that use it: the build is most of its cost."""
    return make_v210_pack_rgba(width, height, interpret=True, channels=channels)


@lru_cache(maxsize=None)
def _jax_combine_pack(width, height, chs):
    return make_v210_combine_pack(width, height, len(chs), interpret=True, layer_chs=chs)


def _ramp(width, height):
    fill = v210.fill_buf(width, height)[0]
    return fill, K.v210_unpack_plain([to_tensor(fill, CPU)], width, height)[0]


def _words(t):
    return np.asarray(words_to_numpy(t))


@pytest.mark.parametrize("width,height", K2_GEOMETRIES)
def test_v210_pack_plain_matches_pallas_at_segment_edges(width, height):
    fill, ramp = _ramp(width, height)
    rng = np.random.default_rng(width * 31 + height)
    rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, height, width)).astype(np.float32))
    for rgba, tol in ((ramp, 0), (rand, 1)):
        got4 = K.v210_pack_plain(rgba)
        assert torch.equal(K.v210_pack_plain(rgba[:3].contiguous()), got4)  # alpha is never read
        for c in (4, 3):
            want = np.asarray(_jax_pack(width, height, c)(jnp.asarray(rgba[:c].numpy())))
            got = _words(got4)
            assert got.shape == want.shape
            assert max_code_delta(got, want, width, height) <= tol
            if tol == 0:
                assert np.array_equal(got, want)
        if tol == 0 and width % 2 == 0:
            assert np.array_equal(_words(got4), fill)


def _layers(n, width, height, seed):
    """n layers bottom to top as numpy: premultiplied RGBA frames (alpha
    in [0, 1]) at even m, (rgb, wy, wx) layers with the separable alpha
    of a DVE matrix at odd m; layer 0 the decoded fill_buf ramp when n is
    1."""
    rng = np.random.default_rng(seed)
    layers = []
    for m in range(n):
        if m % 2 == 0:
            a = rng.random((1, height, width), dtype=np.float32)
            rgb = rng.uniform(-0.05, 1.05, (3, height, width)).astype(np.float32)
            layers.append(np.concatenate([rgb * a, a]))
        else:
            mat = transform_matrix(width, height, scale_x=0.8 + 0.02 * m, scale_y=0.9, offset_x=0.01 * m)
            wy, wx = jax_alpha_vectors(height, width, jnp.asarray(mat.astype(np.float32)))
            layers.append((rng.random((3, height, width), dtype=np.float32), np.asarray(wy), np.asarray(wx)))
    return layers


def _to(layers, fn):
    return [tuple(fn(x) for x in f) if isinstance(f, tuple) else fn(f) for f in layers]


def _jax_b5(layers, width, height):
    """JAX's words for the stack: the Pallas combine + pack where its
    geometry admits it, else the XLA combine_rgb and v210 pack."""
    jl = _to(layers, jnp.asarray)
    if combine_pack_fits(width, height, len(layers)):
        chs = tuple(3 if isinstance(f, tuple) else 4 for f in layers)
        return np.asarray(_jax_combine_pack(width, height, chs)(jl))
    return np.asarray(jpipe.make_pack_program("v210", width, height, "709")(jcomposite.combine_rgb(jl))[0])


@pytest.mark.parametrize("n", B5_LAYERS)
@pytest.mark.parametrize("width,height", B5_GEOMETRIES)
def test_combine_pack_plain_matches_jax_at_segment_edges(width, height, n):
    layers = _layers(n, width, height, width * 7 + n)
    got = _words(K.combine_pack_plain(_to(layers, lambda a: torch.from_numpy(np.array(a, copy=True)))))
    want = _jax_b5(layers, width, height)
    assert got.shape == want.shape
    assert max_code_delta(got, want, width, height) <= 1


@pytest.mark.parametrize("width,height", [(7, 2), (200, 3), (768, 8)])
def test_combine_pack_plain_one_layer_is_k2(width, height):
    """B5 with one layer is K2 over that layer: the decoded ramp packs
    exactly, an RGBA layer's alpha and an (rgb, wy, wx) layer's alpha
    vectors are never read."""
    fill, ramp = _ramp(width, height)
    ones = (torch.zeros(height), torch.zeros(width))
    for layer in (ramp, (ramp[:3].contiguous(), *ones)):
        got = K.combine_pack_plain([layer])
        assert torch.equal(got, K.v210_pack_plain(ramp))
        want = _jax_b5([ramp.numpy()], width, height)
        assert np.array_equal(_words(got), want)
    if width % 2 == 0:
        assert np.array_equal(_words(K.combine_pack_plain([ramp])), fill)


def _v210_specs():
    """Channel structures into v210 that do not take the fused route: the
    staged route (a planar clip), and the same under emit_rgba."""
    spec = tpipe.ChannelSpec(64, 16, "v210", layers=(tpipe.LayerSpec("yuv422p8"),))
    return [spec, spec._replace(emit_rgba=True)]


@pytest.mark.parametrize("spec", _v210_specs(), ids=["route 3", "emit_rgba"])
def test_v210_output_prepare_builds_nothing_on_the_cpu(spec):
    """A v210-output channel program's prepare(device) builds the l2g
    corrections K2 and B5 read on a CUDA device only: on the CPU, and for
    the plain program, it launches and builds nothing."""
    assert not tpipe._fused_v210_ok(spec)
    before = K.l2g_corrections_on.launches
    for plain in (False, True):
        assert tpipe.make_channel_program(spec, plain=plain).prepare("cpu") is None
    assert K.l2g_corrections_on.launches == before
    assert K.l2g_corrections_on.cache_info().currsize == 0
    assert _build._load.cache_info().currsize == 0


@pytest.mark.parametrize("spec", _v210_specs(), ids=["route 3", "emit_rgba"])
def test_v210_output_prepare_asks_for_the_l2g_corrections_on_cuda(spec, monkeypatch):
    """On a CUDA device the program's prepare() asks for the l2g
    corrections of the output's colour spec (built once per device and
    spec by the cached l2g_corrections_on), the plain program's for
    nothing, and the fused route's for its own transfer corrections only."""
    asked = []
    monkeypatch.setattr(K, "l2g_corrections_on", lambda col, dev: asked.append(("l2g", col, dev)))
    monkeypatch.setattr(K, "fused_v210_corrections_on", lambda *a: asked.append(("fused",) + a))
    cuda = torch.device("cuda", 0)
    tpipe.make_channel_program(spec, plain=True).prepare(cuda)
    assert asked == []
    tpipe.make_channel_program(spec).prepare(cuda)
    assert asked == [("l2g", spec.out_col_spec, cuda)]
    asked.clear()
    fused = tpipe.ChannelSpec(64, 16, "v210", layers=(tpipe.LayerSpec("v210"),))
    assert tpipe._fused_v210_ok(fused)
    tpipe.make_channel_program(fused).prepare(cuda)
    assert [a[0] for a in asked] == ["fused"]
