"""Port parity for the fused v210 program (B3, ops/kernels.py fused_v210)
and the combine + pack tail (B5, ops/kernels.py combine_pack) against
phaneron_tpu's make_fused_v210_program and make_v210_combine_pack (Pallas,
interpret mode on the CPU) and its XLA paths, and the entry() structure
end to end through the port's new staged route (packed warp pair, planar
unpack, combine_pack).

Contracts: B3 and B5 are exact against JAX's Pallas kernels (full-range
random words, a width with a partial last group and a pitch pad) and
against its XLA paths for cuts and the combine; a dissolve is within 1
code of the XLA path, which itself differs from JAX's Pallas kernel
there (XLA contracts the mix's multiply-adds into FMAs); the entry()
structure is within 1 code of both JAX paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops import composite as jcomposite
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_kernels import combine_pack_fits, make_fused_v210_program, make_v210_combine_pack
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu.ops.pallas_warp import warp_alpha_vectors as jax_alpha_vectors
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import kernels as K
from torch_parity import max_code_delta, random_words, words_to_planes

torch.set_num_threads(1)

H = 16
V210 = jget_format("v210")
Y422 = jget_format("yuv422p8")


def _w(a):
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32).copy())


def _jax_xla(spec, params):
    jp = {"layers": [
        {k: ([jnp.asarray(p) for p in v] if isinstance(v, list) else jnp.asarray(v))
         for k, v in lp.items()}
        for lp in params["layers"]
    ]}
    return np.asarray(jpipe.make_channel_program(spec)(jp)[0])


# ------------------------------------------------------------------ B3


@pytest.mark.parametrize("transition", ["none", "dissolve"])
@pytest.mark.parametrize("width", [1280, 192, 200])
def test_fused_v210_exact_against_jax(width, transition):
    """A v210 cut or dissolve without DVE, full-range random words: the
    port's channel program (B3) and fused_v210's plain version equal
    make_fused_v210_program word for word, and the JAX XLA path exactly for
    a cut, within 1 code for a dissolve (1280: a partial last group and a
    pitch pad; 192: neither; 200: the last 192-pixel segment of a row, the
    kernel's block, holds a partial group and six pad groups)."""
    rng = np.random.default_rng(width)
    a, b = random_words(rng, width, H), random_words(rng, width, H)
    mix = np.float32(0.3)
    dissolve = transition == "dissolve"
    jfused = make_fused_v210_program(width, H, transition=transition, interpret=True)
    if dissolve:
        want = np.asarray(jfused([jnp.asarray(a), jnp.asarray(b)], mix=jnp.float32(mix)))
        lp = {"src": [a], "src_b": [b], "mix": mix}
        ls = jpipe.LayerSpec("v210", transition="dissolve", src_b_format="v210")
    else:
        want = np.asarray(jfused([jnp.asarray(a)]))
        lp = {"src": [a]}
        ls = jpipe.LayerSpec("v210")
    spec = jpipe.ChannelSpec(width, H, "v210", layers=(ls,))
    tspec = spec_from_fields(spec._asdict())
    assert tpipe._fused_v210_ok(tspec)
    (got,) = tpipe.make_channel_program(tspec)(params_from_numpy({"layers": [lp]}, "cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert words_to_numpy(got).tobytes() == want.tobytes()
    plain = K.fused_v210_plain(_w(a), width, H, *((_w(b), torch.tensor(mix)) if dissolve else ()))
    assert words_to_numpy(plain).tobytes() == want.tobytes()
    xla = _jax_xla(spec, {"layers": [lp]})
    assert max_code_delta(words_to_numpy(got), xla, width, H) <= (1 if dissolve else 0)


def test_fused_v210_plain_is_the_staged_top_layer_and_cpu_launches_nothing():
    w = 100
    rng = np.random.default_rng(3)
    a, b = _w(random_words(rng, w, H)), _w(random_words(rng, w, H))
    mix = torch.tensor(0.65)
    before = K.fused_v210.launches
    got = K.fused_v210(a, w, H, b, mix)
    top = K.v210_unpack_plain([a], w, H)[0] * mix + K.v210_unpack_plain([b], w, H)[0] * (1.0 - mix)
    assert torch.equal(got, K.v210_pack_plain(top))
    assert torch.equal(K.fused_v210(a, w, H), K.v210_pack_plain(K.v210_unpack_plain([a], w, H)[0]))
    assert K.fused_v210.launches == before
    assert _build._load.cache_info().currsize == 0
    with pytest.raises(ValueError, match="go together"):
        K.fused_v210(a, w, H, b)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.fused_v210(torch.empty(a.shape, dtype=torch.int32, device="meta"), w, H)


@pytest.mark.parametrize("col_spec", sorted(K.cm.COLOUR_SPECS))
def test_fused_v210_decode_has_no_cb_in_r_and_no_cr_in_b(col_spec):
    """csrc/fused_v210.cu leaves out R''s Cb term and B''s Cr term and
    refuses coefficients where they are not zero: every colour spec's
    v210 decode matrix has them +-0."""
    col = np.frombuffer(K._decode_coeffs("v210", col_spec, col_spec), dtype=np.float32)[:12]
    assert col[1] == 0.0 and col[10] == 0.0
    assert col[2] != 0.0 and col[9] != 0.0


def test_channel_program_prepare_builds_nothing_on_the_cpu():
    """A channel program's prepare(device) builds the fused v210 kernel's
    transfer corrections on a CUDA device only: on the CPU (and for the
    plain program, and for a structure without the fused kernel) it
    launches and builds nothing."""
    fused = tpipe.ChannelSpec(64, H, "v210", layers=(tpipe.LayerSpec("v210"),))
    staged = tpipe.ChannelSpec(64, H, "v210", layers=(tpipe.LayerSpec("yuv422p8"),))
    assert tpipe._fused_v210_ok(fused) and not tpipe._fused_v210_ok(staged)
    before = K.fused_v210_corrections_on.launches
    for spec in (fused, staged):
        for plain in (False, True):
            assert tpipe.make_channel_program(spec, plain=plain).prepare("cpu") is None
    assert K.fused_v210_corrections_on.launches == before
    assert K.fused_v210_corrections_on.cache_info().currsize == 0
    assert _build._load.cache_info().currsize == 0


def test_fused_v210_chosen_over_an_unported_lower_layer():
    """JAX picks the fused program before it looks at the lower layers;
    so does the port: under a v210 dissolve top, the frame equals JAX's
    fused program whatever the lower layer is.  The lower layer runs: an
    off-geometry v210 dissolve (``src_size``, unpacked at 96x8 and
    resized) on its own is within 1 code of JAX's XLA path."""
    w = 192
    rng = np.random.default_rng(17)
    a, b = (random_words(rng, w, H) for _ in range(2))
    low = random_words(rng, 96, 8)
    spec = tpipe.ChannelSpec(w, H, "v210", layers=(
        tpipe.LayerSpec("v210", transition="dissolve", src_size=(96, 8)),
        tpipe.LayerSpec("v210", transition="dissolve", src_b_format="v210"),
    ))
    tpipe.check_structure(spec, "cpu")
    low_params = {"src": [low], "src_b": [np.roll(low, 5, axis=1)], "mix": np.float32(0.3)}
    params = params_from_numpy({"layers": [
        low_params, {"src": [a], "src_b": [b], "mix": np.float32(0.55)},
    ]}, "cpu")
    (got,) = tpipe.make_channel_program(spec)(params)
    jfused = make_fused_v210_program(w, H, transition="dissolve", interpret=True)
    want = np.asarray(jfused([jnp.asarray(a), jnp.asarray(b)], mix=jnp.float32(0.55)))
    assert words_to_numpy(got).tobytes() == want.tobytes()
    (plain,) = tpipe.make_channel_program(spec, plain=True)(params)
    assert torch.equal(plain, got)
    # the lower layer on its own
    jlow = jpipe.ChannelSpec(w, H, "v210", layers=(jpipe.LayerSpec("v210", transition="dissolve",
                                                                   src_size=(96, 8)),))
    low_spec = spec_from_fields(jlow._asdict())
    assert not tpipe._fused_v210_ok(low_spec)
    (got_low,) = tpipe.make_channel_program(low_spec)(params_from_numpy({"layers": [low_params]}, "cpu"))
    assert max_code_delta(words_to_numpy(got_low), _jax_xla(jlow, {"layers": [low_params]}), w, H) <= 1
    # a DVE on the top layer, or a non-v210 top, is not the fused program
    for top in (tpipe.LayerSpec("v210", has_transform=True), tpipe.LayerSpec("yuv422p8"),
                tpipe.LayerSpec("v210", deinterlace=True)):
        assert not tpipe._fused_v210_ok(spec._replace(layers=(spec.layers[0], top)))


# ------------------------------------------------------------------ B5

W5 = 768  # combine_pack_fits: groups a multiple of 128
CHS = (4, 3, 4, 3)


def _b5_layers(seed):
    """Premultiplied RGBA frames (alpha in [0, 1]) and (rgb, wy, wx)
    tuples with the separable alpha of a DVE matrix, bottom to top."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, c in enumerate(CHS):
        if c == 4:
            f = rng.random((4, H, W5), dtype=np.float32)
            f[:3] *= f[3]
            layers.append(f)
        else:
            m = transform_matrix(W5, H, scale_x=0.8 + 0.05 * i, scale_y=0.9, offset_x=0.01 * i)
            wy, wx = jax_alpha_vectors(H, W5, jnp.asarray(m.astype(np.float32)))
            layers.append((rng.random((3, H, W5), dtype=np.float32), np.asarray(wy), np.asarray(wx)))
    return layers


def _to(layers, fn):
    return [tuple(fn(x) for x in f) if isinstance(f, tuple) else fn(f) for f in layers]


def test_combine_pack_exact_against_jax():
    """4-channel frames and (rgb, wy, wx) layers mixed: combine_pack equals
    make_v210_combine_pack and JAX's combine_rgb -> XLA pack word for
    word, and the port's combine_rgb -> K2."""
    assert combine_pack_fits(W5, H, len(CHS))
    layers = _b5_layers(23)
    jl = _to(layers, jnp.asarray)
    want = np.asarray(make_v210_combine_pack(W5, H, len(CHS), interpret=True, layer_chs=CHS)(jl))
    xla = np.asarray(jpipe.make_pack_program("v210", W5, H, "709")(jcomposite.combine_rgb(jl))[0])
    assert np.array_equal(xla, want)
    tl = _to(layers, lambda a: torch.from_numpy(np.array(a, copy=True)))
    before = K.combine_pack.launches
    got = K.combine_pack(tl)
    assert K.combine_pack.launches == before
    assert got.dtype == torch.int32 and words_to_numpy(got).tobytes() == want.tobytes()
    assert torch.equal(got, K.combine_pack_plain(tl))
    with pytest.raises(ValueError, match="a layer is"):
        K.combine_pack([tl[0], (tl[0], tl[1][1], tl[1][2])])


# -------------------------------------------- the entry() structure


def test_entry_structure_matches_jax_both_paths():
    """entry()'s structure at 768x16, where JAX's packed warp and
    combine_pack gates admit it: the port (packed warp pair -> planar
    unpack -> combine_pack) within 1 code of JAX with its Pallas stages
    (the same three kernels, in interpret mode) and of its XLA path."""
    w = W5
    m = transform_matrix(w, H, scale_x=0.9, offset_x=0.05)
    rng = np.random.default_rng(29)
    a, b = V210.fill_buf(w, H)[0], random_words(rng, w, H)
    lps = [{"src": [a], "src_b": [b], "matrix": m, "mix": np.float32(0.4)},
           {"src": Y422.fill_buf(w, H)}]
    layer0 = jpipe.LayerSpec("v210", transition="dissolve", has_transform=True,
                             axis_aligned=True, src_b_format="v210")
    xla = jpipe.ChannelSpec(w, H, "v210", layers=(layer0, jpipe.LayerSpec("yuv422p8")))
    staged = xla._replace(pallas_stages=True,
                          layers=(layer0._replace(warp_bucket=bucket_of(m)), xla.layers[1]))
    planes = [dict(lps[0], src=[words_to_planes(a)], src_b=[words_to_planes(b)]), lps[1]]
    tspec = spec_from_fields(xla._asdict())
    (got,) = tpipe.make_channel_program(tspec)(params_from_numpy({"layers": lps}, "cpu"))
    got = words_to_numpy(got)
    for spec, params in ((staged, planes), (xla, lps)):
        assert max_code_delta(got, _jax_xla(spec, {"layers": params}), w, H) <= 1
    # the v210 layer decodes at its warp taps: no slot goes through K1
    srcs = tpipe._sources(tspec, params_from_numpy({"layers": lps}, "cpu"), tpipe._PLAIN,
                          skip=frozenset({0}))
    assert set(srcs) == {(1, "src")}
