"""Port parity: the channel frame program of phaneron_tpu_torch against
phaneron_tpu's make_channel_program on the CPU, at 256x32 (the 1080p
structure of __graft_entry__.entry(), cut in size), plus the spec /
params carry-over and the structure dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from torch_parity import max_code_delta, random_words

torch.set_num_threads(1)

W, H = 256, 32
V210 = jget_format("v210")
Y422 = jget_format("yuv422p8")
MAT = transform_matrix(W, H, scale_x=0.9, offset_x=0.05)  # entry()'s DVE, warp bucket 1


def _dve_dissolve(**kw):
    return jpipe.LayerSpec(
        "v210", transition="dissolve", has_transform=True, axis_aligned=True,
        src_b_format="v210", **kw,
    )


def _entry_params(seed=0, mix=0.4, mat=MAT):
    rng = np.random.default_rng(seed)
    return {
        "layers": [
            {
                "src": V210.fill_buf(W, H),
                "src_b": [random_words(rng, W, H)],
                "matrix": mat,
                "mix": np.float32(mix),
            },
            {"src": Y422.fill_buf(W, H)},
        ]
    }


def _run_jax(spec, params):
    jp = {
        "layers": [
            {k: ([jnp.asarray(p) for p in v] if isinstance(v, list) else jnp.asarray(v))
             for k, v in layer.items()}
            for layer in params["layers"]
        ]
    }
    return [np.asarray(p) for p in jpipe.make_channel_program(spec)(jp)]


def _run_port(spec, params, plain=False):
    prog = tpipe.make_channel_program(spec_from_fields(spec._asdict()), plain=plain)
    return prog(params_from_numpy(params, "cpu"))


def test_entry_structure_matches_jax_both_paths():
    """The slice as a whole: <= 1 code on every field against the JAX
    program with its Pallas stages (interpret mode: the four kernels
    the port replaces) and against its XLA path."""
    xla = jpipe.ChannelSpec(W, H, "v210", layers=(_dve_dissolve(), jpipe.LayerSpec("yuv422p8")))
    staged = xla._replace(
        pallas_stages=True, layers=(_dve_dissolve(warp_bucket=bucket_of(MAT)), xla.layers[1])
    )
    params = _entry_params()
    (got,) = _run_port(xla, params)
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, V210.pitch_bytes(W) // 4)
    got = words_to_numpy(got)
    for spec in (staged, xla):
        (want,) = _run_jax(spec, params)
        assert max_code_delta(got, want, W, H) <= 1


@pytest.mark.parametrize("pallas_stages", [True, False])
def test_cut_only_v210_layer_bit_exact(pallas_stages):
    """One v210 cut: the port's K1 -> K2 equals the JAX fused single
    kernel (pallas_stages) and its XLA path, to the byte."""
    rng = np.random.default_rng(5)
    spec = jpipe.ChannelSpec(W, H, "v210", layers=(jpipe.LayerSpec("v210"),),
                             pallas_stages=pallas_stages)
    for src in (V210.fill_buf(W, H)[0], random_words(rng, W, H)):
        params = {"layers": [{"src": [src]}]}
        (want,) = _run_jax(spec, params)
        (got,) = _run_port(spec, params)
        assert words_to_numpy(got).tobytes() == want.tobytes()


ROT = transform_matrix(W, H, scale_x=0.8, scale_y=0.8, rotate=0.05)
STRUCTURES = {
    "dve_cut": (
        (jpipe.LayerSpec("v210", has_transform=True),),
        [{"src": "fill", "matrix": transform_matrix(W, H, scale_x=0.8, scale_y=1.2, offset_y=0.1)}],
    ),
    "dissolve_no_dve": (
        (jpipe.LayerSpec("v210", transition="dissolve", src_b_format="v210"),),
        [{"src": "fill", "src_b": "rand", "mix": np.float32(0.7)}],
    ),
    "yuv422_dissolve_over_v210_dve": (
        (jpipe.LayerSpec("v210", has_transform=True),
         jpipe.LayerSpec("yuv422p8", transition="dissolve", src_b_format="v210",
                         has_transform=True)),
        [{"src": "fill", "matrix": transform_matrix(W, H, flip_h=True, scale_x=1.3)},
         {"src": "y422", "src_b": "rand", "matrix": transform_matrix(W, H, scale_x=0.5, scale_y=0.5),
          "mix": np.float32(0.25)}],
    ),
    "rotation_cpu_plain": (
        (jpipe.LayerSpec("v210", has_transform=True, axis_aligned=False),),
        [{"src": "fill", "matrix": ROT}],
    ),
}


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_other_structures_match_jax_xla(name):
    """Structures the CPU plain path covers: <= 1 code against the JAX
    XLA path."""
    layers, lparams = STRUCTURES[name]
    rng = np.random.default_rng(11)
    srcs = {"fill": V210.fill_buf(W, H), "rand": [random_words(rng, W, H)],
            "y422": Y422.fill_buf(W, H)}
    params = {
        "layers": [{k: (srcs[v] if isinstance(v, str) else v) for k, v in lp.items()}
                   for lp in lparams]
    }
    spec = jpipe.ChannelSpec(W, H, "v210", layers=layers)
    (want,) = _run_jax(spec, params)
    (got,) = _run_port(spec, params)
    assert max_code_delta(words_to_numpy(got), want, W, H) <= 1


def test_plain_program_equals_kernel_wrappers_on_cpu():
    spec = jpipe.ChannelSpec(W, H, "v210", layers=(_dve_dissolve(), jpipe.LayerSpec("yuv422p8")))
    params = _entry_params(seed=3, mix=0.8)
    (a,) = _run_port(spec, params)
    (b,) = _run_port(spec, params, plain=True)
    assert torch.equal(a, b)


def test_params_from_numpy_round_trips():
    params = _entry_params(seed=9)
    port = params_from_numpy(params, "cpu")
    for lp, tp in zip(params["layers"], port["layers"]):
        assert set(lp) == set(tp)
        for key, value in lp.items():
            if isinstance(value, list):
                assert len(tp[key]) == len(value)
                for a, t in zip(value, tp[key]):
                    back = words_to_numpy(t) if a.dtype == np.uint32 else t.numpy()
                    assert back.dtype == a.dtype and np.array_equal(back, a)
            else:
                assert tp[key].dtype == torch.float32
                assert np.array_equal(tp[key].numpy(), np.asarray(value, np.float32))
    assert port["layers"][0]["src"][0].dtype == torch.int32


def test_spec_from_fields_keeps_every_field():
    spec = jpipe.ChannelSpec(
        W, H, "v210",
        layers=(_dve_dissolve(warp_bucket=1), jpipe.LayerSpec("yuv422p8", src_size=(128, 16))),
        col_spec="601-625", pallas_stages=True,
    )
    port = spec_from_fields(spec._asdict())
    assert port._asdict().keys() == spec._asdict().keys()
    assert port.layers[0]._fields == spec.layers[0]._fields
    assert tuple(port.layers[0]) == tuple(spec.layers[0])
    assert tuple(port.layers[1]) == tuple(spec.layers[1])
    assert port.width == W and port.col_spec == "601-625"
    assert hash(port) == hash(spec_from_fields(spec._asdict()))


def _spec(*layers, out_format="v210", **kw):
    return tpipe.ChannelSpec(W, H, out_format, layers=tuple(layers), **kw)


def test_entry_structure_dispatches_to_kernels_on_cuda():
    """The entry() structure and the interlaced default load's structures
    (a deinterlaced ring layer, rgba_f32 field layers) have every kernel."""
    entry = _spec(tpipe.LayerSpec("v210", transition="dissolve", has_transform=True,
                                  src_b_format="v210"),
                  tpipe.LayerSpec("yuv422p8"))
    ring = _spec(tpipe.LayerSpec("v210", deinterlace=True))
    fields = _spec(tpipe.LayerSpec("rgba_f32", transition="dissolve", has_transform=True,
                                   src_b_format="rgba_f32", src_opaque=True))
    for spec in (entry, ring, fields):
        assert tpipe.missing_kernel(spec) is None
        tpipe.check_structure(spec, torch.device("cuda"))  # does not raise
        tpipe.check_structure(spec, "cpu")


@pytest.mark.parametrize(
    "spec,item",
    [
        # rotation (B14), distinct matrices over planar sources and a
        # wipe (B4), with DVE and without, emit_rgba (A4 with B7's emits)
        (_spec(tpipe.LayerSpec("v210", has_transform=True, axis_aligned=False)), "B14"),
        (_spec(tpipe.LayerSpec("yuv422p8", transition="dissolve", has_transform=True,
                               warp_same_mat=False)), "B4"),
        (_spec(tpipe.LayerSpec("v210", transition="wipe"),
               tpipe.LayerSpec("v210", transition="wipe", has_transform=True,
                               mask_format="yuv422p8", src_b_format="rgba_f32")), "wipe"),
        (_spec(tpipe.LayerSpec("v210"), emit_rgba=True), "emit_rgba"),
        # the file-media formats: planar outputs (B11, B13), 10-bit 4:2:2
        # (B10), 4:2:0 (B12) and RGB sources and outputs
        (_spec(tpipe.LayerSpec("v210"), out_format="yuv422p8"), "B11"),
        (_spec(tpipe.LayerSpec("yuv422p10le")), "yuv422p10le"),
        (_spec(tpipe.LayerSpec("nv12")), "nv12"),
        (_spec(tpipe.LayerSpec("yuv420p", transition="dissolve", has_transform=True,
                               src_b_format="nv12"),
               tpipe.LayerSpec("rgba8"), out_format="nv12", emit_rgba=True), "B12, B13"),
        (_spec(tpipe.LayerSpec("bgra8", transition="wipe", mask_format="rgba"),
               out_format="bgra8"), "bgra8"),
        # off-geometry sources (A3: unpacked at their own size, resize_frame)
        (_spec(tpipe.LayerSpec("v210", src_size=(128, 16))), "resize_frame"),
        (_spec(tpipe.LayerSpec("v210"), tpipe.LayerSpec("nv12", src_size=(128, 16)),
               out_format="yuv420p"), "resize_frame"),
    ],
)
def test_straggler_structures_run_on_cuda(spec, item):
    """The structures the port has ported have every kernel: they pass
    check_structure on the card and on the CPU, off-geometry sources
    (``src_size``) among them."""
    assert tpipe.missing_kernel(spec) is None, item
    tpipe.check_structure(spec, torch.device("cuda"))
    tpipe.check_structure(spec, "cpu")


@pytest.mark.parametrize(
    "spec,item",
    [
        (_spec(tpipe.LayerSpec("v210", transition="push")), "A4"),
    ],
)
def test_structures_outside_the_slice_raise_on_cuda(spec, item):
    """A structure the port has no code for (a transition outside
    none / dissolve / wipe, ROADMAP A4) raises on the card path and on the
    CPU, naming its ROADMAP item."""
    for device in (torch.device("cuda"), "cpu"):
        with pytest.raises(NotImplementedError, match=item):
            tpipe.check_structure(spec, device)


def test_unknown_format_raises_keyerror():
    """A format no registry knows fails as JAX's get_format does."""
    for spec in (_spec(tpipe.LayerSpec("yuv444p12le")),
                 _spec(tpipe.LayerSpec("v210"), out_format="yuv444p12le")):
        with pytest.raises(KeyError, match="yuv444p12le"):
            tpipe.check_structure(spec, "cpu")
