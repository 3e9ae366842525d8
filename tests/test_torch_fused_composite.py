"""Port parity for B15, the whole-stack composite over v210 words with the
top layer's alpha: the packed composite with ``src_kind='packed'`` and
``alpha='top'`` (ops/packed_warp.py ``packed_composite``;
csrc/packed_composite.cu) against phaneron_tpu's ``make_composite_program``
(Pallas, interpret mode on the CPU) and its ``_top_alpha_fixup``, and
bench.py's progressive 4-layer v210 stack through ``make_channel_program``
into yuv422p10le and with ``emit_rgba`` against JAX's XLA path and its
Pallas path with ``ENABLE_FUSED_COMPOSITE`` on.

Geometry: 384x64 for the kernel, 384x16 for channel frames (JAX's B15
gate: width % 48 == 0 and % 128 == 0).  Sources are v210 ramps rolled
per source, as JAX's own tests make them.

Contracts: RGB within 1e-4 of the Pallas kernel (its bf16 hi/lo
products); the alpha equal to the bit to JAX's ``_top_alpha_fixup``, and
to B15's where B15 agrees with it (B15 rounds its texel coordinate on
its own: 3.05e-5 on one feather column for one matrix here); channel
frames within 1 code, the ``emit_rgba`` frame within 2e-4 carrying the
top layer's alpha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_composite import composite_supported, make_composite_program
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops import packed_warp as PW
from phaneron_tpu_torch.ops.warp import warp_alpha_vectors
from torch_parity import max_code_delta, words_to_planes

torch.set_num_threads(1)

W = 384
V210 = jget_format("v210")


def _mats(w: int, h: int) -> list:
    """bench.py composite_step's four layer matrices."""
    return [transform_matrix(w, h, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i) for i in range(4)]


def _sources(w: int, h: int, n: int) -> list:
    """n distinct v210 word frames: the ramp rolled by 7 rows a source."""
    base = np.asarray(V210.fill_buf(w, h)[0])
    return [np.roll(base, 7 * k, axis=0) for k in range(n)]


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(words, copy=True).view(np.int32))


@pytest.mark.parametrize("layer_cfg", [(2, 1), (2, 2, 2, 2)])
def test_packed_kind_top_alpha_matches_make_composite_program(layer_cfg):
    """B15's counterpart: the plain version's RGB within 1e-4 of the
    Pallas kernel; its alpha, the top layer's wy x wx, equal to JAX's
    _top_alpha_fixup to the bit, and to B15's rsum x csum wherever B15
    agrees with that fix-up."""
    h = 64
    mats = [m for m, _ in zip(_mats(W, h), layer_cfg)]
    mixes = [np.float32(0.3 + 0.1 * i) if n == 2 else None for i, n in enumerate(layer_cfg)]
    srcs = _sources(W, h, sum(layer_cfg))
    got = PW.packed_composite_plain(
        [_t(s) for s in srcs], layer_cfg, [torch.from_numpy(m) for m in mats],
        [None if m is None else torch.tensor(m) for m in mixes], src_kind="packed", size=(W, h),
        emit="rgba", alpha="top",
    ).numpy()
    prog = make_composite_program(h, W, tuple((n, bucket_of(m)) for n, m in zip(layer_cfg, mats)),
                                  interpret=True)
    want = np.asarray(prog([jnp.asarray(words_to_planes(s)) for s in srcs],
                           jnp.stack([jnp.asarray(m) for m in mats]),
                           jnp.asarray([1.0 if m is None else m for m in mixes], jnp.float32)))
    assert got.shape == want.shape == (4, h, W)
    assert np.abs(got[:3] - want[:3]).max() <= 1e-4
    spec = jpipe.ChannelSpec(W, h, "v210", layers=())
    fixed = np.asarray(jpipe._top_alpha_fixup(jnp.zeros((4, h, W), jnp.float32), spec,
                                              {"layers": [{"matrix": jnp.asarray(m)} for m in mats]},
                                              len(mats) - 1))
    assert got[3].tobytes() == fixed[3].tobytes()
    # B15 rounds its own texel coordinate: where it agrees with JAX's
    # fix-up (every pixel for the top matrix of the 4-layer stack) the
    # port equals it to the bit; on the one feather column where it does
    # not (column 356 under the 2-layer stack's top matrix, scale 0.9 and
    # offset_x 0.023), by 3.05e-5
    same = want[3] == fixed[3]
    assert np.array_equal(got[3][same], want[3][same])
    assert same.all() if layer_cfg == (2, 2, 2, 2) else np.abs(got[3] - want[3]).max() <= 3.1e-5
    # coverage and top differ only in alpha
    cover = PW.packed_composite_plain(
        [_t(s) for s in srcs], layer_cfg, [torch.from_numpy(m) for m in mats],
        [None if m is None else torch.tensor(m) for m in mixes], src_kind="packed", size=(W, h), emit="rgba",
    ).numpy()
    assert np.array_equal(cover[:3], got[:3])
    assert np.array_equal(cover[3], PW.coverage([(None, *warp_alpha_vectors(h, W, torch.from_numpy(m)))
                                                 for m in mats]).numpy())


# ------------------------------------------------------- channel frames

CH = 16


def progressive(out_format: str, emit_rgba: bool, pallas: bool):
    """(JAX spec, numpy params) of bench.py composite_step at W x CH: 4 DVE
    + dissolve layers over 8 distinct v210 sources."""
    mats = _mats(W, CH)
    layers = tuple(
        jpipe.LayerSpec("v210", transition="dissolve", src_b_format="v210", has_transform=True,
                        axis_aligned=True, warp_bucket=bucket_of(m) if pallas else -1)
        for m in mats)
    spec = jpipe.ChannelSpec(W, CH, out_format, layers=layers, emit_rgba=emit_rgba, pallas_stages=pallas)
    srcs = _sources(W, CH, 8)
    params = {"layers": [{"src": [srcs[2 * i]], "src_b": [srcs[2 * i + 1]], "matrix": m,
                          "mix": np.float32(0.4 + 0.05 * i)} for i, m in enumerate(mats)]}
    return spec, params


def _jax(params: dict, pallas: bool) -> dict:
    """v210 words for JAX, host-split into (4, H, G) planes for the Pallas
    path (what its packed kinds read)."""
    leaf = lambda v: ([jnp.asarray(words_to_planes(p) if pallas else p) for p in v] if isinstance(v, list)
                      else jnp.asarray(v))
    return {"layers": [{k: leaf(v) for k, v in lp.items()} for lp in params["layers"]]}


def _delta(fmt: str, got, want) -> int:
    if fmt == "v210":
        return max_code_delta(words_to_numpy(got[0]), np.asarray(want[0]), W, CH)
    return max(int(np.abs(g.numpy().astype(np.int64) - np.asarray(x).astype(np.int64)).max())
               for g, x in zip(got, want))


@pytest.mark.parametrize("out_format,emit_rgba", [("yuv422p10le", False), ("v210", True)])
def test_progressive_frame_matches_both_jax_paths(out_format, emit_rgba, monkeypatch):
    """The whole stack is one packed-kind run with the top layer's alpha:
    an 'rgba' launch packed by B11 into yuv422p10le, a 'both' launch into
    v210 under emit_rgba, with no torch combine or alpha fix-up.  Within 1
    code of JAX's XLA path and of its Pallas path, where
    make_composite_program composites the stack (ENABLE_FUSED_COMPOSITE);
    the emit_rgba frame within 2e-4 of both, alpha the top layer's."""
    monkeypatch.setattr(jpipe, "ENABLE_FUSED_COMPOSITE", True)
    spec, params = progressive(out_format, emit_rgba, pallas=False)
    tspec = spec_from_fields(spec._asdict())
    tparams = params_from_numpy(params, "cpu")
    assert tpipe._packed_composite_run(tspec, tparams) == (0, 4, "both" if emit_rgba else "rgba", "packed", "top")
    out = tpipe.make_channel_program(tspec)(tparams)
    got = out["packed"] if emit_rgba else out
    for pallas in (False, True):
        jspec, _ = progressive(out_format, emit_rgba, pallas)
        assert composite_supported(jspec) == pallas
        want = jpipe.make_channel_program(jspec)(_jax(params, pallas))
        assert _delta(out_format, got, want["packed"] if emit_rgba else want) <= 1
        if emit_rgba:
            assert np.abs(out["rgba"].numpy() - np.asarray(want["rgba"])).max() <= 2e-4
    if emit_rgba:
        wy, wx = warp_alpha_vectors(CH, W, tparams["layers"][-1]["matrix"])
        assert torch.equal(out["rgba"][3], wy[:, None] * wx[None, :])
        assert torch.equal(K.v210_pack(out["rgba"]), out["packed"][0])
