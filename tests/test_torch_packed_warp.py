"""Port parity for the packed composite in its rgb3 mode (ops/packed_warp.py
against phaneron_tpu/ops/pallas_packed_warp.py make_packed_composite_program
with src_kind='rgb3', emit='packed', in interpret mode on the CPU), and
the channel program's dispatch of whole-stack rgb3 DVE runs to it.

Contracts: <= 1 code against the TPU kernel (it premixes dissolve pairs
before one warp and runs the warp as bf16 hi/lo products, ~2^-17; the
port mixes after the warp, in float32, as its staged path does); the
channel program's output equals the plain composite bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_packed_warp import make_packed_composite_program, packed_composite_fits
from phaneron_tpu.ops.pallas_kernels import planes_to_words
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu.runtime.frame import RGBA_F32
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import packed_warp as PW
from torch_parity import max_code_delta

torch.set_num_threads(1)

# the smallest geometry whose VMEM plan the TPU kernel accepts
# (packed_composite_fits is False at 256x64)
W, H = 384, 32
MAT_KW = [
    dict(scale_x=0.9, scale_y=0.9, offset_x=0.02),
    dict(scale_x=0.8, scale_y=0.85, offset_y=-0.05),
    dict(scale_x=0.95, scale_y=0.9, anchor_x=0.1, offset_x=0.03),
    dict(scale_x=0.7, scale_y=0.75, offset_x=-0.1, offset_y=0.08),
]


def _inputs(layer_cfg, seed):
    rng = np.random.default_rng(seed)
    srcs = [rng.random((3, H, W), dtype=np.float32) for _ in range(sum(layer_cfg))]
    mats = [transform_matrix(W, H, **MAT_KW[m]).astype(np.float32) for m in range(len(layer_cfg))]
    mixes = [np.float32(0.3 + 0.1 * m) if n == 2 else None for m, n in enumerate(layer_cfg)]
    return srcs, mats, mixes


def _jax_composite(layer_cfg, srcs, mats, mixes):
    bucket = max(bucket_of(m) for m in mats)
    assert packed_composite_fits(H, W, bucket, len(layer_cfg), emit="packed", src_kind="rgb3")
    prog = make_packed_composite_program(
        H, W, bucket, tuple(layer_cfg), src_kind="rgb3", interpret=True
    )
    out = prog(
        [jnp.asarray(s) for s in srcs], jnp.stack([jnp.asarray(m) for m in mats]),
        jnp.stack([jnp.float32(1.0 if x is None else x) for x in mixes]),
    )
    return np.asarray(planes_to_words(out))


def _port(srcs, mats, mixes, layer_cfg):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a, copy=True))
    return PW.packed_composite([t(s) for s in srcs], layer_cfg, [t(m) for m in mats],
                               [t(x) for x in mixes])


@pytest.mark.parametrize("layer_cfg", [(2, 2, 2, 2), (2, 1, 2)])
def test_packed_composite_within_one_code_of_tpu_kernel(layer_cfg):
    """4 dissolve layers (the default load's tick) and a cut between two
    dissolves, distinct axis-aligned matrices, random opaque RGB."""
    srcs, mats, mixes = _inputs(layer_cfg, seed=len(layer_cfg))
    want = _jax_composite(layer_cfg, srcs, mats, mixes)
    got = _port(srcs, mats, mixes, layer_cfg)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert max_code_delta(words_to_numpy(got), want, W, H) <= 1


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    layer_cfg = (2, 1)
    srcs, mats, mixes = _inputs(layer_cfg, seed=5)
    before = PW.packed_composite.launches
    got = _port(srcs, mats, mixes, layer_cfg)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a, copy=True))
    want = PW.packed_composite_plain([t(s) for s in srcs], layer_cfg, [t(m) for m in mats],
                                     [t(x) for x in mixes])
    assert torch.equal(got, want)
    assert PW.packed_composite.launches == before
    assert _build._load.cache_info().currsize == 0
    meta = [torch.empty((3, 8, 16), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="no kernel for device"):
        PW.packed_composite(meta, (2, 1), [torch.eye(3)] * 2, [0.5, None])
    with pytest.raises(ValueError, match="1 or 2"):
        PW.packed_composite(meta, (3,), [torch.eye(3)], [0.5])
    with pytest.raises(ValueError, match="sources for layer_cfg"):
        PW.packed_composite(meta[:2], (2, 1), [torch.eye(3)] * 2, [0.5, None])
    with pytest.raises(ValueError, match="needs its mix"):
        PW.packed_composite(meta, (2, 1), [torch.eye(3)] * 2, [None, None])


def _dve(src=RGBA_F32, **kw):
    return tpipe.LayerSpec(src, has_transform=True, axis_aligned=True, src_opaque=True, **kw)


DISSOLVE = _dve(transition="dissolve", src_b_format=RGBA_F32)


@pytest.mark.parametrize(
    "layers,fused",
    [
        ((DISSOLVE,) * 4, True),  # the interlaced default load's tick
        ((DISSOLVE, _dve(), DISSOLVE), True),
        ((DISSOLVE,), False),  # one layer: no run
        ((DISSOLVE, tpipe.LayerSpec(RGBA_F32)), False),  # a layer without a DVE
        ((DISSOLVE, _dve(transition="dissolve", src_b_format=RGBA_F32, warp_same_mat=False)),
         False),
    ],
)
def test_channel_program_runs_whole_stack_rgb3_runs_as_one_composite(layers, fused):
    """Whole-stack rgb3 DVE runs (>= 2 layers, cuts or same-matrix
    dissolves, axis-aligned) go to packed_composite, and the program's
    words equal it; other structures stay staged."""
    spec = tpipe.ChannelSpec(W, H, "v210", layers=layers)
    rng = np.random.default_rng(len(layers))
    params = {"layers": []}
    for i, ls in enumerate(layers):
        lp = {"src": torch.from_numpy(rng.random((3, H, W), dtype=np.float32)),
              "matrix": torch.from_numpy(transform_matrix(W, H, **MAT_KW[i]).astype(np.float32)),
              "mix": torch.tensor(0.4 + 0.1 * i)}
        if ls.transition == "dissolve":
            lp["src_b"] = torch.from_numpy(rng.random((3, H, W), dtype=np.float32))
            lp["matrix_b"] = lp["matrix"]
        params["layers"].append(lp)
    srcs = tpipe._sources(spec, params, tpipe._PLAIN)
    run = tpipe._packed_composite_run(spec, params)
    assert (run is not None) == fused
    (got,) = tpipe.make_channel_program(spec)(params)
    if fused:
        assert run == (0, len(layers), "packed", "rgb3", "top")
        args = tpipe._packed_composite_args(spec, params, srcs, run)
        assert args[1] == tuple(2 if ls.transition == "dissolve" else 1 for ls in layers)
        assert torch.equal(got, PW.packed_composite_plain(*args))
    # a dissolve over a 4-channel and a 3-channel frame is no composite kind
    four = {"layers": [dict(lp, src=torch.cat([lp["src"], torch.ones_like(lp["src"][:1])]))
                       for lp in params["layers"]]}
    assert tpipe._packed_composite_run(spec, four) is None
