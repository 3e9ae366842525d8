"""B6, the packed warp (ops/packed_warp.py packed_warp), at the edges of its
kernel's decoded windows: its plain version, which chip_smoke.py holds
the kernel's window and direct branches to (max |delta| 0), against
phaneron_tpu's make_packed_warp_program / make_packed_warp_pair_program
(Pallas, interpret mode on the CPU) and its XLA staged path, under a
flip, the media picture in picture at scale 0.5, offsets past the frame
and a box at scale 0.25 (whose windows exceed the kernel's limit).

768x16, the geometry the TPU gates admit (packed_warp_fits).  Contract,
as tests/test_torch_packed_source.py: <= 1 code after the pack (the TPU
kernel premixes a shared-matrix pair before one warp and runs the warp as
bf16 hi/lo products; the port decodes exactly and mixes after the
warp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.geometry import transform_matrix, warp_axis_aligned
from phaneron_tpu.ops.pallas_packed_warp import (
    make_packed_warp_pair_program,
    make_packed_warp_program,
    packed_warp_fits,
)
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops import packed_warp as PW
from torch_parity import max_code_delta, random_words, words_to_planes

torch.set_num_threads(1)

W, H = 768, 16
EDGE = {  # label -> transform_matrix keywords
    "flip_hv": dict(flip_h=True, flip_v=True, scale_x=1.3, scale_y=0.8),
    "pip_0.5": dict(scale_x=0.5, scale_y=0.5, offset_x=0.2, offset_y=-0.15),  # the media channel's box
    "off_frame_part": dict(scale_x=0.7, scale_y=0.6, offset_x=0.45, offset_y=-0.4),
    "minify_0.25": dict(scale_x=0.25, scale_y=0.25, offset_x=0.1),
}
MIX = np.float32(0.35)


def _t(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _codes_delta(a, b) -> int:
    """Code delta of two (4, H, W) RGBA frames after the same v210 pack."""
    pack = lambda f: words_to_numpy(K.v210_pack_plain(torch.from_numpy(np.array(f))))
    return max_code_delta(pack(a), pack(b), W, H)


def _jax_xla_warp(words, mats, mix):
    """JAX's staged path: XLA unpack (4 ch), warp_axis_aligned, mix."""
    up = jpipe.make_unpack_program("v210", W, H, "709", "709")
    frames = [warp_axis_aligned(up([jnp.asarray(w)]), jnp.asarray(m)) for w, m in zip(words, mats)]
    return np.asarray(frames[0] if mix is None else frames[0] * mix + frames[1] * (1.0 - mix))


@pytest.mark.parametrize("case", sorted(EDGE))
@pytest.mark.parametrize("mode", ["single", "distinct"])
def test_packed_warp_at_window_edges_within_one_code_of_jax(case, mode):
    """A single warp, and a dissolve pair under two matrices (the second
    the first at 1.2 times its x scale) over full-range random words, the
    plain version (a CPU call) against JAX's Pallas program and XLA
    path."""
    rng = np.random.default_rng(len(case) + 7 * len(mode))
    a, b = random_words(rng, W, H), random_words(rng, W, H)
    kw = EDGE[case]
    m = transform_matrix(W, H, **kw).astype(np.float32)
    if mode == "single":
        assert packed_warp_fits(H, W, bucket_of(m), 1)
        want = make_packed_warp_program(H, W, bucket_of(m), interpret=True)(
            jnp.asarray(words_to_planes(a)), jnp.asarray(m))
        got = PW.packed_warp(_t(a), _t(m), W, H)
        xla = _jax_xla_warp([a], [m], None)
    else:
        mb = transform_matrix(W, H, **dict(kw, scale_x=1.2 * kw.get("scale_x", 1.0))).astype(np.float32)
        bucket = bucket_of(m, mb)
        assert packed_warp_fits(H, W, bucket, 2)
        pair = make_packed_warp_pair_program(H, W, bucket, same_mat=False, interpret=True)
        want = pair(jnp.asarray(words_to_planes(a)), jnp.asarray(words_to_planes(b)),
                    jnp.asarray(m), jnp.asarray(mb), jnp.float32(MIX))
        got = PW.packed_warp(_t(a), _t(m), W, H, _t(b), torch.tensor(MIX), _t(mb))
        xla = _jax_xla_warp([a, b], [m, mb], MIX)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, H, W)
    assert _codes_delta(got.numpy(), np.asarray(want)) <= 1
    assert _codes_delta(got.numpy(), xla) <= 1


def test_shared_matrix_pair_in_the_picture_in_picture_within_one_code_of_jax():
    """The media channel's box as a shared-matrix dissolve pair (the TPU
    kernel's premix) against make_packed_warp_pair_program(same_mat=True)
    and the XLA path."""
    rng = np.random.default_rng(91)
    a, b = random_words(rng, W, H), random_words(rng, W, H)
    m = transform_matrix(W, H, **EDGE["pip_0.5"]).astype(np.float32)
    assert packed_warp_fits(H, W, bucket_of(m), 1)
    pair = make_packed_warp_pair_program(H, W, bucket_of(m), same_mat=True, interpret=True)
    want = pair(jnp.asarray(words_to_planes(a)), jnp.asarray(words_to_planes(b)),
                jnp.asarray(m), jnp.asarray(m), jnp.float32(MIX))
    got = PW.packed_warp(_t(a), _t(m), W, H, _t(b), torch.tensor(MIX))
    assert _codes_delta(got.numpy(), np.asarray(want)) <= 1
    assert _codes_delta(got.numpy(), _jax_xla_warp([a, b], [m, m], MIX)) <= 1
