"""The port's mesh and shardings (phaneron_tpu_torch/parallel/mesh.py)
against the JAX package's (phaneron_tpu/parallel/mesh.py) on JAX's
virtual 8-device CPU mesh: the same (ch, sp) split, and for the same
numpy params each shard's place in the leaf (JAX's
``addressable_shards[i].index``) and contents, exactly.  Replicated leaves
are whole on every shard; a leaf resharded onto another mesh keeps its
rows."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from phaneron_tpu.ops.formats import get_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.parallel import mesh as jmesh
from phaneron_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

W, H = 96, 64


def _bounds(index, shape) -> tuple:
    """A shard index as explicit (start, stop) pairs."""
    return tuple((sl.start or 0, shape[d] if sl.stop is None else sl.stop) for d, sl in enumerate(index))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _same_shards(jleaf, tleaf, path) -> None:
    assert isinstance(tleaf, tmesh.Sharded), path
    jshards = jleaf.addressable_shards
    assert len(jshards) == len(tleaf.shards), path
    assert tuple(jleaf.shape) == tleaf.shape, path
    for i, js in enumerate(jshards):
        assert _bounds(tleaf.index(i), tleaf.shape) == _bounds(js.index, jleaf.shape), (path, i)
        want = np.asarray(js.data)
        got = tleaf.shards[i].tensor.numpy()
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=str((path, i)))


def _sp_params():
    """One channel's params of every leaf kind: v210 and planar planes, an
    rgba_f32 frame, a 3-frame ring, a matrix pair, a mix and a parity."""
    rng = np.random.default_rng(3)
    v210, y422 = get_format("v210"), get_format("yuv422p8")
    return {"layers": [
        {"src": [np.asarray(p) for p in v210.fill_buf(W, H)],
         "src_b": [rng.integers(0, 2 ** 30, np.asarray(p).shape).astype(np.uint32) for p in v210.fill_buf(W, H)],
         "matrix": transform_matrix(W, H, scale_x=0.9, offset_x=0.05),
         "matrix_b": transform_matrix(W, H, scale_y=1.3, offset_y=0.05),
         "mix": np.float32(0.25)},
        {"src": [np.asarray(p) for p in y422.fill_buf(W, H)]},
        {"src": rng.random((4, H, W), dtype=np.float32)},
        {"src_ring": tuple(rng.random((3, H, W), dtype=np.float32) for _ in range(3)),
         "parity": np.int32(1), "matrix": transform_matrix(W, H, flip_v=True)},
    ]}


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_split_matches_jax(n):
    """make_mesh's default (ch, sp) split equals JAX's for n = 1..8."""
    want = jmesh.make_mesh(jax.devices()[:n]).shape
    got = tmesh.make_mesh(["cpu"] * n)
    assert got.shape == dict(want)
    assert len(got.flat) == n


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_params_sp_matches_jax(n):
    """shard_params_sp: each leaf's shards take JAX's rows and contents."""
    params = _sp_params()
    jout = jmesh.shard_params_sp(params, jmesh.make_sp_mesh(jax.devices()[:n]))
    tout = tmesh.shard_params_sp(params, tmesh.make_sp_mesh(["cpu"] * n))
    jl, tl = dict(_leaves(jout)), dict(_leaves(tout))
    assert jl.keys() == tl.keys()
    for path in jl:
        _same_shards(jl[path], tl[path], path)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_channel_params_matches_jax(n):
    """shard_channel_params over a (ch, sp) mesh: entry()'s params stacked
    over the 'ch' axis, as the multichip dry run shards them."""
    jdev = jax.devices()[:n]
    jm, tm = jmesh.make_mesh(jdev), tmesh.make_mesh(["cpu"] * n)
    _, params = graft._example_spec_and_params(W, H)
    n_ch = jm.shape["ch"]
    stacked = jax.tree.map(lambda x: np.stack([np.asarray(x)] * n_ch), params)
    jout = jmesh.shard_channel_params(stacked, jm)
    tout = tmesh.shard_channel_params(stacked, tm)
    jl, tl = dict(_leaves(jout)), dict(_leaves(tout))
    assert jl.keys() == tl.keys()
    for path in jl:
        _same_shards(jl[path], tl[path], path)


def test_replicated_keys_whole_on_every_shard():
    """matrix, matrix_b, mix, parity and mask_mix are whole on every band,
    whatever their shape, with the host copy a band works windows out
    from; a (C, H, W) frame under any other name is split."""
    mesh = tmesh.make_sp_mesh(["cpu"] * 4)
    frame = np.ones((4, H, W), np.float32)
    out = tmesh.shard_params_sp({k: frame for k in ("matrix", "matrix_b", "mix", "parity", "mask_mix", "x")},
                                mesh)
    for key, leaf in out.items():
        if key == "x":
            assert leaf.axis == 1 and [sh.tensor.shape[1] for sh in leaf.shards] == [H // 4] * 4
            continue
        assert leaf.axis is None and leaf.host is frame
        for i, sh in enumerate(leaf.shards):
            assert tuple(sh.tensor.shape) == frame.shape and _bounds(leaf.index(i), frame.shape) == (
                (0, 4), (0, H), (0, W))


@pytest.mark.parametrize("src, dst", [(2, 4), (4, 3), (3, 8)])
def test_reshard_keeps_rows(src, dst):
    """A leaf sharded over one mesh and resharded onto another (the
    cross-mesh ROUTE) holds the same rows, band by band, and gathers to
    the leaf; a band's rows inside one shard are a view of it.  Rows that
    span shards are a view of the frame they were cut from where every
    shard lies on one device, else the shards' pieces joined."""
    rng = np.random.default_rng(src * 10 + dst)
    frame = rng.random((4, 72, W), dtype=np.float32)
    a = tmesh.shard_params_sp({"src": frame}, tmesh.make_sp_mesh(["cpu"] * src))["src"]
    b = tmesh.shard_params_sp({"src": a}, tmesh.make_sp_mesh(["cpu"] * dst))["src"]
    assert b.mesh.shape == {"sp": dst}
    for sh, (r0, r1) in zip(b.shards, tmesh.band_bounds(72, dst)):
        assert sh.row0 == r0 and torch.equal(sh.tensor, torch.from_numpy(frame[:, r0:r1]))
    assert torch.equal(b.gather("cpu"), torch.from_numpy(frame))
    own = a.shards[1]
    view = a.rows(own.row0, own.row0 + 2, "cpu")
    assert view.data_ptr() == own.tensor.data_ptr()
    span = a.rows(own.row0 - 3, own.row0 + 3, "cpu")
    assert span.data_ptr() == a.whole.narrow(1, own.row0 - 3, 6).data_ptr()
    a.whole = None  # as band outputs, or shards on several devices, are held
    joined = a.rows(own.row0 - 3, own.row0 + 3, "cpu")
    assert joined.data_ptr() != span.data_ptr() and torch.equal(joined, span)
    c = tmesh.shard_params_sp({"src": a}, tmesh.make_sp_mesh(["cpu"] * dst))["src"]
    assert c.whole is None and torch.equal(c.gather("cpu"), torch.from_numpy(frame))


def test_default_devices_are_the_cards():
    """make_mesh() without devices lays out the card's (cuda:(i % count));
    with no card seen it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert tmesh.make_mesh().flat == tmesh.card_devices()
        assert tmesh.card_devices(8)[-1] == torch.device("cuda", 7 % torch.cuda.device_count())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
