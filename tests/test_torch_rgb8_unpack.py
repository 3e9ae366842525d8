"""rgb8_unpack, the decode of rgba8 and bgra8 source planes (ops/kernels.py,
csrc/rgb8_unpack.cu).

On the CPU: the plain version is ops/io.py to_rgba for the RGB formats,
bit for bit, over every code in each channel; the wrapper runs it for
CPU tensors; the frame program sends RGB slots to the stage and a band's
rows to it row by row.  On the card (marker ``card``, skipped without
CUDA): the kernel equals the plain version to the bit, one launch a call.
"""

import numpy as np
import pytest
import torch

from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.ops import io as tio
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops.coeffs import make_loader
from phaneron_tpu_torch.ops.formats import get_format

torch.set_num_threads(1)

FORMATS = ["rgba8", "bgra8"]
COL_PAIRS = [("709", "709"), ("sRGB", "709"), ("2020", "709")]
SIZES = [(16, 16), (19, 17)]  # even; odd in both


def _every_code_plane(width, height, rng):
    """(H, W, 4) uint8 whose every channel holds each of the 256 codes."""
    n = width * height
    chans = [np.concatenate([rng.permutation(256), rng.integers(0, 256, n - 256)]) for _ in range(4)]
    return torch.from_numpy(np.stack(chans, axis=-1).astype(np.uint8).reshape(height, width, 4))


@pytest.mark.parametrize("gamma_mode", ["analytic", "lut"])
@pytest.mark.parametrize("col_spec,out_col_spec", COL_PAIRS)
@pytest.mark.parametrize("fmt_name", FORMATS)
def test_plain_is_to_rgba_over_every_code(fmt_name, col_spec, out_col_spec, gamma_mode):
    rng = np.random.default_rng(7)
    fmt = get_format(fmt_name)
    for w, h in SIZES:
        plane = _every_code_plane(w, h, rng)
        loader = make_loader(fmt.INFO, col_spec, out_col_spec, gamma_mode)
        want = tio.to_rgba(fmt, [plane], loader, w, h)
        got = K.rgb8_unpack_plain([plane], w, h, col_spec, out_col_spec, fmt_name, gamma_mode)
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, h, w)
        assert torch.equal(got, want)
        # the byte order: R, G, B, A codes at the format's byte positions
        order = fmt.CHANNEL_ORDER
        table = loader.gamma.at(torch.arange(256) * 257)
        assert torch.equal(got[3], table[plane[..., order[3]].long()])


def test_cpu_wrapper_runs_the_plain_version():
    rng = np.random.default_rng(8)
    before = K.rgb8_unpack.launches
    for fmt_name in FORMATS + ["rgba", "bgra"]:
        plane = _every_code_plane(19, 17, rng)
        got = K.rgb8_unpack([plane], 19, 17, "sRGB", "709", fmt_name)
        assert torch.equal(got, K.rgb8_unpack_plain([plane], 19, 17, "sRGB", "709", fmt_name))
    assert K.rgb8_unpack.launches == before
    with pytest.raises(ValueError, match="not one of"):
        K.rgb8_unpack([plane], 19, 17, fmt_name="nv12")
    with pytest.raises(ValueError, match="one plane"):
        K.rgb8_unpack([plane, plane], 19, 17)


@pytest.mark.parametrize("fmt_name", ["rgba8", "bgra", "yuv420p", "yuv422p10le"])
def test_unpack_planes_sends_rgb_formats_to_their_stage(fmt_name):
    """``_unpack_planes`` (the frame program's and the stage programs')
    gives RGB formats to ``st.rgb8_unpack`` with the spec's gamma mode,
    and nothing else to it."""
    calls = []

    def spy(*args):
        calls.append(args)
        return K.rgb8_unpack_plain(*args)

    st = tpipe._PLAIN._replace(rgb8_unpack=spy)
    w, h = 20, 6
    rng = np.random.default_rng(9)
    planes = [torch.from_numpy(rng.integers(0, 1024 if dt == np.uint16 else 256, s).astype(dt))
              for s, dt in get_format(fmt_name).plane_shapes(w, h)]
    frame = tpipe._unpack_planes(st, fmt_name, planes, w, h, "sRGB", "709", "lut")
    assert tuple(frame.shape) == (4, h, w)
    if fmt_name in K.RGB8:
        assert len(calls) == 1 and calls[0][1:] == (w, h, "sRGB", "709", fmt_name, "lut")
        assert calls[0][0] is planes
    else:
        assert calls == []


def test_channel_program_decodes_rgb_slots_through_the_stage(monkeypatch):
    """A channel with an rgba8 and a bgra8 layer calls the kernels' stage
    once a slot a frame, and its frame equals the plain program's."""
    calls = []

    def spy(*args):
        calls.append(args[5])
        return K.rgb8_unpack(*args)

    monkeypatch.setattr(tpipe, "_KERNELS", tpipe._KERNELS._replace(rgb8_unpack=spy))
    w, h = 32, 8
    rng = np.random.default_rng(10)
    spec = tpipe.ChannelSpec(w, h, "yuv422p10le", (tpipe.LayerSpec("bgra8"), tpipe.LayerSpec("rgba8")))
    params = {"layers": [{"src": [_every_code_plane(w, h, rng)]} for _ in range(2)]}
    got = tpipe._channel_frame(spec, params)
    want = tpipe._channel_frame(spec, params, plain=True)
    assert calls == ["bgra8", "rgba8"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("fmt_name", FORMATS)
def test_band_rows_equal_the_whole_frames_rows(fmt_name):
    """``_plane_rows`` unpacks a band's rows of an RGB plane (the decode
    is row-local): equal to those rows of the whole frame, one stage call
    a band."""
    w, h = 19, 17
    rng = np.random.default_rng(11)
    plane = _every_code_plane(w, h, rng)
    spec = tpipe.ChannelSpec(w, h, "v210", (tpipe.LayerSpec(fmt_name),), col_spec="sRGB")
    whole = K.rgb8_unpack_plain([plane], w, h, "sRGB", "709", fmt_name)
    calls = []

    def spy(*args):
        calls.append(args[2])
        return K.rgb8_unpack(*args)

    st = tpipe._KERNELS._replace(rgb8_unpack=spy)
    fetch = lambda leaf, lo, hi: leaf[lo:hi]
    for lo, hi in ((0, 5), (5, 6), (6, 17), (3, 14)):
        band = tpipe.Band(lo, hi, h, torch.device("cpu"), {}, fetch)
        rows = tpipe._plane_rows(st, fmt_name, [plane], lo, hi, w, h, spec, band)
        assert torch.equal(rows, whole[:, lo:hi])
    assert calls == [5, 1, 11, 11]


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("fmt_name", FORMATS)
@pytest.mark.parametrize("w,h", [(3840, 2160), (1920, 1080), (1917, 1079), (5, 3)])
def test_kernel_equals_plain_on_the_card(cuda, fmt_name, w, h):
    """Max |kernel - plain| 0.0 on random planes at UHD, 1080p, an odd
    width and a partial quad, both gamma modes and two col_spec pairs,
    also on a plane 4 bytes off its 16-byte alignment; one launch a
    call."""
    rng = np.random.default_rng(w + h)
    plane = torch.from_numpy(rng.integers(0, 256, (h, w, 4), dtype=np.uint8)).to(cuda)
    buf = torch.empty(plane.numel() + 4, dtype=torch.uint8, device=cuda)
    moved = buf[4:].view(plane.shape)
    moved.copy_(plane)
    for col_spec, gamma_mode in (("709", "analytic"), ("sRGB", "lut")):
        want = K.rgb8_unpack_plain([plane], w, h, col_spec, "709", fmt_name, gamma_mode)
        for src in (plane, moved):
            before = K.rgb8_unpack.launches
            got = K.rgb8_unpack([src], w, h, col_spec, "709", fmt_name, gamma_mode)
            assert K.rgb8_unpack.launches == before + 1
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) == 0.0
