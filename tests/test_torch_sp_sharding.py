"""Row-sharded (sp) channels of the port (the counterparts of
tests/test_sp_sharding.py at small sizes), on the CPU: bands of
``["cpu"] * n`` run the channel program's plain versions band by band
(parallel/bands.py), against the same channel unsharded and against the
JAX package's sp channel on JAX's virtual devices.

Contracts: a banded channel equals its sp=1 twin bit for bit (0 codes)
through the staged, packed-composite and fused routes and the in-program
yadif ring, rotated layers (B14's band form) and 4:2:0 outputs whose
sp bands would hold an odd number of rows (their bands snap to even
rows); against JAX, the structure tolerances of
tests/test_torch_runtime.py (1 code, 0 expected).  Also the ROUTE between
two meshes (out of a snapped 4:2:0 channel too), the server's placement
of sp / chips groups, the one refusal (a height sp does not divide, as
in JAX), and the multichip, UHD and ch x sp ROUTE dry runs at 96x64
against the JAX package's programs on the same inputs."""

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from conftest import run_async as run
from phaneron_tpu.config import VideoFormat as JVideoFormat
from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.parallel import mesh as jmesh
from phaneron_tpu.producer import producer as jproducer
from phaneron_tpu.producer import test_pattern as jpattern
from phaneron_tpu.runtime import channel as jchannel
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.config import VideoFormat
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.parallel import dryrun
from phaneron_tpu_torch.parallel.mesh import make_mesh, make_multi_channel_program, shard_channel_params
from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry
from phaneron_tpu_torch.producer.route import make_route_factory
from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
from phaneron_tpu_torch.runtime.channel import Channel
from phaneron_tpu_torch.runtime.types import TransitionSpec
from torch_parity import max_code_delta

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FMT_ARGS = dict(
    tiny=("tiny", 1, 96, 64, 96, 50, 1, 48000, 2),
    tiny_i=("tiny_i", 2, 256, 64, 256, 50, 1, 48000, 2),
    f72=("f72", 1, 96, 72, 96, 50, 1, 48000, 2),
)
# scenario -> (format, output format, what _load plays)
SCENARIOS = dict(bars=("tiny", "v210", "bars"), dve=("tiny", "v210", "dve"),
                 dissolve=("tiny", "v210", "dissolve"), interlaced=("tiny_i", "v210", "interlaced"),
                 rotated=("tiny", "v210", "rotated"), yuv420p_72=("f72", "yuv420p", "dve"),
                 nv12_72_rotated=("f72", "nv12", "rotated"))
CPU = lambda n: ["cpu"] * n
# configs/uhd_sp_sharded.json's 2160p5000 cut to 256x64 for the server test
tconfig.VIDEO_FORMATS.setdefault("tiny_sp5000", tconfig.VideoFormat("tiny_sp5000", 1, 256, 64, 256, 50, 1, 48000, 2))


async def _load(ch, scenario: str) -> None:
    """BARS; dve: BARS in a box over RAMP; dissolve: BARS mixing to RAMP
    (the fused v210 route); interlaced: dve on the tiny_i channel, its
    sources deinterlaced; rotated: RAMP under BARS turned 0.1 (B14)."""
    lp = LoadParams if isinstance(ch, Channel) else jproducer.LoadParams
    if scenario == "rotated":
        assert await ch.load_source(1, lp("RAMP"))
        ch.play(1)
        assert await ch.load_source(2, lp("BARS"))
        ch.play(2)
        assert ch.layer(2).set_rotation(0.1)
        return
    assert await ch.load_source(1, lp("BARS"))
    ch.play(1)
    if scenario in ("dve", "interlaced"):
        assert ch.layer(1).set_fill(0.05, 0.1, 0.8, 0.85)
        assert await ch.load_source(2, lp("RAMP"))
        ch.play(2)
    elif scenario == "dissolve":
        tr = TransitionSpec("dissolve", 6)
        if not isinstance(ch, Channel):
            from phaneron_tpu.runtime.types import TransitionSpec as JTransition

            tr = JTransition("dissolve", 6)
        assert await ch.load_source(1, lp("RAMP"), transition=tr)
        ch.play(1)


async def _frames(ch, n: int, words) -> list:
    out = []
    for _ in range(n):
        f = await ch.render_frame()
        out.append(words(f.packed[0]) if ch.out_format == "v210" else [np.asarray(p).copy() for p in f.packed])
    return out


def _port(scenario: str, sp_devices, n: int = 6) -> tuple:
    fmt_name, out_format, load = SCENARIOS[scenario]
    fmt = VideoFormat(*FMT_ARGS[fmt_name])

    async def main():
        ch = Channel(1, fmt, ProducerRegistry([create_test_pattern_producer]), out_format=out_format,
                     device="cpu", sp_devices=sp_devices)
        await _load(ch, load)
        frames = await _frames(ch, n, words_to_numpy)
        prog = ch._sp_programs[next(reversed(ch._sp_programs))] if ch._sp_mesh is not None else None
        return frames, ch._last_layer_specs, prog

    return run(main())


@pytest.mark.parametrize("scenario", ["bars", "dve", "dissolve", "interlaced", "rotated"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sp_channel_bit_equal_to_sp1(scenario, sp):
    """sp=2 and sp=4 against sp=1, 0 codes: a BARS channel, a DVE box over
    a RAMP layer, a dissolve (the fused route), interlaced sources,
    which an sp channel deinterlaces on the in-program yadif ring (its
    sp=1 twin takes the slot's pair route), and a rotated BARS layer over
    RAMP (B14's band form)."""
    want, _, _ = _port(scenario, None)
    got, specs, prog = _port(scenario, CPU(sp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [b["rows"] for b in prog.last_bands] == [(k * 64 // sp, (k + 1) * 64 // sp) for k in range(sp)]
    if scenario == "interlaced":
        assert all(s.deinterlace for s in specs.values())


@pytest.mark.parametrize("scenario", ["dve", "interlaced", "rotated", "yuv420p_72"])
def test_sp_channel_matches_jax_sp_channel(scenario):
    """The port's sp channel against the JAX package's on JAX's virtual
    devices (GSPMD, its XLA path), within 1 code (0 expected): a DVE box,
    interlaced sources, a rotated layer (sp=4), and a 72-row yuv420p
    output at sp=8, whose 9-row bands the port snaps to row pairs."""
    name, out_format, load = SCENARIOS[scenario]
    sp = 8 if scenario == "yuv420p_72" else 4
    got, _, _ = _port(scenario, CPU(sp), n=4)

    async def jax_side():
        ch = jchannel.Channel(1, JVideoFormat(*FMT_ARGS[name]),
                              jproducer.ProducerRegistry([jpattern.create_test_pattern_producer]),
                              out_format=out_format, sp_devices=jax.devices()[:sp], use_pallas=False)
        await _load(ch, load)
        return await _frames(ch, 4, lambda t: np.asarray(t))

    want = run(jax_side())
    w, h = FMT_ARGS[name][2], FMT_ARGS[name][3]
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        if out_format == "v210":
            assert max_code_delta(g, x, w, h) <= 1
            continue
        assert [p.shape for p in g] == [p.shape for p in x]
        for gp, xp in zip(g, x):
            assert np.abs(gp.astype(np.int32) - xp.astype(np.int32)).max() <= 1


def test_route_between_sp_meshes():
    """Channel A on two bands, channel B on two others routing A: A's frame
    reaches B as A's bands left it and is resharded band to band; B's
    words equal A's."""

    async def main():
        channels = {}
        reg = ProducerRegistry([make_route_factory(lambda n: channels.get(n)), create_test_pattern_producer])
        fmt = VideoFormat(*FMT_ARGS["tiny"])
        ch1 = Channel(1, fmt, reg, sp_devices=CPU(2))
        ch2 = Channel(2, fmt, reg, sp_devices=CPU(4))
        channels.update({1: ch1, 2: ch2})
        assert await ch1.load_source(1, LoadParams("BARS"))
        ch1.play(1)
        assert await ch2.load_source(1, LoadParams("route://1"))
        ch2.play(1)
        f1 = f2 = None
        for _ in range(4):
            f1 = await ch1.render_frame()
            f2 = await ch2.render_frame()
        routed = ch2.layer(1).cur.last.payload
        assert routed.mesh.shape == {"sp": 2}  # as A's bands left it
        return words_to_numpy(f1.packed[0]), words_to_numpy(f2.packed[0])

    a, b = run(main())
    np.testing.assert_array_equal(a, b)


def test_route_out_of_a_snapped_420_channel():
    """A 72-row nv12 channel at sp=8 (bands of 8 and 10 rows, snapped to
    row pairs) routed into a v210 channel at sp=4 (18-row bands): the
    frame reaches B as A's uneven bands left it and is resharded band to
    band; B's words equal those of the same two channels unsharded."""
    fmt = VideoFormat(*FMT_ARGS["f72"])

    async def main(sp_a, sp_b):
        channels = {}
        reg = ProducerRegistry([make_route_factory(lambda n: channels.get(n)), create_test_pattern_producer])
        ch1 = Channel(1, fmt, reg, out_format="nv12", device="cpu", sp_devices=sp_a)
        ch2 = Channel(2, fmt, reg, device="cpu", sp_devices=sp_b)
        channels.update({1: ch1, 2: ch2})
        assert await ch1.load_source(1, LoadParams("BARS"))
        ch1.play(1)
        assert ch1.layer(1).set_rotation(0.05)
        assert await ch2.load_source(1, LoadParams("route://1"))
        ch2.play(1)
        f2 = None
        for _ in range(4):
            await ch1.render_frame()
            f2 = await ch2.render_frame()
        routed = ch2.layer(1).cur.last.payload
        return words_to_numpy(f2.packed[0]), routed

    want, _ = run(main(None, None))
    got, routed = run(main(CPU(8), CPU(4)))
    np.testing.assert_array_equal(got, want)
    assert routed.mesh.shape == {"sp": 8}  # as A's bands left it
    assert [sh.tensor.shape[1] for sh in routed.shards] == [8, 10] * 4


@pytest.mark.parametrize("count, want", [(1, [0, 0, 0, 0]), (2, [0, 1, 0, 1])])
def test_server_sp_groups_wrap(monkeypatch, count, want):
    """configs/uhd_sp_sharded.json: both groups ([0..3] from sp 4 at chip
    0, and chips [4..7]) wrap to cuda:(j % device count), as the JAX server
    wraps them, on one device and on two."""
    from phaneron_tpu_torch.server import PhaneronServer

    cfg = tconfig.ServerConfig.load(ROOT / "configs" / "uhd_sp_sharded.json")
    server = PhaneronServer(cfg, device="cpu")
    server.device = None  # as PhaneronServer(cfg) places channels on a CUDA machine
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    for cc in cfg.channels:
        assert server._placement(cc) == (None, [torch.device("cuda", j) for j in want])


def test_server_sp_groups_under_the_cpu_override(tmp_path):
    """Under the server's device override an sp group is that device once a
    band, and the config's sp channels start and tick row-sharded."""
    from phaneron_tpu_torch.server import PhaneronServer

    cfg = tconfig.ServerConfig.load(ROOT / "configs" / "uhd_sp_sharded.json")
    server = PhaneronServer(cfg, device="cpu")
    for cc in cfg.channels:
        assert server._placement(cc) == (None, [torch.device("cpu")] * 4)
    tiny = [replace(cc, format="tiny_sp5000", device={}) for cc in cfg.channels]
    cfg = replace(cfg, channels=tiny, amcp_port=0, osc_listen_port=0)

    async def main():
        srv = PhaneronServer(cfg, device="cpu")
        try:
            await srv.start()
            ch = srv.channels[1]
            await ch.load_source(1, LoadParams("BARS"))
            ch.play(1)
            ch.running = False
            frame = await ch.render_frame()
            return ch._sp_mesh.shape, frame.packed[0].shape
        finally:
            await srv.shutdown()

    shape, plane = run(main())
    assert shape == {"sp": 4} and plane[0] == 64


def test_sp_refusals(monkeypatch):
    """The one refusal: ValueError for a height sp does not divide (JAX
    raises it too).  The structures the port refused before row-sharding
    took them now render, equal to sp=1: a 4:2:0 output whose sp bands
    would hold an odd number of rows (72 rows at sp=8, yuv420p and nv12;
    the bands snap to row pairs, 8 and 10 rows), and a rotated layer."""
    _count_rotate_calls(monkeypatch)
    reg = ProducerRegistry([create_test_pattern_producer])
    with pytest.raises(ValueError, match="not divisible"):
        Channel(1, VideoFormat("odd", 1, 96, 62, 96, 50, 1), reg, sp_devices=CPU(4))
    for scenario, sp in (("yuv420p_72", 8), ("nv12_72_rotated", 8), ("rotated", 2)):
        want, _, _ = _port(scenario, None, n=2)
        got, _, prog = _port(scenario, CPU(sp), n=2)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for gp, wp in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
                np.testing.assert_array_equal(gp, wp)
        rows = [b["rows"] for b in prog.last_bands]
        assert len(rows) == sp and rows[0][0] == 0 and rows[-1][1] == FMT_ARGS[SCENARIOS[scenario][0]][3]
        if scenario != "rotated":
            assert [r1 - r0 for r0, r1 in rows] == [8, 10] * 4
        else:
            assert all(b["launches"].get("rotate") == 1 for b in prog.last_bands)


@pytest.mark.parametrize("height, sp", [(8, 8), (75, 3), (75, 5), (30, 6)])
def test_sp_420_bands_snap_to_row_pairs(height, sp):
    """output_bounds for a 4:2:0 output: bands of whole row pairs (an odd
    height's last band ends on its last row), empty bands where the frame
    has fewer pairs than sp (8 rows at sp=8: four bands of 2 rows), and
    the banded yuv420p program equal to the unsharded one plane for
    plane."""
    from phaneron_tpu_torch.graph.convert import params_from_numpy
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec as TSpec, LayerSpec as TLayer, make_channel_program
    from phaneron_tpu_torch.ops.formats import get_format
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.parallel.bands import make_sp_channel_program, output_bounds
    from phaneron_tpu_torch.parallel.mesh import band_bounds, make_sp_mesh

    bounds = output_bounds(height, sp, "yuv420p")
    assert bounds[0][0] == 0 and bounds[-1][1] == height
    assert all(a == b for (_, a), (b, _) in zip(bounds, bounds[1:]))
    assert all(r0 % 2 == 0 and (r1 % 2 == 0 or r1 == height) for r0, r1 in bounds)
    assert output_bounds(height, sp, "v210") == band_bounds(height, sp)
    spec = TSpec(96, height, "yuv420p", (TLayer("v210", has_transform=True, axis_aligned=False),))
    params = params_from_numpy({"layers": [{"src": get_format("v210").fill_buf(96, height),
                                            "matrix": transform_matrix(96, height, rotate=0.05, scale_x=0.8)}]}, "cpu")
    want = make_channel_program(spec)(params)
    prog = make_sp_channel_program(spec, make_sp_mesh(CPU(sp)))
    got = prog(params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [b["rows"] for b in prog.last_bands] == [b for b in bounds if b[1] > b[0]]


@pytest.mark.parametrize("out_format", ["yuv420p", "yuv422p10le", "rgba8"])
def test_sp_planar_outputs_bit_equal(out_format):
    """The planar and RGB packs on bands (B13 on whole row pairs, B11, the
    rgba8 pack in torch ops) and 4:2:0 sources' unpack widened to row
    pairs: a DVE box over BARS into each output, sp=4 against sp=1."""
    fmt = VideoFormat(*FMT_ARGS["tiny"])

    async def main(sp_devices):
        ch = Channel(1, fmt, ProducerRegistry([create_test_pattern_producer]), out_format=out_format,
                     device="cpu", sp_devices=sp_devices)
        await ch.load_source(1, LoadParams("BARS"))
        ch.play(1)
        ch.layer(1).set_fill(0.1, -0.05, 0.7, 1.2)
        f = await ch.render_frame()
        return [p.clone() for p in f.packed]

    want, got = run(main(None)), run(main(CPU(4)))
    assert len(want) == len(got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_multi_channel_program_matches_jax():
    """make_multi_channel_program on a 2x4 mesh of entry()'s structure at
    96x64 against the JAX package's on JAX's 2x4 virtual mesh: each
    channel's words within 1 code (0 expected), the stacked shape JAX's."""
    spec, params = graft._example_spec_and_params(96, 64)
    jm = jmesh.make_mesh(jax.devices()[:8])
    n_ch = jm.shape["ch"]
    stacked = jax.tree.map(lambda x: np.stack([np.asarray(x)] * n_ch), params)
    want = np.asarray(jmesh.make_multi_channel_program(spec, jm)(jmesh.shard_channel_params(stacked, jm))[0])
    tspec, _ = dryrun.example_spec_and_params(96, 64)
    tm = make_mesh(CPU(8))
    got = make_multi_channel_program(tspec, tm)(shard_channel_params(stacked, tm))[0]
    assert tuple(got.shape) == want.shape
    for c in range(n_ch):
        assert max_code_delta(words_to_numpy(got[c]), want[c], 96, 64) <= 1


def test_dryruns_match_jax():
    """The port's three dry runs at 96x64 pass (each asserts its banded
    result equal to one device, bit for bit), and their outputs are
    within 1 code (0 expected) of the JAX package's programs on the same
    inputs: the multichip step, the deinterlaced DVE frame over sp=8
    (JAX's sharded over its virtual devices) and the ch x sp ROUTE."""
    res = dryrun.dryrun_multichip(8, CPU(8), uhd_size=(96, 64))
    # multichip: JAX's single-device program of the same inputs
    spec, params = graft._example_spec_and_params(96, 64)
    want = np.asarray(jpipe.make_channel_program(spec)(params)[0])
    for c in range(2):
        assert max_code_delta(words_to_numpy(res["multichip"][0][c]), want, 96, 64) <= 1
    # the UHD structure at 96x64, JAX row-sharded with shard_params_sp
    tspec, tparams = dryrun.uhd_spec_and_params(96, 64, "cpu")
    jspec = jpipe.ChannelSpec(96, 64, "v210", layers=(
        jpipe.LayerSpec("rgba_f32", has_transform=True, axis_aligned=True, deinterlace=True),))
    jparams = {"layers": [{"src_ring": tuple(jnp.asarray(f.numpy()) for f in tparams["layers"][0]["src_ring"]),
                           "parity": jnp.int32(0), "matrix": jnp.asarray(tparams["layers"][0]["matrix"].numpy())}]}
    jsharded = jmesh.shard_params_sp(jparams, jmesh.make_sp_mesh(jax.devices()[:8]))
    want = np.asarray(jpipe.make_channel_program(jspec)(jsharded)[0])
    assert max_code_delta(words_to_numpy(res["uhd"]["sharded"][0]), want, 96, 64) <= 1
    # the ch x sp ROUTE: JAX's chain on one device
    spec_a, params_a, spec_b, mat = dryrun.route_specs_and_params(96, 64)
    ja = jpipe.make_channel_program(jpipe.ChannelSpec(96, 64, "v210", layers=(jpipe.LayerSpec("v210"),),
                                                      emit_rgba=True))(params_a)
    jb = jpipe.make_channel_program(jpipe.ChannelSpec(
        96, 64, "v210", layers=(jpipe.LayerSpec("rgba_f32", has_transform=True, axis_aligned=True),)))(
        {"layers": [{"src": ja["rgba"], "matrix": jnp.asarray(mat)}]})
    assert max_code_delta(words_to_numpy(res["route"]["sharded"][0]), np.asarray(jb[0]), 96, 64) <= 1
    assert res["route"]["routed"].mesh.shape == {"sp": 4}


def _structures():
    """Program-level structures beside the channels': a 720p-style clip
    at its own size (yuv420p at 64x30, stretch-fit: 4:2:0 row pairs and
    the fit's band form), an off-size rgba_f32 frame under a DVE, a wipe
    under a DVE (K4's wipe pair, its mask the band's rows), a dissolve
    without DVE, an opaque ring dissolve under two matrices into
    yuv422p10le, and a DVE run over rgb3 fields (K5's rgb3 kind with
    coverage under a staged top) with emit_rgba.  Rotated (B14's band
    form): one_rotation (a v210 dissolve run under a v210 layer turned 100
    degrees), a rotated dissolve under two matrices, a rotated wipe, a
    quarter turn of an rgba_f32 frame, a keyed rgba8 top turned 30 degrees
    under emit_rgba (its rotated alpha the frame's); and 72-row yuv420p
    and nv12 outputs (sp=8: 9-row bands, snapped to row pairs), the nv12
    one under a rotated layer."""
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec as TSpec, LayerSpec as TLayer
    from phaneron_tpu_torch.ops.formats import get_format
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    w, h = 96, 64
    rng = np.random.default_rng(17)
    planes = lambda fmt, sw=w, sh=h: [np.asarray(p) for p in get_format(fmt).fill_buf(sw, sh)]
    mat = lambda sh=h, **kw: transform_matrix(w, sh, **kw)
    turn = lambda deg, sh=h, **kw: mat(sh, rotate=deg / 360.0, **kw)
    rolled = lambda k, sh=h: [np.roll(planes("v210", w, sh)[0], 17 * k + 3, axis=1)]
    run_layer = TLayer("v210", transition="dissolve", has_transform=True, src_b_format="v210")
    rot = dict(has_transform=True, axis_aligned=False)
    frame = lambda c, sh=h, sw=w: rng.random((c, sh, sw), dtype=np.float32)
    return {
        "src_size": (TSpec(w, h, "v210", (TLayer("v210"), TLayer("yuv420p", src_size=(64, 30)))),
                     {"layers": [{"src": planes("v210")}, {"src": planes("yuv420p", 64, 30)}]}),
        "off-size frame, DVE": (TSpec(w, h, "v210", (TLayer("rgba_f32", has_transform=True),)),
                                {"layers": [{"src": frame(4, 40, 72), "matrix": mat(scale_y=0.7, offset_y=0.2)}]}),
        "wipe under DVE": (TSpec(w, h, "v210", (TLayer("v210", transition="wipe", has_transform=True,
                                                       mask_format="v210"),)),
                           {"layers": [{"src": planes("v210"), "src_b": [np.roll(planes("v210")[0], 5, 0)],
                                        "mask": [np.roll(planes("v210")[0], 11, 1)],
                                        "matrix": mat(scale_x=0.8, scale_y=1.4, offset_y=-0.1),
                                        "matrix_b": mat(scale_x=0.8, scale_y=1.4, offset_y=-0.1)}]}),
        "dissolve without DVE": (TSpec(w, h, "yuv422p10le", (TLayer("yuv422p8", transition="dissolve",
                                                                    src_b_format="yuv420p"),)),
                                 {"layers": [{"src": planes("yuv422p8"), "src_b": planes("yuv420p"),
                                              "mix": np.float32(0.3)}]}),
        "ring dissolve, two matrices": (
            TSpec(w, h, "yuv422p10le", (TLayer(RGBA, transition="dissolve", has_transform=True, deinterlace=True,
                                               warp_same_mat=False, src_opaque=True, src_b_format=RGBA),)),
            {"layers": [{"src_ring": tuple(frame(3) for _ in range(3)), "src_b_ring": tuple(frame(3) for _ in range(3)),
                         "parity": np.int32(1), "mix": np.float32(0.6), "matrix": mat(flip_v=True, scale_y=0.9),
                         "matrix_b": mat(scale_y=1.2, offset_y=0.3)}]}),
        "rgb3 run under a staged top, emit_rgba": (
            TSpec(w, h, "v210", (TLayer(RGBA, has_transform=True), TLayer(RGBA, has_transform=True),
                                 TLayer("v210", has_transform=True, axis_aligned=True)), emit_rgba=True),
            {"layers": [{"src": frame(3), "matrix": mat(scale_x=0.5, scale_y=0.5)},
                        {"src": frame(3), "matrix": mat(scale_y=1.3, offset_y=0.05)},
                        {"src": planes("v210"), "matrix": mat(scale_x=0.3, scale_y=0.3, offset_y=0.3)}]}),
        "one_rotation": (
            TSpec(w, h, "v210", (run_layer, run_layer, TLayer("v210", **rot))),
            {"layers": [{"src": rolled(2 * i), "src_b": rolled(2 * i + 1), "mix": np.float32(0.4 + 0.05 * i),
                         "matrix": mat(scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i)} for i in range(2)]
             + [{"src": rolled(5), "matrix": turn(100, scale_x=0.9, scale_y=0.9)}]}),
        "rotated dissolve, two matrices": (
            TSpec(w, h, "v210", (TLayer("v210"), TLayer("v210", transition="dissolve", warp_same_mat=False,
                                                          src_b_format="v210", **rot))),
            {"layers": [{"src": rolled(6)}, {"src": rolled(7), "src_b": rolled(8), "mix": np.float32(0.6),
                                             "matrix": turn(100, scale_x=0.9, scale_y=0.9),
                                             "matrix_b": turn(95, scale_x=0.85, scale_y=0.85, offset_x=0.05)}]}),
        "rotated wipe": (
            TSpec(w, h, "v210", (TLayer("v210", transition="wipe", mask_format="v210", src_b_format="v210",
                                        **rot),)),
            {"layers": [{"src": rolled(9), "src_b": rolled(10), "mask": [np.roll(planes("v210")[0], 11, 1)],
                         "matrix": turn(-30, scale_x=1.2, scale_y=0.8, offset_y=0.1),
                         "matrix_b": turn(-30, scale_x=1.2, scale_y=0.8, offset_y=0.1)}]}),
        "quarter turn": (
            TSpec(w, h, "v210", (TLayer("v210"), TLayer(RGBA, **rot))),
            {"layers": [{"src": rolled(11)}, {"src": frame(4), "matrix": turn(90, scale_x=0.8, scale_y=0.8)}]}),
        "rotated keyed rgba8 top, emit_rgba": (
            TSpec(w, h, "v210", (run_layer, run_layer, TLayer("rgba8", **rot)), emit_rgba=True),
            {"layers": [{"src": rolled(2 * i + 12), "src_b": rolled(2 * i + 13), "mix": np.float32(0.3),
                         "matrix": mat(scale_x=0.7, scale_y=0.7, offset_y=0.1 * i)} for i in range(2)]
             + [{"src": [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)],
                 "matrix": turn(30, scale_x=0.6, scale_y=0.6, offset_x=0.1)}]}),
        "yuv420p out, 72 rows": (
            TSpec(w, 72, "yuv420p", (TLayer("v210"), TLayer("v210", has_transform=True))),
            {"layers": [{"src": rolled(1, 72)}, {"src": rolled(2, 72), "matrix": mat(72, scale_x=0.7, scale_y=0.6)}]}),
        "nv12 out, 72 rows, rotated": (
            TSpec(w, 72, "nv12", (TLayer("v210"), TLayer("v210", **rot))),
            {"layers": [{"src": rolled(3, 72)}, {"src": rolled(4, 72), "matrix": turn(60, 72, scale_x=0.7,
                                                                                       scale_y=0.7)}]}),
    }


RGBA = "rgba_f32"


def _count_rotate_calls(monkeypatch) -> None:
    """rotate's wrapper adds one to ``rotate.launches`` where it would launch
    its kernel, also on the CPU, where it runs its plain version."""
    from phaneron_tpu_torch.ops import kernels
    from phaneron_tpu_torch.ops import rotate as rotate_mod

    def is_cpu(t, name):
        if name == "rotate":
            rotate_mod.rotate.launches += 1
        return kernels.is_cpu(t, name)

    monkeypatch.setattr(rotate_mod, "is_cpu", is_cpu)


@pytest.mark.parametrize("name", ["src_size", "off-size frame, DVE", "wipe under DVE", "dissolve without DVE",
                                  "ring dissolve, two matrices", "rgb3 run under a staged top, emit_rgba",
                                  "one_rotation", "rotated dissolve, two matrices", "rotated wipe", "quarter turn",
                                  "rotated keyed rgba8 top, emit_rgba", "yuv420p out, 72 rows",
                                  "nv12 out, 72 rows, rotated"])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_sp_program_structures_bit_equal(monkeypatch, name, sp):
    """make_sp_channel_program against make_channel_program on the same
    params, every plane and the emit_rgba frame equal bit for bit; a
    rotated layer's band calls rotate once (counted where it would launch
    on the card), and a 4:2:0 output's bands hold whole row pairs."""
    _count_rotate_calls(monkeypatch)
    from phaneron_tpu_torch.graph.convert import params_from_numpy
    from phaneron_tpu_torch.graph.pipeline import make_channel_program
    from phaneron_tpu_torch.parallel.bands import make_sp_channel_program
    from phaneron_tpu_torch.parallel.mesh import make_sp_mesh

    spec, params = _structures()[name]
    params = params_from_numpy(params, "cpu")
    want = make_channel_program(spec)(params)
    prog = make_sp_channel_program(spec, make_sp_mesh(CPU(sp)))
    got = prog(params)
    if isinstance(want, dict):
        assert torch.equal(got["rgba"], want["rgba"])
        got, want = got["packed"], want["packed"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(prog.last_bands) == sp
    if any(not ls.axis_aligned for ls in spec.layers):
        assert all(b["launches"].get("rotate") == 1 for b in prog.last_bands)
    if spec.out_format in ("yuv420p", "nv12"):
        assert all(r0 % 2 == 0 and (r1 - r0) % 2 == 0 for r0, r1 in (b["rows"] for b in prog.last_bands))
