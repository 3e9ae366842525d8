"""CUDA graph replay of warm channel ticks (phaneron_tpu_torch/graph/replay.py)
on the CPU.

A capture, the CUDA driver's node list and a launch exist only on the card
(chip_smoke.py ``phase_graph`` runs them there).  Here a capture is
simulated: the frame program runs on CPU tensors while each of its kernel
stages (``pipeline._KERNELS``) and each torch op that launches a kernel is
recorded as a node whose parameters hold the addresses of the tensors it
touches, as a captured kernel node holds them.  ``FakeGraphs`` stands in
for ``CudaGraphs`` with that capture, and its launch runs the program on
the tensors at the addresses the rebound parameters hold, so a replay that
rebinds anything wrongly gives another frame than an eager tick (and the
runner's own check at capture refuses it)."""

from __future__ import annotations

import asyncio
import ctypes
import struct
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from phaneron_tpu_torch.config import VideoFormat
from phaneron_tpu_torch.graph import pipeline, replay
from phaneron_tpu_torch.graph.convert import params_from_numpy
from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec, make_channel_program
from phaneron_tpu_torch.graph.replay import GraphRunner, Node, Patch, Refused, find_patches, substitute
from phaneron_tpu_torch.ops import kernels
from phaneron_tpu_torch.ops.formats import get_format
from phaneron_tpu_torch.ops.geometry import transform_matrix
from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry
from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
from phaneron_tpu_torch.runtime.channel import Channel
from phaneron_tpu_torch.runtime.frame import RGBA_F32
from phaneron_tpu_torch.utils.metrics import tracer

W, H = 64, 16
CPU = torch.device("cpu")
MAT = transform_matrix(W, H, scale_x=0.5, scale_y=0.5, offset_x=0.2, offset_y=-0.15)
COUNTERS = ("program.graph_captures", "program.graph_replays", "program.graph_eager_ticks.structure",
            "program.graph_eager_ticks.alignment")


# ------------------------------------------------------------ simulated capture

_NO_KERNEL = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
              torch.ops.aten.lift_fresh.default, torch.ops.aten._unsafe_view.default}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _node(name: str, tensors: list) -> Node:
    ptrs = [t.data_ptr() for t in tensors if t.numel()]
    return Node("kernel", name, struct.pack(f"<{len(ptrs)}Q", *ptrs), tuple(range(0, 8 * len(ptrs), 8)))


class _Record(TorchDispatchMode):
    """Each torch op that launches a kernel, as a node."""

    def __init__(self, nodes: list):
        super().__init__()
        self.nodes, self.paused = nodes, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused and not func.is_view and func not in _NO_KERNEL:
            self.nodes.append(_node(f"at::{func}", _tensors((args, kwargs, out))))
        return out


def simulate_capture(program, params) -> tuple:
    """(nodes, program(params)): each kernel stage one node named by its
    stage, each torch op one node named 'at::<op>'."""
    nodes: list = []
    rec = _Record(nodes)

    def stage(name, fn):
        def call(*args, **kw):
            rec.paused = True
            try:
                out = fn(*args, **kw)
            finally:
                rec.paused = False
            nodes.append(_node(name, _tensors((args, kw, out))))
            return out

        return call

    stages = pipeline._KERNELS._replace(**{n: stage(n, f) for n, f in pipeline._KERNELS._asdict().items()})
    with mock.patch.object(pipeline, "_KERNELS", stages), rec:
        out = program(params)
    return nodes, out


def _at(addr: int, like: torch.Tensor) -> torch.Tensor:
    """A tensor shaped as ``like`` over the CPU memory at ``addr``."""
    raw = torch.frombuffer((ctypes.c_char * replay._extent(like)).from_address(addr), dtype=torch.uint8)
    return raw.view(like.dtype).as_strided(like.shape, like.stride())


class FakeRebind:
    """A launch reads the addresses its rebound parameters hold: each word
    that held a leaf at capture now names that leaf's tensor for this
    tick, and the program runs on those tensors into the outputs there."""

    def __init__(self, fake, items):
        self.fake = fake
        self.captured = fake.program, fake.params, fake.ins, fake.outs  # this graph's, not a later capture's
        self.orig = [bytes(p) for _, p, _ in items]
        self.buffers = [bytearray(p) for _, p, _ in items]

    def launch(self, stream) -> None:
        program, params, ins, outs = self.captured
        metas = ins + outs
        ranges = [(t.data_ptr(), replay._extent(t)) for t in metas]
        new: dict = {}
        for old, buf in zip(self.orig, self.buffers):
            for (v0,), (v1,) in zip(struct.iter_unpack("<Q", old), struct.iter_unpack("<Q", bytes(buf))):
                for i, (a, n) in enumerate(ranges):
                    if a <= v0 < a + n:
                        assert new.setdefault(i, v1 - (v0 - a)) == v1 - (v0 - a)
        at = [_at(new[i], t) if i in new else t for i, t in enumerate(metas)]
        frame, _ = replay.flatten_out(program(replay.with_tensors(params, at[:len(ins)])))
        for dst, src in zip(at[len(ins):], frame):
            dst.copy_(src)
        self.fake.launches += 1


class FakeGraphs:
    """CudaGraphs on the CPU: a simulated capture, ``FakeRebind``."""

    def __init__(self, fail: bool = False):
        self.fail, self.launches, self.captures = fail, 0, 0

    def stream_id(self, device) -> int:
        return 0

    def own_kernels(self) -> frozenset:
        return frozenset(pipeline._Stages._fields)

    def capture(self, program, params, device) -> tuple:
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.captures += 1
        self.program, self.params = program, params
        self.listed, out = simulate_capture(program, params)
        self.ins = replay.tick_leaves(params)[0]
        self.outs = replay.flatten_out(out)[0]
        return object(), out

    def nodes(self, handle) -> list:
        return list(enumerate(self.listed))

    def rebinder(self, handle, items) -> FakeRebind:
        return FakeRebind(self, items)


# ------------------------------------------------------------ structures and ticks


def media_spec(emit_rgba: bool = False, dve: bool = True, out_format: str = "yuv422p10le") -> ChannelSpec:
    """The cell uhd_rec.media's structure (bench_h100/traffic/media.json) at W x H."""
    return ChannelSpec(W, H, out_format, layers=(
        LayerSpec("yuv422p10le"),
        LayerSpec("yuv420p", transition="dissolve", has_transform=dve, src_b_format="nv12"),
        LayerSpec("rgba8"),
    ), emit_rgba=emit_rgba)


def _planes(fmt: str, rng) -> list:
    hi = 1024 if fmt == "yuv422p10le" else 256
    return [rng.integers(0, hi, size=s, dtype=dt) for s, dt in get_format(fmt).plane_shapes(W, H)]


class Ticks:
    """The media structure's ticks: each source 4 frames, cycled; the MIX
    weight a fresh 0-d tensor each tick, as ``Layer._mix`` makes it."""

    def __init__(self, seed: int = 0, dve: bool = True):
        rng = np.random.default_rng(seed)
        self.frames = [params_from_numpy({"layers": [
            {"src": _planes("yuv422p10le", rng)},
            {"src": _planes("yuv420p", rng), "src_b": _planes("nv12", rng)},
            {"src": _planes("rgba8", rng)},
        ]}, CPU) for _ in range(4)]
        self.matrix = torch.as_tensor(MAT, dtype=torch.float32)
        self.matrix_b = self.matrix.clone()
        self.dve = dve

    def __call__(self, k: int) -> dict:
        layers = [dict(lp) for lp in self.frames[k % 4]["layers"]]
        layers[1]["mix"] = torch.full((), 1.0 - k / 16.0, dtype=torch.float32)
        if self.dve:
            layers[1]["matrix"], layers[1]["matrix_b"] = self.matrix, self.matrix_b
        return {"layers": layers}


def _leaves(params: dict, outs) -> list:
    tensors = replay.tick_leaves(params)[0] + replay.flatten_out(outs)[0]
    return [(t.data_ptr(), replay._extent(t)) for t in tensors]


def _plan(spec: ChannelSpec, params: dict) -> list:
    with replay.KeepAlive() as keep:
        nodes, out = simulate_capture(make_channel_program(spec), params)
    return find_patches(nodes, _leaves(params, out), len(replay.tick_leaves(params)[0]),
                        frozenset(pipeline._Stages._fields), taken=keep.taken), nodes


@pytest.fixture
def clean_tracer():
    tracer.stop()
    tracer.reset()
    yield tracer
    tracer.stop()
    tracer.reset()


def _counts() -> dict:
    c = tracer.counters()
    return {k: c.get(k, 0) for k in COUNTERS}


# ------------------------------------------------------------ the engage decision


def test_the_media_cells_structure_replays():
    """Every source plane, the matrix and the MIX weight are held by the
    kernel stages only (K3, B12 twice, rgb8_unpack, K4's pair), the output
    planes by B11; the combine's torch ops hold none of them."""
    spec, params = media_spec(), Ticks()(0)
    patches, nodes = _plan(spec, params)
    n_ins = len(replay.tick_leaves(params)[0])
    held = {(nodes[p.node].name, p.leaf) for p in patches}
    names = {leaf: name for name, leaf in held}
    assert all(not nodes[p.node].name.startswith("at::") for p in patches)
    assert any(n.name.startswith("at::") for n in nodes)  # the combine ran inside the capture
    tensors = replay.tick_leaves(params)[0]
    lp = params["layers"]
    want = {id(t): stage for stage, ts in (
        ("planar422_unpack", lp[0]["src"]), ("planar420_unpack", lp[1]["src"] + lp[1]["src_b"]),
        ("rgb8_unpack", lp[2]["src"]), ("warp", [lp[1]["matrix"], lp[1]["mix"]])) for t in ts}
    for i, t in enumerate(tensors):
        if id(t) in want:
            assert names.get(i) == want[id(t)], f"leaf {i}"
    assert {names[i] for i in range(n_ins, n_ins + 3)} == {"planar422_pack"}
    assert all(p.delta == 0 for p in patches)


@pytest.mark.parametrize("case", ["emit_rgba", "mix_frames", "rgba_f32_slot", "rgb_output", "rgb3_dve"])
def test_structures_that_stay_eager(case):
    """A torch op that reads a tick's tensor or writes an output refuses
    the structure: emit_rgba's frame (the combine writes it), a dissolve
    without DVE (mix_frames reads the MIX weight), an rgba_f32 slot
    without DVE (the combine reads the frame), an RGB output (its pack is
    torch ops), an opaque 3-channel frame under DVE (its separable alpha
    is torch ops on the matrix)."""
    params = Ticks(dve=case != "mix_frames")(3)
    spec = media_spec(emit_rgba=case == "emit_rgba", dve=case != "mix_frames",
                      out_format="rgba8" if case == "rgb_output" else "yuv422p10le")
    if case in ("rgba_f32_slot", "rgb3_dve"):
        dve = case == "rgb3_dve"
        spec = spec._replace(layers=spec.layers[:2] + (LayerSpec(RGBA_F32, has_transform=dve),))
        params["layers"][2] = {"src": torch.rand((3 if dve else 4, H, W))}
        if dve:
            params["layers"][2]["matrix"] = torch.tensor(MAT, dtype=torch.float32)
    with pytest.raises(Refused, match="at::"):
        _plan(spec, params)


def test_routes_that_are_not_captured():
    """The fused v210 program and a whole-stack packed composite run as
    they are; the staged media structure is captured."""
    v210 = LayerSpec("v210")
    fused = ChannelSpec(W, H, "v210", layers=(v210, v210._replace(transition="dissolve", src_b_format="v210")))
    box = v210._replace(has_transform=True)
    whole_k5 = ChannelSpec(W, H, "v210", layers=(box, box))
    assert not make_channel_program(fused).staged({"layers": [{}, {}]})
    assert not make_channel_program(whole_k5).staged({"layers": [{}, {}]})
    assert make_channel_program(media_spec()).staged(Ticks()(0))


def test_channels_that_never_replay(monkeypatch):
    """CPU, plain and row-sharded channels never reach the graph runner;
    a CPU channel's warm ticks run as before."""
    fmt = VideoFormat("96x64p", 1, 96, 64, 96, 50, 1)
    reg = lambda: ProducerRegistry([create_test_pattern_producer])
    chans = [Channel(1, fmt, reg(), device="cpu"), Channel(2, fmt, reg(), device="cpu", plain=True),
             Channel(3, fmt, reg(), device="cpu", sp_devices=["cpu", "cpu"])]
    assert not any(ch._replays for ch in chans)

    def refuse(*a, **kw):
        raise AssertionError("a CPU channel reached the graph runner")

    monkeypatch.setattr(replay.graphs, "run", refuse)

    async def ticks():
        ch = chans[0]
        assert await ch.load_source(1, LoadParams("BARS")) and ch.play(1)
        for _ in range(3):
            await ch.render_frame()
        await ch.shutdown()

    asyncio.run(ticks())


def test_substitution_in_a_by_value_struct():
    """A kernel's parameters: a pointer, an int, then a by-value struct of
    two pointers (one 64 bytes into its plane) and three floats.  Each
    pointer is found in its leaf and rewritten to the tick's address at
    the same offset into it; nothing else changes."""
    a, b, c = 0x7F00_0000_0000, 0x7F00_0010_0000, 0x7F00_0020_0000
    params = struct.pack("<QiiQQfff", a, 1920, 0, b + 64, c, 0.5, 0.25, 1.0)
    node = Node("kernel", "unpack", params, (0, 8, 16))
    torch_node = Node("kernel", "at::add", struct.pack("<Q", 0x7F00_0030_0000), (0,))
    leaves = [(a, 4096), (b, 4096), (c, 512)]
    patches = find_patches([torch_node, node], leaves, 2, frozenset({"unpack"}))
    assert patches == [Patch(1, 0, 0, 0), Patch(1, 16, 1, 64), Patch(1, 24, 2, 0)]
    buf = bytearray(params)
    bases = [0x7E00_0000_0000, 0x7E00_0100_0000, 0x7E00_0200_0000]
    substitute(buf, patches, bases)
    assert struct.unpack("<QiiQQfff", bytes(buf)) == (bases[0], 1920, 0, bases[1] + 64, bases[2], 0.5, 0.25, 1.0)


def test_refusals_on_fake_node_lists():
    """Overlapping leaves, a host copy, a node of a kind that may hide
    work, an output no kernel writes, a torch op holding an interior
    pointer of an input: each refuses."""
    own = frozenset({"k"})
    a = 0x7F00_0000_0000
    k = Node("kernel", "k", struct.pack("<QQ", a, a + 8192), (0, 8))
    with pytest.raises(Refused, match="overlap"):
        find_patches([k], [(a, 4096), (a + 1024, 64)], 2, own)
    with pytest.raises(Refused, match="memcpy_from_host"):
        find_patches([k, Node("memcpy_from_host", "", b"")], [(a, 64), (a + 8192, 64)], 1, own)
    with pytest.raises(Refused, match="other"):
        find_patches([Node("other", "", b""), k], [(a, 64), (a + 8192, 64)], 1, own)
    with pytest.raises(Refused, match="output 0"):
        find_patches([k], [(a, 64), (a + 65536, 64)], 1, own)
    with pytest.raises(Refused, match="at::mul"):
        find_patches([k, Node("kernel", "at::mul", struct.pack("<Q", a + 40), (0,))], [(a, 64), (a + 8192, 64)], 1, own)
    assert len(find_patches([k], [(a, 64), (a + 8192, 64)], 1, own)) == 2


# ------------------------------------------------------------ the runner


def _first_frame(runner: GraphRunner, spec: ChannelSpec, params: dict):
    """A channel's cold dispatch: the structure's first frame eager, then
    its capture."""
    program = make_channel_program(spec)
    out = program(params)
    runner.capture(spec, program, params, CPU, out)
    return program, out


def test_replays_equal_eager_ticks_and_keep_held_outputs(clean_tracer):
    """The first frame captures; eleven ticks with the sources cycled and
    the MIX weight moving each replay, and every frame equals the eager
    tick's bit for bit; three held outputs stay as they were across three
    later replays."""
    spec, ticks = media_spec(), Ticks(seed=3)
    fake = FakeGraphs()
    runner = GraphRunner(fake)
    program, _ = _first_frame(runner, spec, ticks(0))
    held = []
    for k in range(11):
        got = runner.run(spec, program, ticks(k), CPU)
        want = program(ticks(k))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), f"tick {k}"
        if 5 <= k < 8:
            held.append((got, [p.clone() for p in got]))
    for got, copy in held:
        assert all(torch.equal(g, c) for g, c in zip(got, copy))
    assert fake.captures == 1 and fake.launches == 12  # the capture's check, then 11 ticks
    assert _counts() == {"program.graph_captures": 1, "program.graph_replays": 11,
                         "program.graph_eager_ticks.structure": 0, "program.graph_eager_ticks.alignment": 0}


def test_an_alignment_change_runs_eager(clean_tracer):
    """A tick whose 10-bit luma plane lies 2 bytes off its captured
    alignment runs eager and counts one; the next tick replays."""
    spec, ticks = media_spec(), Ticks(seed=4)
    runner = GraphRunner(FakeGraphs())
    program, _ = _first_frame(runner, spec, ticks(0))
    params = ticks(1)
    y = params["layers"][0]["src"][0]
    shifted = torch.empty(y.numel() + 1, dtype=y.dtype)[1:].view(y.shape)
    shifted.copy_(y)
    assert shifted.data_ptr() % replay.ALIGN != y.data_ptr() % replay.ALIGN
    params["layers"][0] = {"src": [shifted] + params["layers"][0]["src"][1:]}
    got = runner.run(spec, program, params, CPU)
    assert all(torch.equal(g, w) for g, w in zip(got, program(ticks(1))))
    assert _counts()["program.graph_eager_ticks.alignment"] == 1
    runner.run(spec, program, ticks(2), CPU)
    assert _counts() == {"program.graph_captures": 1, "program.graph_replays": 1,
                         "program.graph_eager_ticks.structure": 0, "program.graph_eager_ticks.alignment": 1}


def test_a_layout_change_runs_eager(clean_tracer):
    """A tick whose params differ from the captured ones in layout (the
    MIX weight a Python float) runs eager, counted as the structure's."""
    spec, ticks = media_spec(), Ticks(seed=5)
    runner = GraphRunner(FakeGraphs())
    program, _ = _first_frame(runner, spec, ticks(0))
    params = ticks(1)
    params["layers"][1]["mix"] = 0.25
    got = runner.run(spec, program, params, CPU)
    assert all(torch.equal(g, w) for g, w in zip(got, program(params)))
    assert _counts()["program.graph_eager_ticks.structure"] == 1


def test_counters_and_the_replay_span(clean_tracer):
    """Each replay is one ``program.replay`` span and one count; a refused
    structure counts each tick eager; a bypassed route counts nothing; a
    structure never captured on this stream counts eager."""
    tracer.record()
    ticks = Ticks(seed=6)
    runner = GraphRunner(FakeGraphs())
    spec = media_spec()
    program, _ = _first_frame(runner, spec, ticks(0))
    for k in range(3):
        runner.run(spec, program, ticks(k), CPU)
    eager = media_spec(emit_rgba=True)
    _first_frame(runner, eager, ticks(0))
    for k in range(2):
        out = runner.run(eager, make_channel_program(eager), ticks(k), CPU)
        assert set(out) == {"packed", "rgba"}
    assert "at::" in runner.refusals[eager]
    fused_spec = ChannelSpec(W, H, "v210", layers=(LayerSpec("v210"),))
    words = {"layers": [{"src": [torch.zeros((H, get_format("v210").plane_shapes(W, H)[0][0][1]),
                                             dtype=torch.int32)]}]}
    _first_frame(runner, fused_spec, words)
    runner.run(fused_spec, make_channel_program(fused_spec), words, CPU)
    uncaptured = media_spec()._replace(tff=False)
    runner.run(uncaptured, make_channel_program(uncaptured), ticks(0), CPU)
    assert [runner.holds(s, CPU) for s in (spec, eager, fused_spec, uncaptured)] == [True, True, True, False]
    spans = [s.name for s in tracer.drain()]
    assert spans.count("program.replay") == 3
    assert _counts() == {"program.graph_captures": 1, "program.graph_replays": 3,
                         "program.graph_eager_ticks.structure": 3, "program.graph_eager_ticks.alignment": 0}


def test_a_failed_capture_runs_eager(clean_tracer):
    """A capture that raises leaves the structure eager: the tick runs,
    counted, and the failure is kept."""
    spec, ticks = media_spec(), Ticks(seed=7)
    runner = GraphRunner(FakeGraphs(fail=True))
    program, _ = _first_frame(runner, spec, ticks(0))
    for k in range(2):
        got = runner.run(spec, program, ticks(k), CPU)
        assert all(torch.equal(g, w) for g, w in zip(got, program(ticks(k))))
    assert "capture failed" in runner.refusals[spec]
    assert _counts()["program.graph_eager_ticks.structure"] == 2
    assert _counts()["program.graph_captures"] == 0


def test_graphs_kept_are_bounded():
    """At most MAX_GRAPHS structures keep a graph; the least recently
    ticked goes first."""
    runner = GraphRunner(FakeGraphs())
    ticks = Ticks(seed=8)
    specs = [media_spec()._replace(tff=tff) for tff in (True, False)] + [media_spec(out_format="yuv422p8")]
    with mock.patch.object(replay, "MAX_GRAPHS", 2):
        for spec in specs[:2]:
            _first_frame(runner, spec, ticks(0))
        runner.run(specs[0], make_channel_program(specs[0]), ticks(1), CPU)
        _first_frame(runner, specs[2], ticks(0))
    assert [k[0] for k in runner._graphs] == [specs[0], specs[2]]


# ------------------------------------------------------------ the capture's own checks


class _MissOne(FakeRebind):
    """A rebind that leaves its first node at the captured addresses, as
    if the kernel held an address the node list does not show."""

    def launch(self, stream) -> None:
        self.buffers[0][:] = self.orig[0]
        super().launch(stream)


class _MissGraphs(FakeGraphs):
    def rebinder(self, handle, items):
        return _MissOne(self, items)


def test_the_capture_check_refuses_a_missed_address(clean_tracer):
    """An input address the rebinding misses reads the poisoned capture
    copy in the check replay at capture: the structure stays eager, and
    its ticks equal eager ones."""
    spec, ticks = media_spec(), Ticks(seed=9)
    runner = GraphRunner(_MissGraphs())
    program, _ = _first_frame(runner, spec, ticks(0))
    assert "first frame replayed differs" in runner.refusals[spec]
    got = runner.run(spec, program, ticks(1), CPU)
    assert all(torch.equal(g, w) for g, w in zip(got, program(ticks(1))))
    assert _counts()["program.graph_captures"] == 0
    assert _counts()["program.graph_eager_ticks.structure"] == 1


def test_the_capture_check_refuses_an_output_written_in_part(clean_tracer, monkeypatch):
    """An output byte the replay leaves unwritten keeps the poison the
    check fills the outputs with: the structure stays eager."""
    spec, ticks = media_spec(), Ticks(seed=10)
    runner = GraphRunner(FakeGraphs())
    original_launch = GraphRunner._launch

    def unwritten(g, ptrs, device, stream, fill=None):
        outs = original_launch(g, ptrs, device, stream, fill)
        if fill is not None:  # the check replay: one byte the kernels did not write
            outs[0].view(-1)[:1].view(torch.uint8)[0] ^= 0xFF
        return outs

    monkeypatch.setattr(GraphRunner, "_launch", staticmethod(unwritten))
    _first_frame(runner, spec, ticks(0))
    assert "first frame replayed differs from it eager (output, bytes): [(0, 1)]" in runner.refusals[spec]


def test_an_input_held_by_no_node_refuses():
    """An input with bytes that no node holds refuses where the host took
    an address in it during the capture (it reaches the card another way,
    say through a pointer array) or where that is not known; one whose
    address was never taken is not read (``matrix_b`` of a pair under one
    matrix) and does not refuse, nor does an empty one."""
    a = 0x7F00_0000_0000
    k = Node("kernel", "k", struct.pack("<Q", a + 8192), (0,))
    leaves = [(a, 64), (a + 8192, 64)]
    for taken in (None, [a + 8192, a], [a + 32]):
        with pytest.raises(Refused, match="input 0 is held by no node"):
            find_patches([k], leaves, 1, frozenset({"k"}), taken=taken)
    assert find_patches([k], leaves, 1, frozenset({"k"}), taken=[a + 8192]) == [Patch(0, 0, 1, 0)]
    assert find_patches([k], [(a, 0), (a + 8192, 64)], 1, frozenset({"k"})) == [Patch(0, 0, 1, 0)]


def test_the_media_structure_leaves_only_matrix_b_unheld():
    """In the cell's structure (a DVE pair under one matrix) every input
    is held by a kernel node but ``matrix_b``, whose address the frame
    program never takes."""
    params = Ticks()(0)
    patches, _ = _plan(media_spec(), params)
    tensors = replay.tick_leaves(params)[0]
    unheld = {i for i in range(len(tensors))} - {p.leaf for p in patches}
    assert [tensors[i] for i in unheld] == [params["layers"][1]["matrix_b"]]


@pytest.mark.parametrize("word, expect", [(0, 0), (40, 40), (64, None), (-8, None), (8192, "output")])
def test_only_taken_addresses_are_rebound(word, expect):
    """With the host's taken addresses known, a word of an own kernel is
    rebound only if it is one of them (or a leaf's own address): an
    interior pointer taken from a view is rebound at its offset, while a
    word that lies in an input without being taken (one past its end, or
    data) stays."""
    a, out = 0x7F00_0000_1000, 0x7F00_0000_3000
    node = Node("kernel", "k", struct.pack("<QQ", a, a + word if word != 8192 else out), (0, 8))
    leaves = [(a, 64), (out, 256)]
    taken = [a, a + 40, out]
    if expect == "output":
        assert find_patches([node], leaves, 1, frozenset({"k"}), taken=taken) == [Patch(0, 0, 0, 0), Patch(0, 8, 1, 0)]
        return
    with pytest.raises(Refused, match="output 0"):  # nothing writes the output in these node lists
        find_patches([node], leaves, 1, frozenset({"k"}), taken=taken)
    writer = Node("kernel", "k", struct.pack("<Q", out), (0,))
    got = find_patches([node, writer], leaves, 1, frozenset({"k"}), taken=taken)
    want = [Patch(0, 0, 0, 0)] + ([Patch(0, 8, 0, expect)] if expect is not None else []) + [Patch(1, 0, 1, 0)]
    assert got == want


def test_a_float_beside_struct_padding_is_not_an_address():
    """The word that kept the cell's structure from replaying on the card:
    B12's by-value ``Decode`` ends ``gamut[8]`` (1.0f) and four bytes of
    uninitialised padding, which held the upper half of a host pointer, so
    the 8-byte word read 0x7fXX3f800000 and at times fell inside the V
    plane's capture copy.  Rebound as an address it overwrote the float
    and moved the colours of the box; as data (not a taken address) it
    stays."""
    plane = 0x7F23_3F7B_E000
    decode = struct.pack("<12f9f4xQ", *([0.5] * 12), *([0.0] * 8 + [1.0]), 0x7F24_0000_0000)
    params = struct.pack("<QQQQ", plane - 0x10000, plane - 0x8000, plane, 0x7F30_0000_0000) + decode
    word = struct.unpack_from("<Q", params, 112)[0]
    assert word & 0xFFFF_FFFF == 0x3F80_0000
    garbage = bytearray(params)
    garbage[116:120] = struct.pack("<I", 0x7F23)
    word = struct.unpack_from("<Q", garbage, 112)[0]
    assert plane <= word < plane + 8_294_400
    nodes = [Node("kernel", "b12", bytes(garbage), (0, 8, 16, 24, 32)),
             Node("kernel", "pack", struct.pack("<Q", 0x7F30_0000_0000), (0,))]
    leaves = [(plane - 0x10000, 4096), (plane - 0x8000, 4096), (plane, 8_294_400), (0x7F30_0000_0000, 4096)]
    taken = [plane - 0x10000, plane - 0x8000, plane, 0x7F30_0000_0000]
    patches = find_patches(nodes, leaves, 3, frozenset({"b12", "pack"}), taken=taken)
    assert [p.offset for p in patches if p.node == 0] == [0, 8, 16, 24]
    assert any(p.offset == 112 for p in find_patches(nodes, leaves, 3, frozenset({"b12", "pack"})))


def test_capture_copies_keep_layout_alignment_and_guards():
    """Each capture copy has its tensor's shape, type, strides, bytes and
    address mod 512, and GUARD free bytes before and after (a pointer
    derived from one lands in no other)."""
    base = torch.zeros(4096, dtype=torch.uint8)
    tensors = [base[2:2 + 2 * 9 * 4].view(torch.int16).view(9, 4).t(), torch.full((), 0.5), base[:0],
               torch.arange(12, dtype=torch.float32).view(3, 4)[:, 1:]]
    arena, copies = replay._copies(tensors, CPU)
    spans = []
    for t, c in zip(tensors, copies):
        assert c.shape == t.shape and c.dtype == t.dtype and c.stride() == t.stride() and torch.equal(c, t)
        if t.numel():
            assert c.data_ptr() % 512 == t.data_ptr() % 512
            spans.append((c.data_ptr(), c.data_ptr() + replay._extent(c)))
        else:
            assert c is t
    lo, hi = arena.data_ptr(), arena.data_ptr() + arena.numel()
    edges = [lo] + [x for s in spans for x in s] + [hi]
    assert all(b - a >= replay.GUARD for a, b in zip(edges[::2], edges[1::2]))


def test_a_capture_records_its_launches_on_its_own_thread():
    """Launches inside ``kernels.recording()`` are the recording's and
    leave the wrapper's counter as it was; another thread's launches
    meanwhile count as ever."""
    w = kernels.planar422_pack
    before = w.launches
    with kernels.recording() as counts:
        kernels.launched(w)
        t = threading.Thread(target=kernels.launched, args=(w,))
        t.start()
        t.join()
        kernels.launched(w)
    assert counts == {w: 2} and w.launches == before + 1
    w.launches = before


def test_a_structure_change_does_not_hold_up_other_channels(monkeypatch):
    """A structure's capture runs on the worker thread of its first frame,
    under ``capture_lock``: while one channel's new structure captures (a
    slow one here), another channel's warm ticks go on on the event loop,
    which never waits for the lock."""
    fmt = VideoFormat("96x64p", 1, 96, 64, 96, 50, 1)
    reg = lambda: ProducerRegistry([create_test_pattern_producer])
    runner = GraphRunner(FakeGraphs())
    monkeypatch.setattr("phaneron_tpu_torch.runtime.channel.graphs", runner)
    capture, where = runner.capture, []

    def slow(*args):
        with replay.capture_lock:
            if slow.armed:
                where.append(threading.current_thread() is threading.main_thread())
                time.sleep(0.4)
            return capture(*args)

    slow.armed = False

    monkeypatch.setattr(runner, "capture", slow)
    a, b = Channel(1, fmt, reg(), device="cpu"), Channel(2, fmt, reg(), device="cpu")
    for ch in (a, b):
        ch._replays = True

    async def ticks():
        for ch, src in ((a, "BARS"), (b, "BARS")):
            assert await ch.load_source(1, LoadParams(src)) and ch.play(1)
            for _ in range(3):
                await ch.render_frame()
        assert await b.load_source(2, LoadParams("RAMP")) and b.play(2)
        slow.armed = True
        cold = asyncio.create_task(b.render_frame())
        stamps = [time.perf_counter()]
        while not cold.done():
            await a.render_frame()
            stamps.append(time.perf_counter())
        await cold
        for ch in (a, b):
            await ch.shutdown()
        return stamps

    stamps = asyncio.run(ticks())
    assert where == [False]  # captured once, off the event loop
    gaps = [y - x for x, y in zip(stamps, stamps[1:])]
    assert stamps[-1] - stamps[0] >= 0.4 and len(gaps) >= 10 and max(gaps) < 0.2


def test_a_dropped_capture_is_taken_again_off_the_loop(monkeypatch, clean_tracer):
    """A warm structure whose capture was dropped (``MAX_GRAPHS``) runs
    one tick eager, counted, and its next tick is a first frame again, on
    the worker thread, which captures it anew."""
    fmt = VideoFormat("96x64p", 1, 96, 64, 96, 50, 1)
    reg = lambda: ProducerRegistry([create_test_pattern_producer])
    runner = GraphRunner(FakeGraphs())
    monkeypatch.setattr("phaneron_tpu_torch.runtime.channel.graphs", runner)
    monkeypatch.setattr(replay, "MAX_GRAPHS", 1)
    a, b = Channel(1, fmt, reg(), device="cpu"), Channel(2, fmt, reg(), device="cpu")
    for ch in (a, b):
        ch._replays = True

    async def ticks():
        assert await a.load_source(1, LoadParams("BARS")) and a.play(1)
        assert await b.load_source(1, LoadParams("RAMP@yuv422p8")) and b.play(1)
        for _ in range(2):
            await a.render_frame()
        (spec_a,) = a._warm_specs
        assert runner.holds(spec_a, a.device)
        await b.render_frame()  # b's capture drops a's
        assert not runner.holds(spec_a, a.device)
        cold = tracer.counters().get("channel.cold_dispatches", 0)
        await a.render_frame()
        assert spec_a not in a._warm_specs and tracer.counters()["program.graph_eager_ticks.structure"] == 1
        await a.render_frame()
        assert tracer.counters()["channel.cold_dispatches"] == cold + 1 and runner.holds(spec_a, a.device)
        for ch in (a, b):
            await ch.shutdown()

    asyncio.run(ticks())
