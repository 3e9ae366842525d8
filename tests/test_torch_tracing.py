"""The port's tracer (phaneron_tpu_torch/utils/metrics.py ``tracer``) and
the readers of its recording beside a device trace (tools/span_trace.py),
on the CPU."""

from __future__ import annotations

import asyncio
import gc
import sys
import threading
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import span_trace as st  # noqa: E402

from phaneron_tpu_torch.config import VideoFormat  # noqa: E402
from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry  # noqa: E402
from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer  # noqa: E402
from phaneron_tpu_torch.runtime.channel import Channel  # noqa: E402
from phaneron_tpu_torch.runtime.types import TransitionSpec  # noqa: E402
from phaneron_tpu_torch.utils import metrics  # noqa: E402
from phaneron_tpu_torch.utils.metrics import Span, tracer  # noqa: E402

PROGRAM = ("program.sources", "program.layers", "program.combine", "program.pack")
LOOP = 7  # the event loop thread's id in the hand-built spans


@pytest.fixture
def clean_tracer():
    tracer.stop()
    tracer.reset()
    yield tracer
    tracer.stop()
    tracer.reset()


async def _media_channel(chan_id: int = 1) -> Channel:
    """A media-like channel at 192x108 into yuv422p10le: a yuv422p10le cut,
    a yuv420p box MIXing to nv12 under FILL, an rgba8 lower third."""
    fmt = VideoFormat("tiny_media", 1, 192, 108, 192, 50, 1, 48000, 2)
    ch = Channel(chan_id, fmt, ProducerRegistry([create_test_pattern_producer]), out_format="yuv422p10le",
                 device="cpu")
    assert await ch.load_source(1, LoadParams("BARS@yuv422p10le")) and ch.play(1)
    assert await ch.load_source(2, LoadParams("RAMP@yuv420p")) and ch.play(2)
    ch.layer(2).set_fill(0.2, -0.15, 0.5, 0.5)
    assert await ch.load_source(2, LoadParams("BARS@nv12"), transition=TransitionSpec("dissolve", 64))
    ch.layer(2).next.mixer.set_fill(0.2, -0.15, 0.5, 0.5)
    ch.play(2)
    assert await ch.load_source(3, LoadParams("BARS@rgba8")) and ch.play(3)
    ch.layer(3).set_fill(0.0, 0.66, 1.0, 0.33)
    await ch.wait_prewarmed()
    return ch


def _within(inner: Span, outer: Span) -> bool:
    return outer.start <= inner.start and inner.end <= outer.end


def test_media_channel_spans_and_counters(clean_tracer):
    """Each warm tick: one channel.tick holding layer.poll, channel.dispatch
    and the four program stages on the loop thread; the first frame's
    dispatch on a worker thread; one structure made and one cold dispatch."""
    loop_id = {}

    async def main():
        loop_id["id"] = threading.get_ident()
        ch = await _media_channel()
        before = tracer.counters()
        tracer.record()
        for _ in range(4):
            await ch.render_frame()
        spans = tracer.drain()
        after = tracer.counters()
        await ch.shutdown()
        return spans, before, after

    spans, before, after = asyncio.run(main())
    delta = lambda name: after.get(name, 0) - before.get(name, 0)
    assert delta("program.structures") == 1 and delta("channel.cold_dispatches") == 1
    ticks = sorted((s for s in spans if s.name == "channel.tick"), key=lambda s: s.start)
    assert len(ticks) == 4 and all(s.chan == 1 and s.thread == loop_id["id"] for s in ticks)
    cold = [s for s in spans if s.name == "channel.dispatch_cold"]
    assert len(cold) == 1 and cold[0].thread != loop_id["id"] and cold[0].chan == 1
    assert _within(cold[0], ticks[0])
    # the cold frame's program stages ran on its worker thread, under it
    assert {s.name for s in spans if s.thread == cold[0].thread and s.name != "python.gc"} == {
        "channel.dispatch_cold", *PROGRAM}
    for tick in ticks[1:]:
        inside = [s for s in spans if s.thread == loop_id["id"] and _within(s, tick) and s is not tick]
        names = [s.name for s in inside]
        assert names.count("channel.dispatch") == 1 and names.count("layer.poll") == 3
        assert all(names.count(p) == 1 for p in PROGRAM)
        assert "channel.dispatch_cold" not in names
        (dispatch,) = [s for s in inside if s.name == "channel.dispatch"]
        assert all(_within(s, dispatch) for s in inside if s.name in PROGRAM)
        assert all(s.chan == 1 for s in inside if s.name != "python.gc")
        assert names.count("slot.video") == 4 and names.count("slot.audio") == 4
    assert len(tracer.durations("channel.tick", 1)) == 4


def test_off_records_nothing(clean_tracer):
    """Off: span() is the shared null context, nothing is kept, the gc
    hook is not installed; counters still count."""
    assert tracer.span("channel.tick", 1) is metrics._NULL
    assert tracer.span("program.sources") is tracer.span("layer.poll")
    hooks = len(gc.callbacks)

    async def main():
        ch = await _media_channel()
        for _ in range(2):
            await ch.render_frame()
        await ch.shutdown()

    asyncio.run(main())
    gc.collect()
    assert tracer.summary() == {} and tracer.drain() == [] and len(gc.callbacks) == hooks
    assert tracer.counters()["channel.cold_dispatches"] >= 1


def test_gc_and_threads(clean_tracer):
    """On: a collection is a python.gc span of the collecting thread; a
    span opened on another thread carries that thread's id and its
    channel, and the channel passes to the spans it encloses."""
    tracer.record()
    gc.collect()
    seen = {}

    def worker():
        with tracer.span("channel.dispatch_cold", 3):
            with tracer.span("program.sources"):
                seen["id"] = threading.get_ident()

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert not t.is_alive()
    spans = tracer.drain()
    assert any(s.name == "python.gc" and s.thread == threading.get_ident() for s in spans)
    inner = [s for s in spans if s.name == "program.sources"]
    assert len(inner) == 1 and inner[0].chan == 3 and inner[0].thread == seen["id"] != threading.get_ident()
    tracer.stop()
    assert tracer._gc not in gc.callbacks


def _sp(name, start_ms, end_ms, thread=LOOP, chan=1):
    return Span(name, chan, thread, int(start_ms * 1e6), int(end_ms * 1e6))


def _hand_built():
    """Two ticks on the loop thread (0-10 ms and 20-30 ms) around a
    profiled slice from 15 to 35 ms holding the second tick; a collection
    at 32-34 ms; a worker span that must not count."""
    spans = [
        _sp("channel.tick", 0, 10), _sp("layer.poll", 1, 3), _sp("channel.dispatch", 4, 9),
        _sp("program.sources", 4, 6), _sp("program.combine", 7, 8),
        _sp("channel.tick", 20, 30), _sp("layer.poll", 21, 22), _sp("channel.dispatch", 23, 29),
        _sp("program.sources", 23, 26), _sp("program.combine", 27, 28),
        _sp("python.gc", 32, 34, chan=None),
        _sp("channel.tick", 40, 44), _sp("layer.poll", 40, 41), _sp("channel.dispatch", 41, 43),
        _sp("program.sources", 24, 25, thread=9),
    ]
    ms = 1e-3
    ops = [  # the slice's device operations: start, duration, launch (ms)
        st.Op("unpack", "kernel", 25 * ms, 1 * ms, 24.5 * ms),
        st.Op("decode", "kernel", 26 * ms, 1.3 * ms, 25.5 * ms),
        st.Op("over", "kernel", 27.3 * ms, 0.7 * ms, 27.2 * ms),
        st.Op("pack", "kernel", 33 * ms, 2 * ms, 28.5 * ms),
        st.Op("late", "kernel", 36 * ms, 1 * ms, 36.5 * ms),
    ]
    return spans, ops


def test_readings_on_hand_built_spans():
    spans, ops = _hand_built()
    got = st.readings(spans, ops, 15e-3, 35e-3, 1, LOOP)
    # ticks outside the slice: 0-10 and 40-44 ms
    assert got["runtime.tick_host_ms"] == pytest.approx(7.0)
    assert got["runtime.layer_poll_host_ms"] == pytest.approx((2 + 1) / 2)
    assert got["program.enqueue_host_ms"] == pytest.approx((5 + 2) / 2)
    # launched in program.sources at 23-26 ms on the loop: unpack and decode
    assert got["program.sources_device_ms"] == pytest.approx(2.3)
    assert got["program.combine_device_ms"] == pytest.approx(0.7)
    # the card, 25-37 ms: idle 28-33 (the tick to 30, then 30-32 outside and
    # 32-33 in a collection, not the program's) and 35-36 (outside)
    assert got["device.idle_outside_program_pct"] == pytest.approx(100 * (2 + 1 + 1) / 12)
    assert st.late_launches(ops) == 1
    assert st.loop_thread(spans) == LOOP
    assert st.readings([], [], 0, 1, 1, LOOP) == {}


def test_gaps_by_program_span():
    """A gap inside a collection is python.gc's, one outside every span
    'outside the program'; worker spans never label the loop's gaps."""
    spans, ops = _hand_built()
    busy, gaps = st.busy_gaps(ops)
    assert busy == pytest.approx(6e-3) and [(round(a * 1e3, 6), round(b * 1e3, 6)) for a, b in gaps] == [
        (28.0, 33.0), (35.0, 36.0)]
    gaps.append((32.75e-3, 33.25e-3))  # one inside the collection
    labels = st.label_gaps(gaps, spans, LOOP)
    assert [name for name, _ in labels] == [st.OUTSIDE, st.OUTSIDE, "python.gc"]
    assert [round(s * 1e3, 6) for _, s in labels] == [5.0, 1.0, 0.5]
    # program.sources and channel.dispatch open together at 23 ms: the shorter is inner
    assert st.innermost(spans, LOOP, 24.5e-3) == "program.sources"
    assert st.innermost(spans, LOOP, 26.5e-3) == "channel.dispatch"
    assert st.innermost(spans, LOOP, 31e-3) is None
    assert st.by_span(ops, spans, LOOP)["program.sources"] == pytest.approx((2.3e-3, 2))


def _launched(corr, name, launch_us, start_us, dur_us=2.0, clock=lambda us: us):
    """A launch event and its kernel, at trace times ``clock`` gives."""
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": clock(launch_us), "args": {"correlation": corr}},
            {"cat": "kernel", "name": name, "ts": clock(start_us), "dur": dur_us, "args": {"correlation": corr}}]


MARK = f"void at::native::vectorized_elementwise_kernel<4, at::native::{st.MARKER}, std::array<char*, 1ul> >"


def test_device_ops_tie_launches_through_the_markers():
    """Launches tie through the marker launched soonest after its anchor
    (the second here: the first waited 20 us), starts through the least
    launch-to-start delays; an operation outside the markers, a CPU op and
    a copy without a launch event are handled."""
    events = (_launched(1, MARK, 1020.0, 1030.0) + _launched(2, "warp", 1500.0, 1520.0, 40.0)
              + [{"cat": "gpu_memcpy", "name": "copy", "ts": 1600.0, "dur": 5.0, "args": {"correlation": 3}},
                 {"cat": "cpu_op", "name": "aten::add", "ts": 1499.0, "dur": 3.0, "args": {"correlation": 2}}]
              + _launched(4, MARK, 2000.0, 2010.0) + _launched(5, "late", 2100.0, 2110.0))
    ops, lag, drift = st.device_ops(events, anchors=[5.0, 5.001])
    assert [o.name for o in ops] == ["warp", "copy"]
    assert ops[0].launched == pytest.approx(5.0005) and ops[0].start == pytest.approx(5.00051)
    assert ops[0].dur == pytest.approx(40e-6) and ops[1].launched is None
    assert lag == pytest.approx(10e-6) and drift == pytest.approx(0.0, abs=1e-9)
    assert st.late_launches(ops) == 0
    assert st.device_ops(events, anchors=[5.0]) == ([], None, None)  # a marker without its anchor
    assert st.device_ops([], []) == ([], None, None)
    # a third marker, anchored 1.5 ms after the second, missing from the trace: the two there fit the first two
    again, _, _ = st.device_ops(events, anchors=[5.0, 5.001, 5.0025])
    assert again == ops


def test_device_ops_follow_the_device_clock_drift():
    """The trace's device clock stands 1 ms off its host clock and runs 0.2 %
    fast: the least launch-to-start delays (the markers' on an idle card)
    put it back, above them a marker queued behind work and an operation
    started late; the offset and drift show it."""
    device = lambda us: 1000.0 + 1.002 * us
    events = []
    for corr, (name, launch_us, start_us) in enumerate(
            ((MARK, 0, 10), ("warp", 300, 320), (MARK, 500, 900), ("over", 750, 800), (MARK, 1000, 1010))):
        events += _launched(corr, name, launch_us, start_us)
        events[-1]["ts"] = device(start_us)
    ops, lag, drift = st.device_ops(events, anchors=[5.0, 5.0005, 5.001])
    assert [o.name for o in ops] == ["warp", "over"]
    assert [o.launched for o in ops] == pytest.approx([5.0003, 5.00075])
    assert [o.start for o in ops] == pytest.approx([5.00031, 5.00079])
    assert lag == pytest.approx(1010.02e-6) and drift == pytest.approx(2e-6)
    assert st.late_launches(ops) == 0
