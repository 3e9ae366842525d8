"""Read the port tracer's raw spans beside a torch.profiler trace of the card.

The tracer (``phaneron_tpu_torch/utils/metrics.py``) records spans on
the host's ``perf_counter`` clock (``tracer.record()`` / ``drain()``).  A
profiled window ties the profiler's clocks to it with markers: ``mark``
reads the host clock and launches a one-element int8 fill, at the
window's start and end with the card idle, and between its steps.
``device_ops`` maps each operation's launch event (``cudaLaunchKernel``,
matched by its ``correlation`` id) and its start on the card to the
host's clock through the markers.  The readers then attribute each
operation to the spans open on the event loop thread when it was
launched, and label the card's idle gaps with the span open at their
middle.

Used by tools/port_profile.py and tools/server_profile.py; the names of
``readings`` are the per-layer quantities the spans were placed for.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Optional

__all__ = ["MARKER", "Op", "mark", "device_ops", "export_events", "loop_thread", "busy_gaps", "innermost", "label_gaps",
           "launched_inside", "late_launches", "idle_outside_program", "readings", "by_span", "OUTSIDE"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "FillFunctor<signed char>"
SEGMENTS = 16  # spans of a window, each giving the least launch-to-start delay
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program"
GC = "python.gc"


@dataclass
class Op:
    name: str
    cat: str
    start: float  # host perf_counter seconds
    dur: float  # seconds
    launched: Optional[float] = None  # host seconds of its launch event

    @property
    def end(self) -> float:
        return self.start + self.dur


def export_events(prof) -> list:
    """A finished ``torch.profiler.profile``'s chrome trace events."""
    fd, path = tempfile.mkstemp(prefix="span_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def mark(torch, device) -> float:
    """Read the host clock, then launch a marker (a one-element int8 fill,
    which the program never launches): the host time."""
    t = time.perf_counter()
    torch.zeros(1, dtype=torch.int8, device=device)
    return t


def _lower_hull(points: list) -> list:
    """The lower convex hull of (x, y) points sorted by x."""
    hull: list = []
    for p in points:
        while len(hull) >= 2 and ((hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                                  - (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])) <= 0:
            hull.pop()
        hull.append(p)
    return hull


def _along(hull: list, x: float) -> float:
    """The hull's y at x, flat beyond its ends."""
    if x <= hull[0][0] or len(hull) == 1:
        return hull[0][1]
    if x >= hull[-1][0]:
        return hull[-1][1]
    i = bisect.bisect_right([p[0] for p in hull], x) - 1
    (x0, y0), (x1, y1) = hull[i], hull[i + 1]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def device_ops(events: list, anchors: list) -> tuple:
    """(the card's operations between the first and last marker, on the
    host's clock; the trace's device clock's offset from its host clock at
    the window's start, seconds; that offset's drift over the window,
    seconds).  ``anchors``: the host times ``mark`` returned, in order, the
    first and last with the card idle.

    Launches: a marker launches at its anchor or later (another thread
    may hold the interpreter between the two), so the marker that
    launched soonest after its anchor ties the trace's host clock to
    ``perf_counter``.  Starts on the card: the trace's device clock drifts
    against its host clock, by milliseconds a second on some machines.
    An operation starts after its launch call begins, so in each of
    SEGMENTS spans of the window the least delay from a launch to its
    start is the clocks' offset plus the card's own latency (some
    microseconds), and the lower hull of those least delays ties the
    device clock through the window (a launch call has been seen to
    take 0.5 ms: its operation lies above the hull).  Markers missing
    from the trace (the profiler has been seen to drop the last) are
    matched to the run of consecutive anchors their launches fit best.
    Without two markers and their launch events the result is ([],
    None, None)."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "ts" in e), key=lambda e: float(e["ts"]))
    launches = {_corr(e): float(e["ts"]) for e in events if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    markers = [e for e in dev if MARKER in e["name"]]
    if len(markers) < 2 or len(markers) > len(anchors) or any(_corr(m) not in launches for m in markers):
        return [], None, None
    sent = [launches[_corr(m)] for m in markers]
    spread = lambda k: (max(a - x * 1e-6 for a, x in zip(anchors[k:], sent))
                        - min(a - x * 1e-6 for a, x in zip(anchors[k:], sent)))
    k = min(range(len(anchors) - len(markers) + 1), key=spread)
    anchors = anchors[k:k + len(markers)]
    best = max(range(len(markers)), key=lambda i: anchors[i] - sent[i] * 1e-6)
    launch_of = lambda ts: anchors[best] + (ts - sent[best]) * 1e-6
    s0, s1 = float(markers[0]["ts"]), float(markers[-1]["ts"])
    window = [e for e in dev if s0 <= float(e["ts"]) <= s1]
    least: dict = {}
    for e in window:
        if _corr(e) in launches:
            k = min(int((float(e["ts"]) - s0) / (s1 - s0) * SEGMENTS), SEGMENTS - 1)
            point = (float(e["ts"]), float(e["ts"]) - launches[_corr(e)])
            least[k] = min(least.get(k, point), point, key=lambda p: p[1])
    hull = _lower_hull(sorted(least.values()))
    start_of = lambda ts: launch_of(ts - _along(hull, ts))
    ops = []
    for e in window:
        if MARKER in e["name"]:
            continue
        launch = launches.get(_corr(e))
        ops.append(Op(e["name"], e["cat"], start_of(float(e["ts"])), float(e.get("dur", 0)) / 1e6,
                      None if launch is None else launch_of(launch)))
    offset = _along(hull, s0)
    return ops, offset * 1e-6, (_along(hull, s1) - offset) * 1e-6


def loop_thread(spans: list) -> Optional[int]:
    """The thread most ``channel.tick`` spans ran on: the event loop's."""
    ticks = Counter(s.thread for s in spans if s.name == "channel.tick")
    return ticks.most_common(1)[0][0] if ticks else None


def _on(spans: list, thread, names=None) -> list:
    """(start s, end s, name) of the spans on ``thread``, by start, the
    longer first where two start together (it encloses the other)."""
    return sorted(((s.start * 1e-9, s.end * 1e-9, s.name) for s in spans
                   if s.thread == thread and (names is None or s.name in names)), key=lambda v: (v[0], -v[1]))


def _label_runs(iv: list) -> tuple:
    """(bounds, labels): from bounds[i] to bounds[i + 1] the latest-opened
    span of ``iv`` still open is labels[i] (None: no span open)."""
    points = sorted([(a, 1, i) for i, (a, _, _) in enumerate(iv)] + [(b, 0, i) for i, (_, b, _) in enumerate(iv)])
    heap, open_, bounds, labels = [], set(), [], []
    for t, is_start, i in points:
        if is_start:
            open_.add(i)
            heapq.heappush(heap, (-iv[i][0], iv[i][1], i))  # latest start first, the shorter on a tie
        else:
            open_.discard(i)
        while heap and heap[0][2] not in open_:
            heapq.heappop(heap)
        label = iv[heap[0][2]][2] if heap else None
        if bounds and bounds[-1] == t:
            labels[-1] = label
        else:
            bounds.append(t)
            labels.append(label)
    return bounds, labels


def _label_at(segs: tuple, t: float) -> Optional[str]:
    bounds, labels = segs
    i = bisect.bisect_right(bounds, t) - 1
    return labels[i] if i >= 0 else None


def innermost(spans: list, thread, t: float) -> Optional[str]:
    """The name of the latest-opened span on ``thread`` still open at host
    time ``t`` (the innermost, where spans nest), or None."""
    return _label_at(_label_runs(_on(spans, thread)), t)


def busy_gaps(ops: list) -> tuple:
    """(busy seconds, [(gap start, gap end)]) of the card from its first
    operation's start to its last one's end."""
    if not ops:
        return 0.0, []
    ops = sorted(ops, key=lambda o: o.start)
    busy, gaps, a, b = 0.0, [], ops[0].start, ops[0].end
    for o in ops[1:]:
        if o.start > b:
            busy += b - a
            gaps.append((b, o.start))
            a, b = o.start, o.end
        else:
            b = max(b, o.end)
    return busy + b - a, gaps


def label_gaps(gaps: list, spans: list, thread, n: int = 10) -> list:
    """[label, seconds] of the ``n`` longest gaps, longest first: the
    innermost span open on ``thread`` at the gap's middle, or OUTSIDE."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    segs = _label_runs(_on(spans, thread))
    return [[_label_at(segs, (a + b) / 2) or OUTSIDE, b - a] for a, b in longest]


def launched_inside(ops: list, spans: list, name: str, thread) -> list:
    """The operations launched inside a ``name`` span on ``thread`` (one
    whose spans never overlap there: a synchronous stage's)."""
    iv = _on(spans, thread, {name})
    starts = [a for a, _, _ in iv]
    out = []
    for o in ops:
        if o.launched is None:
            continue
        i = bisect.bisect_right(starts, o.launched) - 1
        if i >= 0 and o.launched <= iv[i][1]:
            out.append(o)
    return out


def by_span(ops: list, spans: list, thread) -> dict:
    """Span name -> (device seconds, operations) of the operations whose
    launch fell in it as the innermost span on ``thread`` (None: outside
    every span, or no launch event)."""
    out: dict = defaultdict(lambda: [0.0, 0])
    segs = _label_runs(_on(spans, thread))
    for o in ops:
        key = None if o.launched is None else _label_at(segs, o.launched)
        out[key][0] += o.dur
        out[key][1] += 1
    return {k: tuple(v) for k, v in out.items()}


def late_launches(ops: list) -> int:
    """Operations whose launch falls after their start: none, where the
    tie is sound."""
    return sum(o.launched is not None and o.launched > o.start for o in ops)


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_outside_program(ops: list, spans: list, thread) -> Optional[float]:
    """% of the window (first operation's start to last one's end) in which
    the card was idle and ``thread`` had no span of the program open
    (``python.gc`` is not the program's)."""
    if not ops:
        return None
    lo, hi = min(o.start for o in ops), max(o.end for o in ops)
    if hi <= lo:
        return None
    _, gaps = busy_gaps(ops)
    program = _union([[a, b] for a, b, name in _on(spans, thread) if name != GC])
    ends = [b for _, b in program]
    idle = 0.0
    for a, b in gaps:
        idle += b - a
        i = bisect.bisect_left(ends, a)
        while i < len(program) and program[i][0] < b:
            idle -= min(b, program[i][1]) - max(a, program[i][0])
            i += 1
    return 100.0 * idle / (hi - lo)


def readings(spans: list, ops: list, slice_t0: float, slice_t1: float, slice_ticks: int, thread) -> dict:
    """The per-layer quantities the spans were placed for: host ms a tick
    from the spans that began outside the profiled slice [slice_t0,
    slice_t1] (seconds), device ms a tick and the idle share from the
    slice's operations; a quantity with nothing to read is left out."""
    out = {}
    outside = lambda name: [(s.end - s.start) * 1e-9 for s in spans
                            if s.name == name and not slice_t0 <= s.start * 1e-9 <= slice_t1]
    ticks = outside("channel.tick")
    if ticks:
        out["runtime.tick_host_ms"] = 1e3 * sum(ticks) / len(ticks)
        for key, name in (("runtime.layer_poll_host_ms", "layer.poll"), ("program.enqueue_host_ms", "channel.dispatch")):
            spent = outside(name)
            if spent:
                out[key] = 1e3 * sum(spent) / len(ticks)
    if ops and slice_ticks and any(o.launched is not None for o in ops):
        for key, name in (("program.sources_device_ms", "program.sources"),
                          ("program.combine_device_ms", "program.combine")):
            out[key] = 1e3 * sum(o.dur for o in launched_inside(ops, spans, name, thread)) / slice_ticks
    idle = idle_outside_program(ops, spans, thread)
    if idle is not None and spans:
        out["device.idle_outside_program_pct"] = idle
    return out
