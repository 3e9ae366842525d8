"""The traced run's readings: host spans from wrappers on the channels'
public calls, and the card's operations from ``torch.profiler`` over a
steady slice of the window.

``Spans.wrap`` times each channel's ``render_frame`` and each of its
layers' ``poll`` for the whole window.  ``ProfiledSlice`` profiles the
card from ``START`` of the window until ``TICKS`` ticks are delivered
(or ``END`` of the window), then synchronises; it reads the card's
kernels, copies and fills from the profiler's trace, in the host's
timebase, and labels each idle gap on the card with the host span
it fell in.  The per-layer metrics (``metrics/``) read a ``Trace``.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import roofline

__all__ = ["Spans", "ProfiledSlice", "Trace", "DeviceOp"]

START, END, TICKS = 0.35, 0.9, 300


class Spans:
    """(label, start, end) host spans of the wrapped calls, perf_counter seconds."""

    def __init__(self):
        self.spans: list = []

    def _timed(self, fn, label: str):
        spans = self.spans

        async def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return await fn(*args, **kw)
            finally:
                spans.append((label, t0, time.perf_counter()))

        return call

    def wrap(self, chans) -> None:
        for ch in chans:
            ch.render_frame = self._timed(ch.render_frame, "Channel.render_frame")
            for lay in ch.layers.values():
                lay.poll = self._timed(lay.poll, "Layer.poll")


@dataclass
class DeviceOp:
    name: str
    cat: str
    start: float  # host perf_counter seconds
    dur: float  # seconds

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Trace:
    spans: list  # (label, start, end), the whole window
    ops: list  # DeviceOp of the slice
    slice_t0: float  # host times of the profiled slice
    slice_t1: float
    slice_ticks: int  # ticks delivered in the slice
    window: tuple  # (first device op start, last device op end) of the slice
    busy_s: float
    gaps: list  # (seconds, label) the slice's ten longest idle gaps on the card
    stages: list  # per channel: roofline.Stage of one tick
    by_kernel: dict = field(default_factory=dict)  # op name -> (launches, seconds)

    def outside(self, label: str) -> list:
        """Durations of ``label`` spans that began outside the slice."""
        return [b - a for name, a, b in self.spans
                if name == label and not self.slice_t0 <= a <= self.slice_t1]

    def stage_least(self) -> dict:
        """kind -> (least seconds of its stages in a tick, stages in a
        tick), averaged over the channels."""
        out = {}
        n = len(self.stages)
        for stages in self.stages:
            for s in stages:
                least, count = out.get(s.kind, (0.0, 0.0))
                out[s.kind] = (least + s.least_s / n, count + 1.0 / n)
        return out


class ProfiledSlice:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.anchor = 0.0
        self.ticks = 0
        self.path = None

    def _activities(self):
        from torch.profiler import ProfilerActivity

        # the card alone: recording every host operation would slow the
        # host, which paces some cells
        return [ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU]

    def warm(self) -> None:
        """Start and stop the profiler once in set-up (its first start
        initialises the tracer)."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    async def take(self, w0: float, seconds: float, sinks) -> None:
        """Profile the card from START of the window until TICKS ticks are
        delivered.  The card is synchronised first, and a marker operation
        launched at a known host time is the first on the card in the
        trace: it ties the trace's clock to the host's."""
        from torch.profiler import profile

        await asyncio.sleep(max(0.0, w0 + START * seconds - time.perf_counter()))
        delivered = lambda: sum(len(s.ticks) for s in sinks)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        n0 = delivered()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.anchor = time.perf_counter()
        torch.zeros(1, device=self.device)  # the marker
        self.t0 = self.anchor
        while delivered() - n0 < TICKS and time.perf_counter() < w0 + END * seconds:
            await asyncio.sleep(0.002)
        self.ticks = delivered() - n0
        if cuda:
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        fd, self.path = tempfile.mkstemp(prefix="bench_h100_trace_", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def _events(self) -> list:
        """The card's operations after the marker, in host perf_counter
        seconds."""
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)
        dev = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in e),
                     key=lambda e: float(e["ts"]))
        if not dev:
            return []
        marker_us = float(dev[0]["ts"])
        return [DeviceOp(e["name"], e["cat"], self.anchor + (float(e["ts"]) - marker_us) / 1e6,
                         float(e.get("dur", 0)) / 1e6) for e in dev[1:]]

    def result(self, spans: Spans, stages: list) -> Trace:
        ops = [o for o in self._events() if o.end >= self.t0 and o.start <= self.t1]
        if not ops:
            return Trace(spans.spans, [], self.t0, self.t1, self.ticks, (self.t0, self.t0), 0.0, [], stages)
        lo, hi = ops[0].start, max(o.end for o in ops)
        busy, gaps, cur_a, cur_b = 0.0, [], ops[0].start, ops[0].end
        for o in ops[1:]:
            if o.start > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, o.start))
                cur_a, cur_b = o.start, o.end
            else:
                cur_b = max(cur_b, o.end)
        busy += cur_b - cur_a
        near = [sp for sp in spans.spans if sp[2] >= self.t0 and sp[1] <= self.t1]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        labelled = [(b - a, _label(near, (a + b) / 2)) for a, b in longest]
        by_kernel: dict = defaultdict(lambda: [0, 0.0])
        for o in ops:
            by_kernel[o.name][0] += 1
            by_kernel[o.name][1] += o.dur
        return Trace(spans.spans, ops, self.t0, self.t1, self.ticks, (lo, hi), busy, labelled, stages,
                     {k: tuple(v) for k, v in by_kernel.items()})


def _label(spans: list, t: float) -> str:
    """The innermost wrapped host call running at host time t."""
    inner = None
    for name, a, b in spans:
        if a <= t <= b and (inner is None or b - a < inner[2] - inner[1]):
            inner = (name, a, b)
    return inner[0] if inner else "event loop (no tick in a wrapped call)"


def short_name(name: str) -> str:
    """A device operation's name without 'void ' and its parameter list."""
    n = name[5:] if name.startswith("void ") else name
    depth, cut = 0, len(n)
    for i in range(len(n) - 1, -1, -1):
        if n[i] == ")":
            depth += 1
        elif n[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    return n[:cut][:160]


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing."""
    top = sorted(trace.by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(trace.gaps, key=lambda g: -g[0])[:10]
    return {"device_ops": [[short_name(k), v[1]] for k, v in top],
            "idle_gaps": [[label, s] for s, label in gaps]}


def launches_per_tick(trace: Trace) -> dict:
    """Launches a tick of each of the port's kernels (by stage kind) and of
    PyTorch's operations, in the slice."""
    out: dict = defaultdict(float)
    for name, (n, _) in trace.by_kernel.items():
        kind = roofline.kernel_kind(name)
        key = kind if kind else ("torch ops" if roofline.is_torch_op(name) else short_name(name))
        out[key] += n / max(trace.slice_ticks, 1)
    return dict(out)
