"""Tracing utilities (counterpart of phaneron_tpu/utils/metrics.py).

``tracer`` is the port's one tracer, one per process.  The runtime and
the frame program open its spans where their work happens
(``tracer.span(name, chan)``: ``channel.tick``, ``layer.poll``,
``slot.video``, ``slot.audio``, ``channel.dispatch``,
``channel.dispatch_cold``, ``program.sources``, ``program.layers``,
``program.combine``, ``program.pack``, ``channel.amix``,
``consumer.deliver``; ``python.gc`` from a ``gc.callbacks`` hook) and
add to its counters at rare events (``program.structures``,
``channel.cold_dispatches``, ``ops.library_builds.built``,
``.loaded`` and ``.seconds``).

Off (the default), ``span()`` returns one shared null context: no clock
is read and nothing is allocated.  Counters are kept whether it is on or
off.  ``start()`` turns aggregation on: each (channel, name) keeps a
count, a total and a ring of recent durations (``summary``,
``log_table``: the reference's showTimings tables, clJobQueue.ts:159-215).
``record()`` also keeps every closed span raw (a ``Span``: name,
channel, thread id, ``perf_counter_ns`` start and end) until ``drain()``
returns them, as numbers in arrays: a long recording leaves the garbage
collector nothing more to walk.  A span with no channel takes the
channel of the span that encloses it in the same task or thread (a
context variable, which ``asyncio.to_thread`` carries to its worker).

The buffer census (clContext.logBuffers) is ``device_memory_stats``, the
CUDA caching allocator's statistics."""

from __future__ import annotations

import contextvars
import gc
import threading
import time
from array import array
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Span", "Tracer", "tracer", "device_memory_stats"]

_CHAN: contextvars.ContextVar = contextvars.ContextVar("phaneron_span_channel", default=None)


class Span(NamedTuple):
    """One closed span: ``start`` and ``end`` are ``time.perf_counter_ns``."""

    name: str
    chan: Optional[int]
    thread: int
    start: int
    end: int


class _Raw:
    """Closed spans as columns of numbers (a name's code, channel or -1,
    thread, start, end)."""

    def __init__(self):
        self.codes: dict = {}
        self.cols = (array("q"), array("q"), array("Q"), array("q"), array("q"))

    def append(self, name: str, chan, thread: int, t0: int, t1: int) -> None:
        code = self.codes.get(name)
        if code is None:
            code = self.codes[name] = len(self.codes)
        names, chans, threads, starts, ends = self.cols
        names.append(code)
        chans.append(-1 if chan is None else chan)
        threads.append(thread)
        starts.append(t0)
        ends.append(t1)

    def spans(self) -> list:
        names = list(self.codes)
        return [Span(names[n], None if c < 0 else c, th, a, b) for n, c, th, a, b in zip(*self.cols)]


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span while it is open (the tracer was on when it was opened)."""

    __slots__ = ("tracer", "name", "chan", "token", "t0")

    def __init__(self, tracer: "Tracer", name: str, chan):
        self.tracer, self.name, self.chan, self.token = tracer, name, chan, None

    def __enter__(self):
        if self.chan is None:
            self.chan = _CHAN.get()
        else:
            self.token = _CHAN.set(self.chan)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.token is not None:
            _CHAN.reset(self.token)
        self.tracer._close(self.name, self.chan, threading.get_ident(), self.t0, t1)
        return False


class Tracer:
    """Spans and counters; see the module docstring."""

    RING = 512  # recent durations kept for each (channel, name) while on

    def __init__(self):
        self.on = False
        self._raw: Optional[_Raw] = None
        # re-entrant: the gc hook closes its span on whichever thread
        # collects, possibly inside another span's _close
        self._lock = threading.RLock()
        self._stats: dict = {}  # (chan, name) -> [count, total ns, deque of recent ns]
        self._counters: dict = {}
        self._gc_t0: dict = {}  # thread id -> collection start ns

    def span(self, name: str, chan: Optional[int] = None):
        """A context manager timing ``name`` on channel ``chan`` (None: the
        enclosing span's); the shared null context while off."""
        return _Open(self, name, chan) if self.on else _NULL

    def count(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def start(self) -> None:
        """Aggregate spans (and time garbage collections as ``python.gc``)."""
        with self._lock:
            if not self.on:
                self.on = True
                gc.callbacks.append(self._gc)

    def stop(self) -> None:
        """Open no more spans; raw recording ends and its spans are dropped."""
        with self._lock:
            if self.on:
                self.on = False
                self._raw = None
                self._gc_t0.clear()
                gc.callbacks.remove(self._gc)

    def record(self) -> None:
        """Start (if off) and keep every span closed from now, raw."""
        with self._lock:
            self.start()
            self._raw = _Raw()

    def drain(self) -> list:
        """The raw spans recorded since ``record()``; recording ends."""
        with self._lock:
            raw, self._raw = self._raw, None
        return raw.spans() if raw is not None else []

    def reset(self) -> None:
        """Forget every aggregate and counter (on or off stays as it is)."""
        with self._lock:
            self._stats.clear()
            self._counters.clear()

    def _close(self, name: str, chan, thread: int, t0: int, t1: int) -> None:
        with self._lock:
            s = self._stats.get((chan, name))
            if s is None:
                s = self._stats[(chan, name)] = [0, 0, deque(maxlen=self.RING)]
            s[0] += 1
            s[1] += t1 - t0
            s[2].append(t1 - t0)
            if self._raw is not None:
                self._raw.append(name, chan, thread, t0, t1)

    def _gc(self, phase: str, _info) -> None:
        now = time.perf_counter_ns()
        thread = threading.get_ident()
        if phase == "start":
            self._gc_t0[thread] = now
        else:
            t0 = self._gc_t0.pop(thread, None)
            if t0 is not None:
                self._close("python.gc", None, thread, t0, now)

    def durations(self, name: str, chan: Optional[int] = None) -> list:
        """The recent durations of ``name`` on ``chan``, seconds, oldest first."""
        with self._lock:
            s = self._stats.get((chan, name))
            return [ns * 1e-9 for ns in s[2]] if s else []

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def summary(self) -> dict:
        """(chan, name) -> n, mean ms over all, p50 / p99 / max ms of the ring."""
        with self._lock:
            items = [(k, s[0], s[1], list(s[2])) for k, s in self._stats.items()]
        out = {}
        for key, n, total, recent in items:
            ms = np.asarray(recent, np.float64) * 1e-6
            out[key] = {"n": n, "mean_ms": total * 1e-6 / n, "p50_ms": float(np.percentile(ms, 50)),
                        "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max())}
        return out

    def log_table(self) -> str:
        rows = [f"{'chan':>4s} {'span':24s} {'n':>8s} {'mean ms':>8s} {'p50 ms':>8s} {'p99 ms':>8s} {'max ms':>8s}"]
        for (chan, name), s in sorted(self.summary().items(), key=lambda kv: (str(kv[0][0]), kv[0][1])):
            rows.append(f"{'-' if chan is None else chan:>4} {name:24s} {s['n']:8d} {s['mean_ms']:8.3f} "
                        f"{s['p50_ms']:8.3f} {s['p99_ms']:8.3f} {s['max_ms']:8.3f}")
        for name, v in sorted(self.counters().items()):
            rows.append(f"counter {name} {v:g}")
        return "\n".join(rows)


tracer = Tracer()


def device_memory_stats(device: torch.device | str = "cuda") -> dict:
    """Device memory census — the clContext.logBuffers() analogue: the
    CUDA caching allocator's bytes in use, their peak, and the card's
    memory.  No CUDA device: every count is None."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {"device": str(device), "bytes_in_use": None, "peak_bytes_in_use": None,
                "bytes_limit": None}
    stats = torch.cuda.memory_stats(device)
    return {
        "device": str(device),
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
