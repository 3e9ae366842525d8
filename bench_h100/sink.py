"""The benchmark's sink: a Consumer that keeps each tick's packed output
on the card and learns when it is complete there.

``deliver`` records a CUDA event behind the tick's work and queues it
for the ``Waiter``, a thread that synchronises the events in the order
they were recorded (one stream: the order they complete) and hands each
tick's in-flight slot back to the event loop.  The time a tick's output
was complete is read afterwards from the events themselves, as device
time from an event recorded with the card idle at a known host time, so
the waiter's wake-up (it needs the interpreter lock) never enters a
latency.  A reservoir drawn from the seed keeps the packed planes of
``keep`` ticks of the window for the correctness check; no tick is
copied to the host.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["Waiter", "Tick", "make_sink"]


@dataclass
class Tick:
    channel: int
    index: int  # the channel's frame timestamp
    called: float  # host perf_counter at the render_frame call
    event: Optional[torch.cuda.Event]
    window: bool
    delivered: float  # host perf_counter when the sink got it
    done: float = 0.0  # host time its output was complete (set after the run)


class Waiter:
    """One thread that waits on the ticks' events in order and calls
    ``release`` of each on the event loop."""

    def __init__(self, loop):
        self.loop = loop
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, name="bench-waiter", daemon=True)
        self.error: Optional[BaseException] = None
        self.thread.start()

    def put(self, event, release) -> None:
        self.q.put((event, release))

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            event, release = item
            try:
                if event is not None:
                    event.synchronize()
            except RuntimeError as err:  # a failed kernel: reported by the run
                self.error = err
            self.loop.call_soon_threadsafe(release)

    def close(self) -> None:
        self.q.put(None)
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("bench sink: the waiter thread did not stop")


def make_sink(out_format: str, channel: int, waiter: Waiter, slots, keep: int, seed: int):
    """A Consumer subclass instance for one channel (the program is
    imported when a run builds its channels)."""
    from phaneron_tpu_torch.consumer.consumer import Consumer

    class BenchSink(Consumer):
        pix_format = out_format
        needs_rgba = False

        def __init__(self):
            super().__init__({})
            self.ticks: list[Tick] = []
            self.called: dict[int, float] = {}  # frame index -> render_frame call time
            self.window = False  # ticks delivered now belong to the measured window
            self.samples: dict[int, list] = {}  # frame index -> packed planes
            self._seen = 0
            self._rng = np.random.default_rng([int(seed) % 2**63, channel, 7])

        async def deliver(self, frame) -> None:
            cuda = self.device is not None and torch.device(self.device).type == "cuda"
            # blocking: the waiter sleeps in its wait instead of spinning on a core
            event = torch.cuda.Event(enable_timing=True, blocking=True) if cuda else None
            if event is not None:
                event.record()
            self.ticks.append(Tick(channel, frame.timestamp, self.called.pop(frame.timestamp), event,
                                   self.window, time.perf_counter()))
            if self.window:
                self._sample(frame)
            waiter.put(event, slots.release)

        def _sample(self, frame) -> None:
            """Reservoir sampling of the window's ticks."""
            self._seen += 1
            if len(self.samples) < keep:
                self.samples[frame.timestamp] = frame.packed
                return
            j = int(self._rng.integers(0, self._seen))
            if j < keep:
                del self.samples[sorted(self.samples)[j]]
                self.samples[frame.timestamp] = frame.packed

    return BenchSink()
