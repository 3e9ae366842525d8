"""Frame pacing without hardware genlock (a copy of
phaneron_tpu/runtime/clock.py).

The reference paces SDI output against the DeckLink hardware clock
(macadamConsumer.ts:174-197 waitHW).  In cloud deployments there is
no genlock, so channels pace against a monotonic wall clock with drift
accounting and late-frame detection (SURVEY.md §7.4 item 5)."""

from __future__ import annotations

import asyncio
import time

__all__ = ["FrameClock"]


class FrameClock:
    """Paces frame numbers n at origin + n * (duration/timescale)."""

    def __init__(self, timescale: int, duration: int, late_warn_ms: float = 15.0):
        self.period = duration / timescale
        self.origin: float | None = None
        self.late_warn = late_warn_ms / 1e3
        self.late_frames = 0
        self.total_frames = 0

    def reset(self):
        self.origin = None
        self.late_frames = 0
        self.total_frames = 0

    async def wait(self, frame: int) -> float:
        """Sleep until frame's deadline; returns lateness in seconds
        (positive = behind schedule, like the DeckLink late warning,
        macadamConsumer.ts:186-193)."""
        now = time.monotonic()
        if self.origin is None:
            self.origin = now
        deadline = self.origin + frame * self.period
        delay = deadline - now
        if delay > 0:
            await asyncio.sleep(delay)
            late = 0.0
        else:
            late = -delay
        self.total_frames += 1
        if late > self.late_warn:
            self.late_frames += 1
        if late > 4 * self.period:
            # a long stall (e.g. an unpredicted compile) happened: you
            # cannot replay the past in broadcast — re-anchor to the
            # present so ONE stall counts its own lateness instead of
            # marking every subsequent on-pace frame late forever (the
            # hardware-genlock analogue realigns the same way)
            self.origin += late
        return late
