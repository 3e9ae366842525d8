"""Tracing / profiling utilities (counterpart of
phaneron_tpu/utils/metrics.py).

Parity with the reference's instrumentation: the per-kernel RunTimings
tables become per-stage host timers with percentile aggregation
(showTimings levels), the buffer census (clContext.logBuffers) becomes
the CUDA caching allocator's statistics, and full device traces come
from torch.profiler."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

__all__ = ["StageTimings", "device_memory_stats", "profiler_trace"]


class StageTimings:
    """Ring-buffered per-stage wall timings with percentile summary
    (the ClProcessJobs.logTimings equivalent, clJobQueue.ts:159-215)."""

    def __init__(self, window: int = 512):
        self.window = window
        self._samples: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._samples[name].append(time.monotonic() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, samples in self._samples.items():
            arr = np.asarray(samples) * 1e3
            if arr.size == 0:
                continue
            out[name] = {
                "n": int(arr.size),
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "max_ms": float(arr.max()),
            }
        return out

    def log_table(self) -> str:
        rows = [f"{'stage':24s} {'n':>6s} {'p50 ms':>8s} {'p99 ms':>8s} {'max ms':>8s}"]
        for name, s in sorted(self.summary().items()):
            rows.append(
                f"{name:24s} {s['n']:6d} {s['p50_ms']:8.3f} {s['p99_ms']:8.3f} {s['max_ms']:8.3f}"
            )
        return "\n".join(rows)


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


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """A torch.profiler trace of the host and the card, written to
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
