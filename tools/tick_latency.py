#!/usr/bin/env python3
"""A benchmark cell's tick latency taken apart, on the card.

    cd <checkout> && python3 <this file> --workload uhd_rec.media --seed N [--seconds 30]

runs one untraced window of the cell with the checkout's own bench_h100
and phaneron_tpu_torch (the working directory comes first on sys.path,
so a parent checkout can be measured with this file) and prints one JSON
line over the ticks completed in the window:

- ``ticks_per_s`` and ``tick_p95_ms`` as the benchmark computes them;
- the latency (``render_frame`` call to the output complete on the card)
  as mean and p5, p25, p50, p75, p95, p99, in ms;
- its host part (call to the sink's delivery) and its card part
  (delivery to completion), each as mean and p95;
- ``in_flight``: the time-average number of ticks called and not yet
  complete, the window's latencies summed over its length (Little's
  law), and ``in_flight_card`` the same of the card part alone;
- ``card_period_ms``: the median time between two completions on the
  card, the device's own pace when it is the bottleneck.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys


def _stats(values: list) -> dict:
    q = statistics.quantiles(values, n=100)
    return dict(mean=1e3 * statistics.fmean(values), p5=1e3 * q[4], p25=1e3 * q[24], p50=1e3 * q[49],
                p75=1e3 * q[74], p95=1e3 * q[94], p99=1e3 * q[98])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    from bench_h100.drive import run_cell
    from bench_h100.spec import load_cell

    run, _, _ = asyncio.run(run_cell(load_cell(args.workload), args.seed, args.seconds, False,
                                     torch.device("cuda", 0)))
    ticks = run.ticks
    total = [t.done - t.called for t in ticks]
    host = [t.delivered - t.called for t in ticks]
    card = [t.done - t.delivered for t in ticks]
    done = sorted(t.done for t in ticks)
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(
        tree=os.getcwd(), card=name, workload=args.workload, seed=args.seed, ticks=len(ticks),
        ticks_per_s=len(ticks) / run.window_s, tick_p95_ms=1e3 * statistics.quantiles(total, n=100)[94],
        latency_ms=_stats(total),
        host_ms=dict(mean=1e3 * statistics.fmean(host), p95=1e3 * statistics.quantiles(host, n=100)[94]),
        card_ms=dict(mean=1e3 * statistics.fmean(card), p95=1e3 * statistics.quantiles(card, n=100)[94]),
        in_flight=sum(total) / run.window_s, in_flight_card=sum(card) / run.window_s,
        card_period_ms=1e3 * statistics.median(b - a for a, b in zip(done, done[1:])),
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
