"""Run one cell of the benchmark once and print its result line.

    python3 -m bench_h100 --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  It
refuses to run (exit 2, no result) without CUDA or with fewer cards than
the cell asks for; it never falls back to the CPU.  With ``--trace 0``
the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The last line of standard output
is the result; the numbers the correctness check compared, each with its
limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "phaneron_tpu")


def loaded_forbidden() -> list:
    """Modules in this process whose top-level name, taken whole, is one
    the benchmark may not load."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def p95(values: list) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    return statistics.quantiles(values, n=100)[94] if len(values) > 1 else values[0]


def end_to_end(run) -> dict:
    done = [t.done - t.called for t in run.ticks]
    out = {"setup_s": run.setup_s}
    if done:
        out["ticks_per_s"] = len(run.ticks) / run.window_s
        out["tick_p95_ms"] = 1e3 * p95(done)
    return out


def out_of_order(ticks: list) -> int:
    """Ticks of a channel delivered other than right after its previous
    one (a tick dropped, repeated or reordered)."""
    last: dict = {}
    bad = 0
    for t in ticks:
        if t.channel in last and t.index != last[t.channel] + 1:
            bad += 1
        last[t.channel] = t.index
    return bad


def per_layer(run) -> dict:
    from .spec import metric_reader

    out = {}
    for m in run.cell.per_layer:
        value = metric_reader(m["name"])(run.trace)
        if value is not None:
            out[m["name"]] = value
    return out


def judge(run, gaps: list) -> tuple:
    """(correct, failed, checks): the sampled ticks' code gaps against the
    cell's limit, every channel compared, no tick failed or out of order."""
    limit = run.cell.limits["code_gap"]
    worst = max((g for _, _, g in gaps), default=None)
    wrong = sum(g > limit for _, _, g in gaps)
    checks = {
        "code_gap": {"value": worst, "limit": limit},
        "channels_compared": {"value": len({c for c, _, _ in gaps}), "limit": run.cell.config["channels"]},
        "ticks_failed": {"value": run.failed, "limit": 0},
        "ticks_out_of_order": {"value": out_of_order(run.ticks), "limit": 0},
    }
    correct = (worst is not None and wrong == 0 and bool(run.ticks)
               and checks["channels_compared"]["value"] >= checks["channels_compared"]["limit"]
               and run.failed == 0 and checks["ticks_out_of_order"]["value"] == 0)
    return correct, run.failed + wrong, checks


def result_line(run, gaps: list, metrics: dict, kind: str, chips: int) -> dict:
    """The result: the contract's keys, then the numbers compared."""
    from .trace import breakdown

    correct, failed, checks = judge(run, gaps)
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end + run.cell.per_layer}
    result = {
        "correct": correct,
        "attempted": len(run.ticks) + run.failed,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if k in units},
        "device": {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": run.memory_peak_bytes},
    }
    if run.trace is not None:
        lo, hi = run.trace.window
        result["device"].update(busy_s=run.trace.busy_s, window_s=hi - lo)
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from .drive import reference_gaps, run_cell
    from .spec import load_benchmark, load_cell
    from .trace import launches_per_tick

    chips = next(w["chips"] for w in load_benchmark()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    run, bank, plan = asyncio.run(run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start=T0))
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"bench_h100: the run loaded {forbidden}", file=sys.stderr)
        return 3

    print(f"card: {card_line()}")
    print(f"memory_peak_bytes: {run.memory_peak_bytes} (torch.cuda.max_memory_allocated, set-up and window)")
    print("set-up phases ended at (s): " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items())
          + f"; window {run.setup_s:.3f}")
    for err in run.errors[:5]:
        print(f"tick failed: {err}", file=sys.stderr)
    metrics = end_to_end(run) if not args.trace else per_layer(run)
    if args.trace:
        print(f"launches a tick (profiled slice, {run.trace.slice_ticks} ticks): "
              f"{json.dumps(launches_per_tick(run.trace), sort_keys=True)}")
    # the program's state is freed (run_cell shut the channels down): the reference runs now
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = reference_gaps(run, bank, plan)
    print(f"reference: {len(gaps)} sampled ticks in {time.perf_counter() - t_ref:.3f} s; code gaps "
          f"{[g for _, _, g in gaps]}")
    result = result_line(run, gaps, metrics, torch.cuda.get_device_name(0), chips)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
