#!/usr/bin/env python3
"""Compare the kernels of two checkouts on one card, in turns.

Unpack the commit to compare with (the parent) into a directory that
.gitignore lists, then run on the card, from the repository root:

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/compare_parent.py build/parent [--change DIR] [--out DIR]

It runs chip_smoke.py in the parent's checkout and in the change's (this
one, or --change DIR) as parent, change, change, parent, each in its own
process and each building its own kernels, and saves each run's output
as compare_<n>_<parent|change>.log in --out (default build/compare).
A checkout whose chip_smoke.py times kernels eagerly (before device_ms)
gets this one's device_ms for its kernel records, so both sides time a
kernel the same way: its launches captured in a CUDA graph and replayed
between events.
The labels of this checkout's chip_smoke.timed_shapes that the other
checkout's lacks (it may have none) are timed on that checkout's
kernels too, after its chip_smoke.py, and printed as one more
{"kernels": ...} line.
Then it prints, for every kernel record and timed mode of the two
checkouts' {"kernels": ...} lines, the better of each side's two runs
and the change's ratio to the parent, and exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: Path) -> int:
    """chip_smoke.main() of the checkout at ``tree``, with this checkout's
    device-time kernel timing if it has none of its own."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import chip_smoke as cs

    if not hasattr(cs, "device_ms"):
        here = _here()
        cs.best_of_two = here.best_of_two
    rc = cs.main()
    if rc or tree == ROOT:
        return rc
    import torch

    here, dev = _here(), torch.device("cuda", 0)
    have = set(cs.timed_shapes(torch, dev)) if hasattr(cs, "timed_shapes") else set()
    extra = {label: fn for label, (fn, *_) in here.timed_shapes(torch, dev).items() if label not in have}
    if extra:
        print(json.dumps({"kernels": [{"name": label, "ms": min(here.device_ms(torch, fn), here.device_ms(torch, fn))}
                                      for label, fn in extra.items()]}))
    return rc


def _here():
    """This checkout's chip_smoke.py, loaded beside the run tree's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return here


def kernel_times(log: str) -> dict:
    """{record or mode label: ms} from a run's {"kernels": ...} lines."""
    out = {}
    for line in log.splitlines():
        if line.startswith('{"kernels"'):
            for r in json.loads(line)["kernels"]:
                out[r["name"]] = r["ms"]
                for m in r.get("modes", []):
                    out[m["shape"]] = m["ms"]
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("parent", type=Path)
    parser.add_argument("--change", type=Path, default=ROOT)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "compare")
    parser.add_argument("--run-tree", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.run_tree is not None:
        return run_tree(args.run_tree.resolve())
    out_dir = args.out.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    times, failed = {"parent": [], "change": []}, []
    for n, side in enumerate(("parent", "change", "change", "parent")):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(trees["parent"]),
                               "--run-tree", str(trees[side])], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        (out_dir / f"compare_{n}_{side}.log").write_text(log)
        print(f"run {n} {side}: exit {proc.returncode}, {trees[side]}", flush=True)
        if proc.returncode:
            failed.append(n)
        times[side].append(kernel_times(proc.stdout))
    best = {side: {} for side in times}
    for side, runs in times.items():
        for run in runs:
            for label, ms in run.items():
                best[side][label] = min(ms, best[side].get(label, ms))
    for label in best["change"]:
        if label in best["parent"]:
            p, c = best["parent"][label], best["change"][label]
            print(f"{label}: parent {p:.4f} ms, change {c:.4f} ms, change / parent {c / p:.3f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
