"""The readings the comparison's limit is set from, for one cell, in one
process: for each seed, a short window of the program at the cell's own
size and load, then the largest code gap of its sampled ticks from the
float32 reference (the program's reading) and that of the reference
computed in bfloat16 in the program's place (the control's reading).

    python3 -m bench_h100.calibrate --workload <cell> --seeds 1,2,3 --seconds 2 \
        [--faults mix_frozen,mix_reversed --fault-seeds 4,5,6]

prints one JSON line a seed and a last line with the largest program
reading and the smallest control reading.  With ``--faults``, each
fault of ``faults.py`` is then planted in the program and read on each
of ``--fault-seeds``: one line a fault and seed, and the smallest
reading of each fault on the last line.  The benchmark's runs do not
run this; it needs a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import torch

from .drive import control_gaps, reference_gaps, run_cell
from .faults import planted
from .spec import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", default="", help="comma-separated names from faults.py")
    ap.add_argument("--fault-seeds", default="", help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_h100.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    program, control = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, bank, plan = asyncio.run(run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0)))
        torch.cuda.empty_cache()
        p = [g for *_, g in reference_gaps(run, bank, plan)]
        c = [g for *_, g in control_gaps(run, bank, plan)]
        program.append(max(p))
        control.append(max(c))
        print(json.dumps({"cell": cell.name, "seed": seed, "ticks": len(run.ticks), "failed": run.failed,
                          "program_gaps": p, "control_gaps": c, "seconds": time.perf_counter() - t0}), flush=True)
    faults = {}
    for fault in filter(None, args.faults.split(",")):
        for seed in (int(s) for s in args.fault_seeds.split(",")):
            with planted(fault):
                run, bank, plan = asyncio.run(run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0)))
            torch.cuda.empty_cache()
            gaps = [g for *_, g in reference_gaps(run, bank, plan)]
            faults.setdefault(fault, []).append(max(gaps))
            print(json.dumps({"cell": cell.name, "fault": fault, "seed": seed, "ticks": len(run.ticks),
                              "failed": run.failed, "gaps": gaps}), flush=True)
    print(json.dumps({"cell": cell.name, "seeds": len(program), "program_max": max(program),
                      "control_min": min(control), "control_max": max(control),
                      "fault_min": {f: min(g) for f, g in faults.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
