#!/usr/bin/env python3
"""Stress the CUDA graph replay of warm channel ticks (graph/replay.py) on
the card, on the cell uhd_rec.media's structure (chip_smoke.py
``media_spec_params``), and count every frame that is not the eager one.

    python3 tools/graph_stress.py [--rounds 64] [--ticks 8] [--queued 64]
                                  [--width 3840 --height 2160] [--out FILE]

- rounds: each a fresh runner, so a fresh capture (with the runner's own
  check of a replay against the first frame), then ``--ticks`` ticks, each
  with new source planes (chip_smoke ``cycled``) and a new MIX weight:
  the replay, an eager tick and a second eager tick, compared byte for
  byte.  Before each allocation of a tick the allocator's free blocks
  are filled with a pseudo-random pattern (``dirty``), so a byte a kernel
  leaves unwritten differs from tick to tick and shows in eager against
  eager as well;
- queued: ``--queued`` replays of one runner enqueued back to back with
  no wait (the next tick's rebind while the last is in flight, as the
  runtime's ticks do), their outputs held; then each against an eager
  tick of its params.

Prints one JSON line: captures, refusals, frames compared and those that
differ (round, tick, which comparison, output, bytes), the card and its
power limit.  Exits 1 if any frame differs or a capture is refused.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--queued", type=int, default=64)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--seed", type=int, default=27)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from phaneron_tpu_torch.graph import replay
    from phaneron_tpu_torch.graph.pipeline import make_channel_program
    from phaneron_tpu_torch.utils.metrics import tracer

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rng = np.random.default_rng(args.seed)
    spec, base = cs.media_spec_params(torch, dev, rng, args.width, args.height)
    spec = spec._replace(emit_rgba=False)
    program = make_channel_program(spec)
    program.prepare(dev)
    flat = lambda out: replay.flatten_out(out)[0]
    sizes = [replay._extent(t) for t in flat(program(base))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def dirty() -> None:
        """Fill the free blocks the next allocations take with a pattern."""
        junk = [torch.empty(n, dtype=torch.uint8, device=dev).random_(0, 256, generator=gen)
                for n in sizes * 2]
        del junk

    def tick(k: int) -> dict:
        p = cs.cycled(base, k)
        cs.media_animate(torch, p, dev, float(rng.random()))
        return p

    differ, compared, refusals, captures = [], 0, [], 0

    def compare(r: int, k: int, what: str, got, want) -> None:
        nonlocal compared
        compared += 1
        for i, n in replay._bytes_differ(flat(got), flat(want)):
            differ.append(dict(round=r, tick=k, compared=what, output=i, bytes=n))

    for r in range(args.rounds):
        runner = replay.GraphRunner()
        dirty()
        p = tick(1000 * r)
        runner.capture(spec, program, p, dev, program(p))
        if runner.refusals:
            refusals.append(dict(round=r, why=runner.refusals[spec]))
            continue
        captures += 1
        for k in range(1, args.ticks + 1):
            p = tick(1000 * r + k)
            dirty()
            got = runner.run(spec, program, p, dev)
            dirty()
            want = program(p)
            dirty()
            again = program(p)
            compare(r, k, "replay-eager", got, want)
            compare(r, k, "eager-eager", want, again)
        del runner, p, got, want, again
        gc.collect()
        torch.cuda.empty_cache()

    runner = replay.GraphRunner()
    p = tick(-1)
    runner.capture(spec, program, p, dev, program(p))
    held = []
    for k in range(args.queued):
        p = tick(-2 - k)
        held.append((p, runner.run(spec, program, p, dev)))
    for k, (p, got) in enumerate(held):
        compare(-1, k, "queued-eager", got, program(p))
    counts = {n: v for n, v in tracer.counters().items() if n.startswith("program.graph")}

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if dev.type == "cuda" else "cpu"
    line = json.dumps(dict(card=card, size=f"{args.width}x{args.height}", rounds=args.rounds, ticks=args.ticks,
                           queued=args.queued, captures=captures, refusals=refusals, compared=compared,
                           differ=differ, counters=counts))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if differ or refusals else 0


if __name__ == "__main__":
    sys.exit(main())
