#!/usr/bin/env python3
"""Where the device time of the PyTorch + CUDA port goes, on one GPU.

Run from the repository root:  python3 tools/port_profile.py [--periods N]

Drives chip_smoke.py's main paths (the interlaced default load, four
1080i50 channels, one frame period per step; the entry() channel frame
at 1920x1080; the progressive 4-layer frame at 3840x2160 and 1920x1080;
the playout dissolve at 1920x1080 and 3840x2160; the straggler channels:
one_rotation and wipe at 3840x2160 and 1920x1080, the rotated
distinct-matrix dissolve and the emit_rgba frames at 1920x1080; the
file-media channel with its two consumer packs at 1920x1080 and
3840x2160; the file-media multi-box channel into v210 with emit_rgba at
1920x1080 and 3840x2160 and into yuv422p10le at 1920x1080; the
progressive 4-layer frame into yuv422p10le at 1920x1080; the keyed
graphic over two boxes and a rotation, emit_rgba, at 1920x1080; the v210
unpack and pack stage programs at 1920x1080, one K1 and one K2 a step;
the default load again through the port's runtime, four 1080i50
Channels with test-pattern sources, one frame period a step)
under torch.profiler after warm-up, and prints
for each: the host-clock ms per step without the profiler (synchronised
before and after), the device time per step by kernel (self device time
of the device-side events in key_averages), the device's busy share of
the step, the number of device operations per step, and the host time
of each stage (record_function ranges that chip_smoke.InterlacedLoad
opens through its ``stage`` hook).  The runtime's steps are read through
the port's tracer (``phaneron_tpu_torch/utils/metrics.py``) instead:
each of its spans' host ms per step and the device ms of the operations
launched inside it (tools/span_trace.py).  Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import span_trace as st  # noqa: E402


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def host_ms(torch, step, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def print_spans(prof, anchors: list, spans: list, steps: int) -> None:
    """Each of the tracer's spans recorded over the profiled steps: host ms
    and count per step (every thread; ``consumer.deliver`` by channel, as
    each channel has its own consumers), and the device ms per step of the
    operations launched with it the innermost span open on the event loop
    thread."""
    ops, lag, drift = st.device_ops(st.export_events(prof), anchors)
    loop = st.loop_thread(spans)
    dev = st.by_span(ops, spans, loop)
    host: dict = defaultdict(lambda: [0.0, 0])
    for s in spans:
        key = f"{s.name} ch{s.chan}" if s.name == "consumer.deliver" else s.name
        host[key][0] += (s.end - s.start) * 1e-9
        host[key][1] += 1
    ties = ("no launch event of the markers" if lag is None else
            f"the trace's device clock {lag * 1e6:.1f} us off its host clock, drifting {drift * 1e6:.1f} us; "
            f"{st.late_launches(ops)} of {len(ops)} device ops with their launch after their start")
    print(f"   tracer spans (profiled): {ties}")
    for name in sorted(set(host) | {k for k in dev if k is not None}):
        h, n = host.get(name, (0.0, 0))
        d, k = dev.get(name, (0.0, 0))
        print(f"   span {name:<22} host {1e3 * h / steps:9.4f} ms x{n / steps:5.1f}, device {1e3 * d / steps:9.4f} "
              f"ms x{k / steps:5.1f} per step")
    d, k = dev.get(None, (0.0, 0))
    print(f"   launched outside every span (or with no launch event): device {1e3 * d / steps:9.4f} ms "
          f"x{k / steps:5.1f} per step")


def profile(torch, name: str, step, steps: int, card: str, spans: bool = False) -> None:
    """``spans``: record the tracer's spans over the profiled steps too,
    and tie them to the card with a marker before and after each step
    (``print_spans``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from phaneron_tpu_torch.utils.metrics import tracer

    for _ in range(3):
        step()
    wall = host_ms(torch, step, max(steps, 5))
    torch.cuda.synchronize()
    anchors, was_on = [], tracer.on
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if spans:
            tracer.record()
            anchors.append(st.mark(torch, "cuda"))
        for i in range(steps):
            step()
            if spans and i < steps - 1:
                anchors.append(st.mark(torch, "cuda"))
        torch.cuda.synchronize()
        if spans:
            anchors.append(st.mark(torch, "cuda"))  # the card idle, as at the first
            torch.cuda.synchronize()
    recorded = tracer.drain() if spans else []
    if not was_on:
        tracer.stop()
    events = prof.key_averages()
    on_device = lambda e: e.device_type == DeviceType.CUDA
    # device-side events only: the host-side op that launched a kernel
    # carries the same device time
    kernels = [e for e in events if on_device(e) and not e.key.startswith("stage:") and st.MARKER not in e.key]
    busy = sum(device_us(e) for e in kernels) / steps / 1e3
    launches = sum(e.count for e in kernels) / steps
    print(f"== {name} on {card}: host-clock {wall:.4f} ms per step (no profiler), device busy "
          f"{busy:.4f} ms per step ({100 * busy / wall:.1f} %), {launches:.0f} device "
          f"kernels and copies per step, {steps} steps profiled")
    for e in sorted(kernels, key=device_us, reverse=True)[:14]:
        ms = device_us(e) / steps / 1e3
        print(f"   {ms:9.4f} ms  {100 * ms / busy:5.1f} %  x{e.count / steps:6.1f}  {e.key[:90]}")
    # host time of each stage range (the profiler's own overhead
    # included); its device time is that of its kernels above
    for e in sorted(events, key=lambda e: e.key):
        if e.key.startswith("stage:") and not on_device(e):
            print(f"   stage {e.key[6:]:<12} host {e.cpu_time_total / steps / 1e3:9.4f} ms "
                  f"per step (profiled)")
    if spans:
        print_spans(prof, anchors, recorded, steps)


def profile_runtime(torch, dev, periods: int, card: str) -> None:
    """The default load through the port's runtime (chip_smoke.py
    runtime_interlaced_set: four 1080i50 Channels, each four dissolving
    test-pattern layers under MIXER FILL), one frame period (two ticks of
    each channel, render_frame and deliver) a step, read through the
    tracer's spans: ``channel.tick``, ``layer.poll`` (which holds
    ``slot.video``, SourceSlot.tick with its unpack and pair deinterlace,
    and ``slot.audio``), ``channel.dispatch`` (the frame program, with its
    ``program.*`` stages), ``channel.amix``."""
    import asyncio

    loop = asyncio.new_event_loop()
    chans = loop.run_until_complete(cs.runtime_interlaced_set(dev, plain=False))
    for _ in range(2 * cs.RUNTIME_FILL_PERIODS):
        loop.run_until_complete(cs.runtime_tick(chans))
    period = lambda: [loop.run_until_complete(cs.runtime_tick(chans)) for _ in (0, 1)]
    profile(torch, "runtime: 4 x 1080i50 Channels (render_frame + deliver), one frame period", period,
            periods, card, spans=True)
    for ch, _ in chans:
        loop.run_until_complete(ch.shutdown())
    loop.close()


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--periods", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    import numpy as np
    from torch.profiler import record_function

    from phaneron_tpu_torch.graph.pipeline import make_channel_program

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    rng = np.random.default_rng(cs.SEED)

    load = cs.InterlacedLoad(cs.interlaced_inputs(torch, dev, rng), plain=False)
    load.stage = lambda name: record_function(f"stage:{name}")

    profile(torch, "interlaced default load, 4 x 1080i50, one frame period", load,
            args.periods, card)
    profile_runtime(torch, dev, args.periods, card)

    spec, params = cs.entry_spec_params(rng, dev)
    program = make_channel_program(spec)
    cs.animate(torch, params, dev, 0.5)
    profile(torch, "entry() channel frame, 1080p", lambda: program(params), 50, card)

    for w, h in ((cs.UHD_W, cs.UHD_H), (cs.W, cs.H)):
        pspec, pparams = cs.progressive_spec_params(torch, dev, rng, w, h)
        pprog = make_channel_program(pspec)
        cs.progressive_animate(torch, pparams, dev, 0.5)
        profile(torch, f"progressive 4-layer frame, {w}x{h}", lambda: pprog(pparams), 20, card)
    for w, h in ((cs.W, cs.H), (cs.UHD_W, cs.UHD_H)):
        sspec, sparams = cs.playout_spec_params(torch, dev, rng, w, h, dissolve=True)
        sprog = make_channel_program(sspec)
        cs.playout_animate(torch, sparams, dev, 0.5)
        profile(torch, f"playout dissolve, {w}x{h}", lambda: sprog(sparams), 50, card)
    cases = [(v, w, h, False) for v in ("one_rotation", "wipe") for w, h in ((cs.UHD_W, cs.UHD_H), (cs.W, cs.H))]
    cases += [("rotated_pair", cs.W, cs.H, False), ("one_rotation", cs.W, cs.H, True)]
    for variant, w, h, emit_rgba in cases:
        vspec, vparams = cs.straggler_spec_params(torch, dev, w, h, variant, emit_rgba)
        vprog = make_channel_program(vspec)
        cs.straggler_animate(torch, vparams, dev, w, h, variant, 0.5)
        profile(torch, f"{variant}{' emit_rgba' if emit_rgba else ''}, {w}x{h}", lambda: vprog(vparams), 20, card)
    espec, eparams = cs.progressive_spec_params(torch, dev, rng, cs.W, cs.H)
    eprog = make_channel_program(espec._replace(emit_rgba=True))
    cs.progressive_animate(torch, eparams, dev, 0.5)
    profile(torch, f"progressive 4-layer frame emit_rgba, {cs.W}x{cs.H}", lambda: eprog(eparams), 20, card)
    for w, h in ((cs.W, cs.H), (cs.UHD_W, cs.UHD_H)):
        mspec, mparams = cs.media_spec_params(torch, dev, rng, w, h)
        media = cs.MediaChannel(mspec, plain=False)
        cs.media_animate(torch, mparams, dev, 0.5)
        profile(torch, f"media channel and its rgba8 / nv12 consumer packs, {w}x{h}", lambda: media(mparams),
                20, card)
    for w, h, fmt, emit_rgba in ((cs.W, cs.H, "v210", True), (cs.UHD_W, cs.UHD_H, "v210", True),
                                 (cs.W, cs.H, "yuv422p10le", False)):
        bspec, bparams = cs.multibox_spec_params(torch, dev, rng, w, h, fmt, emit_rgba)
        bprog = make_channel_program(bspec)
        cs.media_animate(torch, bparams, dev, 0.5)
        profile(torch, f"multibox into {fmt}{' emit_rgba' if emit_rgba else ''}, {w}x{h}", lambda: bprog(bparams),
                20, card)
    yspec, yparams = cs.progressive_spec_params(torch, dev, rng, cs.W, cs.H)
    yprog = make_channel_program(yspec._replace(out_format="yuv422p10le"))
    cs.progressive_animate(torch, yparams, dev, 0.5)
    profile(torch, f"progressive 4-layer frame into yuv422p10le, {cs.W}x{cs.H}", lambda: yprog(yparams), 20, card)
    kspec, kparams = cs.keyed_straggler_spec_params(torch, dev, rng, cs.W, cs.H)
    kprog = make_channel_program(kspec)
    cs.keyed_straggler_animate(torch, kparams, dev, 0.5)
    profile(torch, f"keyed graphic over two boxes and a rotation, emit_rgba, {cs.W}x{cs.H}", lambda: kprog(kparams),
            20, card)
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.graph.pipeline import make_pack_program, make_unpack_program
    from phaneron_tpu_torch.ops.formats import v210

    fill = [to_tensor(v210.fill_buf(cs.W, cs.H)[0], dev)]
    unpack_stage = make_unpack_program("v210", cs.W, cs.H, "709", "709")
    pack_stage = make_pack_program("v210", cs.W, cs.H, "709")
    profile(torch, f"v210 unpack and pack stage programs, {cs.W}x{cs.H}", lambda: pack_stage(unpack_stage(fill)),
            50, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
