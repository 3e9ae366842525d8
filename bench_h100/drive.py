"""One run of one cell: its channels built as the server builds them,
warmed up, then ticked in a closed loop for the window.

Set-up makes a ``Channel`` (``phaneron_tpu_torch.runtime.channel``) per
channel of the configuration, on the run's device, with the benchmark's
sink as its consumer, and issues the Channel and Layer calls of AMCP
LOAD, PLAY, MIXER FILL and a MIX (LOADBG with a dissolve, then PLAY) for
each layer of the traffic mix.  A MIX runs from its first tick over
``length`` ticks, longer than warm-up and the window take, so every tick
of a run is mid-dissolve and its weight moves each tick.  Warm-up ticks every channel until each structure has
dispatched, then the loop drains and the card is idle.

The window ticks every channel with ``Channel.render_frame()`` on one
asyncio loop and hands each tick to the sink.  The loop is closed: a
channel ticks again as soon as fewer than ``in_flight`` of its ticks are
incomplete on the card.  A tick's latency is from its ``render_frame``
call to its output's completion on the card; the window counts the ticks
completed inside it.

Afterwards the run frees the channels and holds each sampled tick's
packed output against the plain reference (``reference/``), worked out
from the sources, the tick's index, the MIX's length and the MIXER FILL
values alone.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import roofline
from .reference.channel import Layer as RefLayer, Source, channel_frame, code_gap, transform_matrix
from .sink import Waiter, make_sink
from .sources import SourceBank, source_seed
from .spec import Cell
from .trace import ProfiledSlice, Spans, Trace

__all__ = ["run_cell", "Run", "reference_gaps", "control_gaps"]


@dataclasses.dataclass
class Run:
    """What a run measured and kept."""

    cell: Cell
    width: int
    height: int
    setup_s: float = 0.0
    window_s: float = 0.0
    ticks: list = dataclasses.field(default_factory=list)  # the window's ticks, all channels
    failed: int = 0  # ticks whose render_frame raised
    errors: list = dataclasses.field(default_factory=list)
    samples: dict = dataclasses.field(default_factory=dict)  # (channel, tick) -> packed planes
    memory_peak_bytes: int = 0
    setup_phases: dict = dataclasses.field(default_factory=dict)  # phase -> seconds it ended after start
    trace: Optional[Trace] = None


def _fill(layer: dict, li: int, c: int):
    """A layer's MIXER FILL (x, y, sx, sy) on channel c, or None."""
    if layer.get("fill") is None:
        return None
    base = np.asarray(layer["fill"], np.float64)
    step = np.asarray(layer.get("fill_per_layer", [0, 0, 0, 0]), np.float64) * li
    step += np.asarray(layer.get("fill_per_channel", [0, 0, 0, 0]), np.float64) * c
    return tuple(float(v) for v in base + step)


def _size(src: dict, cfg_w: int, cfg_h: int, w: int, h: int) -> tuple:
    """A source's size: its clip's own, scaled with the channel when the
    run's geometry is not the configuration's; the channel's by default."""
    if "size" not in src:
        return w, h
    sw, sh = src["size"]
    return max(2, round(sw * w / cfg_w)), max(2, round(sh * h / cfg_h))


def layer_plan(cell: Cell, width: int, height: int) -> list:
    """Per channel, per layer: {"sources": [(url name, format, w, h,
    graphic kwargs)], "fill": (x, y, sx, sy) or None}."""
    cfg, mix = cell.config, cell.traffic
    plan = []
    for c in range(cfg["channels"]):
        layers = []
        for li, ly in enumerate(mix["layers"]):
            srcs = []
            for slot in ("from", "to"):
                if slot not in ly:
                    continue
                s = ly[slot]
                w, h = _size(s, cfg["width"], cfg["height"], width, height)
                graphic = {k: s[k] for k in ("box", "soft") if k in s}
                srcs.append((f"c{c}l{li}{slot}", s["format"], w, h, graphic))
            layers.append({"sources": srcs, "fill": _fill(ly, li, c)})
        plan.append(layers)
    return plan


def _mix_weight(transition: dict, index: int) -> float:
    """The dissolve weight of the first source at a channel's tick
    ``index``: the layer's transition position is index + 1."""
    return float(np.float32(max(0.0, 1.0 - (index + 1) / max(transition["length"], 1))))


def _matrix(fill, width: int, height: int):
    """The DVE matrix of a MIXER FILL, or None."""
    if fill is None:
        return None
    x, y, sx, sy = fill
    return transform_matrix(width, height, offset_x=x, offset_y=y, scale_x=sx, scale_y=sy)


def reference_layers(cell: Cell, bank: SourceBank, plan_c: list, index: int, width: int, height: int) -> list:
    """The plain reference's layers of channel tick ``index``."""
    out = []
    for ly in plan_c:
        srcs = tuple(Source(fmt, bank.frame(SourceBank.SCHEME + name, index), w, h)
                     for name, fmt, w, h, _ in ly["sources"])
        mix = _mix_weight(cell.traffic["transition"], index) if len(srcs) == 2 else None
        out.append(RefLayer(srcs, _matrix(ly["fill"], width, height), mix))
    return out


def _gaps(run: Run, bank: SourceBank, plan: list, dt) -> list:
    """[(channel, tick, code gap)] of each sampled tick: the program's
    output (``dt`` None) or the reference computed in ``dt`` put in its
    place, against the float32 reference."""
    cfg = run.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frame = lambda layers, d=torch.float32: channel_frame(layers, cfg["out_format"], run.width, run.height,
                                                          cfg["col_spec"], d)
    gaps = []
    for (c, index), planes in sorted(run.samples.items()):
        layers = reference_layers(run.cell, bank, plan[c], index, run.width, run.height)
        with torch.no_grad():
            ref = frame(layers)
            got = planes if dt is None else frame(layers, dt)
        gaps.append((c, index, code_gap(cfg["out_format"], got, ref, run.width)))
    return gaps


def reference_gaps(run: Run, bank: SourceBank, plan: list) -> list:
    """The program's sampled ticks against the reference."""
    return _gaps(run, bank, plan, None)


def control_gaps(run: Run, bank: SourceBank, plan: list, dt=torch.bfloat16) -> list:
    """The control: the reference computed in ``dt`` in the program's place."""
    return _gaps(run, bank, plan, dt)


def stage_plan(cell: Cell, plan: list, width: int, height: int) -> list:
    """Per channel, the stages of one tick (roofline.tick_stages)."""
    return [roofline.tick_stages([{"sources": [(f, w, h) for _, f, w, h, _ in ly["sources"]],
                                   "matrix": _matrix(ly["fill"], width, height)} for ly in layers],
                                 cell.config["out_format"], width, height)
            for layers in plan]


class _Loop:
    """The closed loop over a run's channels."""

    def __init__(self, chans, sinks, slots, in_flight: int):
        self.chans, self.sinks, self.slots = chans, sinks, slots
        self.in_flight = in_flight
        self.failed = 0
        self.errors: list = []

    async def _channel(self, c: int, until: Optional[float], count: Optional[int]) -> None:
        ch, sink, slots = self.chans[c], self.sinks[c], self.slots[c]
        n = 0
        while True:
            await slots.acquire()
            if (count is not None and n >= count) or (until is not None and time.perf_counter() >= until):
                slots.release()
                return
            sink.called[ch.timestamp] = time.perf_counter()
            try:
                frame = await ch.render_frame()
            except Exception as err:  # a tick the program failed: counted, the loop goes on
                self.failed += 1
                self.errors.append(f"channel {c + 1}: {type(err).__name__}: {err}")
                sink.called.pop(ch.timestamp, None)
                slots.release()
                if len(self.errors) > 20:
                    raise
                continue
            await sink.deliver(frame)
            n += 1

    async def run(self, until: Optional[float] = None, count: Optional[int] = None) -> None:
        await asyncio.gather(*(self._channel(c, until, count) for c in range(len(self.chans))))
        for slots in self.slots:  # drain: every tick complete on the card
            for _ in range(self.in_flight):
                await slots.acquire()
            for _ in range(self.in_flight):
                slots.release()


async def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, geometry=None,
                   t_start: Optional[float] = None) -> tuple:
    """One run; returns (Run, SourceBank, plan).  ``geometry`` (w, h)
    replaces the configuration's (the CPU tests' tiny channels)."""
    from phaneron_tpu_torch.config import get_video_format
    from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry
    from phaneron_tpu_torch.runtime.channel import Channel
    from phaneron_tpu_torch.runtime.types import TransitionSpec

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    fmt = get_video_format(cfg["video_format"])
    if (fmt.width, fmt.height) != (cfg["width"], cfg["height"]):
        raise ValueError(f"{cfg['name']}: {cfg['video_format']} is {fmt.width}x{fmt.height}")
    if geometry is not None:
        fmt = dataclasses.replace(fmt, width=geometry[0], height=geometry[1], square_width=geometry[0])
    width, height = fmt.width, fmt.height
    run = Run(cell, width, height)
    plan = layer_plan(cell, width, height)
    run.setup_phases["imports"] = time.perf_counter() - t_start
    bank = SourceBank(mix["source_frames"])
    for c, layers in enumerate(plan):
        for li, ly in enumerate(layers):
            for si, (name, f, w, h, graphic) in enumerate(ly["sources"]):
                bank.add(name, f, w, h, source_seed(seed, c, li, si), device, **graphic)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_phases["sources"] = time.perf_counter() - t_start

    loop = asyncio.get_running_loop()
    waiter = Waiter(loop)
    in_flight = mix["in_flight"]
    chans, sinks, slots = [], [], []
    tr = mix["transition"]
    try:
        for c, layers in enumerate(plan):
            ch = Channel(c + 1, fmt, ProducerRegistry([bank.factory]), out_format=cfg["out_format"],
                         col_spec=cfg["col_spec"], device=device)
            sem = asyncio.Semaphore(in_flight)
            sink = make_sink(cfg["out_format"], c, waiter, sem, mix["sample_ticks"], seed)
            await ch.add_consumer(sink)
            for li, ly in enumerate(layers):
                num = li + 1
                urls = [SourceBank.SCHEME + s[0] for s in ly["sources"]]
                if not await ch.load_source(num, LoadParams(urls[0])) or not ch.play(num):
                    raise RuntimeError(f"LOAD / PLAY {urls[0]} on {c + 1}-{num} failed")
                if ly["fill"] is not None:
                    ch.layer(num).set_fill(*ly["fill"])
                if len(urls) == 2:
                    spec = TransitionSpec(tr["type"], tr["length"])
                    if not await ch.load_source(num, LoadParams(urls[1]), transition=spec):
                        raise RuntimeError(f"LOADBG {urls[1]} MIX on {c + 1}-{num} failed")
                    if ly["fill"] is not None:
                        ch.layer(num).next.mixer.set_fill(*ly["fill"])
                    ch.play(num)
            await ch.wait_prewarmed()
            chans.append(ch)
            sinks.append(sink)
            slots.append(sem)

        run.setup_phases["channels"] = time.perf_counter() - t_start
        lp = _Loop(chans, sinks, slots, in_flight)
        await lp.run(count=mix["warmup_ticks"])  # every structure dispatched, the card warm
        run.setup_phases["warm-up"] = time.perf_counter() - t_start
        spans = Spans() if trace else None
        if trace:
            spans.wrap(chans)
            slice_ = ProfiledSlice(device)
            slice_.warm()
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        for s in sinks:
            s.window = True
            s.ticks.clear()
        e0 = None
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        w0 = time.perf_counter()
        run.setup_s = w0 - t_start
        w1 = w0 + seconds
        tasks = [asyncio.ensure_future(lp.run(until=w1))]
        if trace:
            tasks.append(asyncio.ensure_future(slice_.take(w0, seconds, sinks)))
        await asyncio.gather(*tasks)
        if cuda:
            torch.cuda.synchronize(device)
        run.window_s = seconds
        run.failed, run.errors = lp.failed, lp.errors
        if waiter.error is not None:
            raise waiter.error
        for c, s in enumerate(sinks):
            for t in s.ticks:
                t.done = w0 + e0.elapsed_time(t.event) / 1e3 if t.event is not None else t.delivered
            run.ticks += [t for t in s.ticks if t.done <= w1]
            run.samples.update({(c, k): v for k, v in s.samples.items()})
        if trace:
            run.trace = slice_.result(spans, stage_plan(cell, plan, width, height))
        if cuda:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    finally:
        for ch in chans:
            await ch.shutdown()
        waiter.close()
    return run, bank, plan
