"""Channel: the per-output frame engine (counterpart of
phaneron_tpu/runtime/channel.py).

Parity with the reference Channel + Combiner pair (src/channel.ts,
src/combiner.ts): owns a sorted map of layers, assembles the bottom-to-
top composite each tick, assigns monotonic channel timestamps
(combiner.ts:211), pads empty channels with black/silence
(blackSilence.ts), fans output out to consumers and ROUTE taps
(combiner.ts:339-359), and routes AMCP load/play/mixer commands.

Every tick builds the structural ChannelSpec from live layer state and
runs the port's frame program for it (``make_channel_program``, cached
per structure): its hand-written CUDA kernels on a CUDA device, their
plain versions on the CPU.  A channel runs on ``cuda:0`` unless it is
given another device (``device="cpu"`` runs it in plain PyTorch, as the
tests do); without a CUDA device it raises instead of falling back to
the CPU.  ``plain=True`` runs every program's plain version on the
channel's device: the reference the kernel path is checked against on
the card.

``sp_devices`` (more than one) makes a row-sharded channel: its frame
program runs band by band over that device group
(parallel/bands.py ``make_sp_channel_program``), its params sharded over
the group's mesh each tick (``_pin``), its interlaced sources on the
in-program yadif ring (runtime/layer.py), and its planes gathered onto
the group's first device, where its producers upload and its consumers
read.  A ROUTE tap of it gets its frame as the bands left it, which a
row-sharded channel reshards band to band and any other gathers.  The first frame of a structure is prepared
(``program.prepare``) and run on a worker thread; later frames of it
run inline and never make the host wait for the card.  On the card a
single-device kernel channel's first frame of a structure also captures
it, on that worker thread, and its later frames replay the structure's
CUDA graph where the structure allows (graph/replay.py).
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import numpy as np
import torch

from ..audio.engine import amix, silence
from ..config import VideoFormat
from ..consumer.consumer import ChannelFrame, Consumer
from ..graph.pipeline import ChannelSpec, LayerSpec, make_channel_program, make_pack_program
from ..graph.replay import capture_lock, graphs
from ..graph.warmup import prewarm
from ..ops.composite import transparent
from ..parallel.bands import check_sp, make_sp_channel_program
from ..parallel.mesh import Sharded, make_sp_mesh, shard_params_sp
from ..producer.producer import LoadParams, ProducerRegistry
from ..runtime.clock import FrameClock
from ..runtime.frame import RGBA_F32, AudioFrame, VideoFrame
from ..runtime.layer import Layer, opaque_format
from ..runtime.mixer import Mixer
from ..runtime.stream import END, Stream, from_generator
from ..runtime.types import TransitionSpec
from ..utils.metrics import tracer

__all__ = ["Channel"]


def _channel_device(device=None) -> torch.device:
    """The device a channel runs on: ``device`` (a CUDA device without an
    index is the current one), or ``cuda:0`` when none is given.  Raises
    when CUDA is asked for and not available: no CPU fallback."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Channel: no CUDA device; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Tap:
    """A ROUTE subscriber: bounded queues, latest-wins on overflow so a
    slow route can never stall the channel."""

    def __init__(self, maxsize: int = 4):
        self.video: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.audio: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.active = True

    def push(self, vframe, aframe) -> None:
        for q, item in ((self.video, vframe), (self.audio, aframe)):
            if q.full():
                try:
                    q.get_nowait()  # drop oldest
                except asyncio.QueueEmpty:
                    pass
            q.put_nowait(item)

    def streams(self) -> tuple[Stream, Stream]:
        def make(q):
            async def gen():
                while self.active:
                    item = await q.get()
                    yield item
                    if item is END:
                        return

            return from_generator(gen)

        return make(self.video), make(self.audio)


class Channel:
    def __init__(
        self,
        chan_id: int,
        fmt: VideoFormat,
        producer_registry: ProducerRegistry,
        out_format: str = "v210",
        col_spec: str = "709",
        gamma_mode: str = "analytic",
        device=None,
        plain: bool = False,
        sp_devices=None,
    ):
        # scanline (sp) sharding over a device group: every frame program
        # runs band by band over it (a group may name one device more than once)
        self._sp_mesh = None
        if sp_devices is not None and len(sp_devices) > 1:
            check_sp(fmt.height, len(sp_devices))
            self._sp_mesh = make_sp_mesh([_channel_device(d) for d in sp_devices])
            device = self._sp_mesh.flat[0]
        self._sp_programs: dict = {}  # spec -> its row-sharded program
        self.chan_id = chan_id
        self.fmt = fmt
        self.producer_registry = producer_registry
        self.out_format = out_format
        self.col_spec = col_spec
        self.gamma_mode = gamma_mode
        self.device = _channel_device(device)
        self.plain = plain
        # warm ticks go through graph/replay.py: kernel channels on one card
        self._replays = self.device.type == "cuda" and not plain and self._sp_mesh is None
        self._cold = False  # inside _dispatch_cold: the frame runs eager, then captures
        self.layers: dict[int, Layer] = {}
        self.consumers: list[Consumer] = []
        self.clock = FrameClock(fmt.timescale, fmt.duration)
        self.taps: list[_Tap] = []
        self.layer_taps: dict[int, list[_Tap]] = {}
        self.running = False
        self.timestamp = 0
        self._task: Optional[asyncio.Task] = None
        self._prewarms: set[asyncio.Task] = set()  # held until done (the loop keeps weak refs)
        # structural specs that have dispatched at least once: warm specs
        # dispatch inline; only first-seen structures hop to a thread
        self._warm_specs: set = set()
        self._last_layer_specs: dict[int, Any] = {}

    # ----------------------------------------------------------- layers

    # producer crash -> bounded reload attempts (on top of the
    # reference's degrade-to-black)
    MAX_SOURCE_RESTARTS = 3

    def layer(self, num: int) -> Layer:
        if num not in self.layers:
            lay = Layer(self.fmt, self.col_spec, self.gamma_mode, self.device, self.plain,
                        ring=self._sp_mesh is not None)
            lay.on_end(lambda _l, n=num: self._maybe_restart(n))
            self.layers[num] = lay
        return self.layers[num]

    def _maybe_restart(self, num: int) -> None:
        """On source END caused by a producer failure (not natural end),
        schedule a reload of the same LoadParams with backoff."""
        lay = self.layers.get(num)
        slot = lay.cur if lay else None
        if slot is None or not getattr(slot, "failed", False):
            return
        params = getattr(lay, "_restart_params", None)
        count = getattr(lay, "_restart_count", 0)
        if params is None or count >= self.MAX_SOURCE_RESTARTS:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        loop.create_task(self._restart_layer(num, params, count))

    async def _restart_layer(self, num: int, params, count: int) -> None:
        await asyncio.sleep(0.2 * (count + 1))
        lay = self.layers.get(num)
        if lay is None or getattr(lay, "_restart_params", None) is not params:
            # the operator loaded something else while we backed off:
            # this retry chain is stale — never stomp the new source
            return
        print(
            f"channel {self.chan_id}: restarting failed source on layer {num} "
            f"(attempt {count + 1}/{self.MAX_SOURCE_RESTARTS})"
        )
        try:
            ok = await self.load_source(num, params)
        except Exception as err:
            print(f"channel {self.chan_id}: restart load failed: {err}")
            ok = False
        lay._restart_count = count + 1  # load_source reset it; keep the tally
        if ok:
            self.play(num)
        elif count + 1 < self.MAX_SOURCE_RESTARTS:
            # the source is still down (load itself failed): keep the
            # retry chain going — a failed load never produces the END
            # event that normally triggers the next attempt
            asyncio.get_running_loop().create_task(
                self._restart_layer(num, params, count + 1)
            )

    async def load_source(
        self,
        layer_num: int,
        params: LoadParams,
        preview: bool = False,
        auto_play: bool = False,
        transition: Optional[TransitionSpec] = None,
    ) -> bool:
        """LOADBG/LOAD (channel.ts:128-209): create producer + mixer
        (+ wipe-mask producer) and bind to the layer."""
        source_id = f"{self.chan_id}-{layer_num}"
        producer = await self.producer_registry.create_source(
            source_id, params, self.fmt, self.device
        )
        if producer is None:
            return False
        mixer = Mixer(self.fmt.width, self.fmt.height)

        mask_producer = None
        mask_mixer = None
        if transition is not None and transition.type == "wipe" and transition.mask_url:
            mask_producer = await self.producer_registry.create_source(
                f"{source_id}-mask", LoadParams(transition.mask_url, loop=True), self.fmt,
                self.device,
            )
            if mask_producer is not None:
                mask_mixer = Mixer(self.fmt.width, self.fmt.height)

        self.layer(layer_num).load(
            producer,
            mixer,
            preview=preview,
            auto_play=auto_play,
            transition=transition,
            mask_producer=mask_producer,
            mask_mixer=mask_mixer,
        )
        lay = self.layer(layer_num)
        lay._restart_params = params
        lay._restart_count = 0
        self._prewarm_for(layer_num, producer, transition)
        return True

    def _spec(self, layers: tuple, emit_rgba: Optional[bool] = None) -> ChannelSpec:
        return ChannelSpec(
            self.fmt.width, self.fmt.height, self.out_format, layers,
            self.col_spec, self.col_spec, self.gamma_mode,
            emit_rgba=self._needs_rgba() if emit_rgba is None else emit_rgba,
        )

    def _prewarm(self, spec: ChannelSpec) -> None:
        """Prewarm a structure on a worker thread; a no-op without a
        running loop (synchronous callers prepare at the first frame)."""
        try:
            task = asyncio.get_running_loop().create_task(prewarm(spec, self.device, self.plain))
        except RuntimeError:
            return
        self._prewarms.add(task)
        task.add_done_callback(self._prewarms.discard)

    async def wait_prewarmed(self) -> None:
        """Wait for the prewarms started so far (a paced run started after
        it begins with its structures prepared)."""
        await asyncio.gather(*list(self._prewarms))

    def _prewarm_for(self, layer_num: int, producer, transition) -> None:
        """Prepare the frame programs PLAY will need (the reference
        compiles kernels during loadSource).  An interlaced wire source
        contributes the progressive fields of its slot's pair
        deinterlace (runtime/layer.py)."""
        deint = producer.fmt.interlaced and producer.pix_format != RGBA_F32
        fmt = RGBA_F32 if deint else producer.pix_format
        # src_opaque from the WIRE format, as layer_spec_fields sets it
        base = LayerSpec(src_format=fmt, deinterlace=deint and self._sp_mesh is not None,
                         src_opaque=deint and opaque_format(producer.pix_format))
        predicted = [base, base._replace(has_transform=True)]
        if transition is not None and transition.type in ("dissolve", "wipe"):
            predicted.append(base._replace(
                transition=transition.type,
                src_b_format=fmt,
                mask_format="v210" if transition.type == "wipe" else None,
            ))
        others = tuple(
            s for num, s in (self._last_layer_specs or {}).items() if num != layer_num
        )
        for lspec in predicted:
            self._prewarm(self._spec(others + (lspec,)))

    def play(self, layer_num: int) -> bool:
        if layer_num not in self.layers:
            return False
        self.layers[layer_num].play()
        return True

    def pause(self, layer_num: int) -> bool:
        if layer_num not in self.layers:
            return False
        self.layers[layer_num].pause()
        return True

    def resume(self, layer_num: int) -> bool:
        if layer_num not in self.layers:
            return False
        self.layers[layer_num].resume()
        return True

    def stop(self, layer_num: int) -> bool:
        if layer_num not in self.layers:
            return False
        self.layers[layer_num].stop()
        return True

    def clear(self, layer_num: Optional[int] = None) -> bool:
        """CLEAR layer or whole channel (channel.ts:242-264)."""
        if layer_num is None:
            for l in self.layers.values():
                l.clear()
            self.layers.clear()
            return True
        if layer_num not in self.layers:
            return False
        self.layers.pop(layer_num).clear()
        return True

    # -------------------------------------------------------- consumers

    async def add_consumer(self, consumer: Consumer) -> None:
        consumer.device = self.device  # where its frames will live
        await consumer.initialise(self.fmt)
        self.consumers.append(consumer)

    def remove_consumer(self, index: int) -> bool:
        for i, c in enumerate(self.consumers):
            if c.index == index:
                c.release()
                del self.consumers[i]
                return True
        return False

    # ------------------------------------------------------ ROUTE pipes

    def route_pipes(self, layer: Optional[int] = None):
        """getRoutePipes (channel.ts:290-300): whole-channel taps get the
        combiner RGBA output; layer taps get that layer's source frames."""
        tap = _Tap()
        if layer is None:
            # attaching a tap flips this channel's program to emit_rgba:
            # prepare that variant so the switch doesn't stall frames
            if self._last_layer_specs:
                self._prewarm(self._spec(
                    tuple(self._last_layer_specs[n] for n in sorted(self._last_layer_specs)),
                    emit_rgba=True,
                ))
            self.taps.append(tap)
            video, audio = tap.streams()
            return video, audio, RGBA_F32
        self.layer_taps.setdefault(layer, []).append(tap)
        video, audio = tap.streams()
        lay = self.layers.get(layer)
        fmt = "v210"
        if lay is not None and lay.cur is not None:
            fmt = lay.cur.layer_spec_fields()["src_format"]
        return video, audio, fmt

    # ------------------------------------------------------- frame loop

    def _needs_rgba(self) -> bool:
        if self.taps:
            return True
        return any(
            c.pix_format is None or c.pix_format != self.out_format or c.needs_rgba
            for c in self.consumers
        )

    def _pin(self, contribs):
        """Move contribution tensors to this channel's device: a no-op for
        tensors already there; a ROUTE frame from a channel on another
        device is copied without a host wait, one a row-sharded channel
        left in bands gathered.  A row-sharded channel shards them over
        its mesh instead (``shard_params_sp``): a ROUTE frame left in
        bands by another mesh is resharded band to band."""
        if self._sp_mesh is not None:
            for c in contribs:
                c.params = shard_params_sp(c.params, self._sp_mesh)
            return contribs

        def put(x):
            if isinstance(x, Sharded):
                return x.gather(self.device)
            if isinstance(x, torch.Tensor):
                return x if x.device == self.device else x.to(self.device, non_blocking=True)
            if isinstance(x, (list, tuple)):
                return type(x)(put(v) for v in x)
            return x

        for c in contribs:
            c.params = {k: put(v) for k, v in c.params.items()}
        return contribs

    def _sp_program(self, spec: ChannelSpec):
        prog = self._sp_programs.get(spec)
        if prog is None:
            prog = self._sp_programs[spec] = make_sp_channel_program(spec, self._sp_mesh, self.plain)
            tracer.count("program.structures")
        return prog

    def _dispatch(self, spec: ChannelSpec, contribs):
        """Run the frame program: (packed planes, rgba frame or None).  An
        empty channel packs a transparent frame (the frame program of no
        layers: black, alpha 0).  A row-sharded channel runs its bands.  A
        kernel channel on the card goes through ``graph/replay.py``
        ``graphs``: the structure's first frame (``_dispatch_cold``) runs
        eager and then captures the structure; a warm one runs its CUDA
        graph, rebound to the tick's planes, where the structure allows.
        A warm structure whose capture was dropped (``MAX_GRAPHS``) runs
        eager once and goes cold again, to be captured anew."""
        if self._sp_mesh is not None:
            out = self._sp_program(spec)({"layers": [c.params for c in self._pin(contribs)]})
            return (out["packed"], out["rgba"]) if isinstance(out, dict) else (out, None)
        if not spec.layers:
            rgba = transparent(self.fmt.height, self.fmt.width, self.device)
            pack = make_pack_program(self.out_format, self.fmt.width, self.fmt.height,
                                     self.col_spec, self.gamma_mode, self.plain)
            return pack(rgba), (rgba if spec.emit_rgba else None)
        params = {"layers": [c.params for c in self._pin(contribs)]}
        program = make_channel_program(spec, plain=self.plain)
        if not self._replays:
            out = program(params)
        elif self._cold:
            out = program(params)
            graphs.capture(spec, program, params, self.device, out)
        else:
            if not graphs.holds(spec, self.device):
                self._warm_specs.discard(spec)
            out = graphs.run(spec, program, params, self.device)
        if isinstance(out, dict):
            return out["packed"], out["rgba"]
        return out, None

    def _dispatch_cold(self, spec: ChannelSpec, contribs):
        """A structure's first frame, on a worker thread: its one-time
        device work first, so that later frames hold no host wait, and the
        structure's CUDA graph capture after it.  It holds ``capture_lock``
        while it launches: no other thread's capture runs meanwhile."""
        tracer.count("channel.cold_dispatches")
        with tracer.span("channel.dispatch_cold", self.chan_id), capture_lock:
            if self._sp_mesh is not None:
                self._sp_program(spec).prepare()
            elif spec.layers:
                make_channel_program(spec, plain=self.plain).prepare(self.device)
            self._cold = True
            try:
                return self._dispatch(spec, contribs)
            finally:
                self._cold = False

    async def render_frame(self) -> ChannelFrame:
        """Assemble and dispatch one channel frame (the per-tick hot path)."""
        with tracer.span("channel.tick", self.chan_id):
            return await self._render_frame()

    async def _render_frame(self) -> ChannelFrame:
        contribs = []
        contrib_layers = []
        for num in sorted(self.layers):
            lay = self.layers[num]
            if not lay.visible:
                continue
            c = await lay.poll()
            if c is not None:
                contribs.append(c)
                contrib_layers.append(num)

        spec = self._spec(tuple(c.spec for c in contribs))
        # A structure's first frame prepares its tables (a host wait each)
        # and captures its CUDA graph on a worker thread, so it stalls only
        # this channel, never the event loop.  Once a spec has dispatched it
        # is warm: its frames enqueue their kernels (or one replay) and
        # return, so warm ticks run inline.
        if spec in self._warm_specs:
            with tracer.span("channel.dispatch", self.chan_id):
                packed, rgba = self._dispatch(spec, contribs)
        else:
            packed, rgba = await asyncio.to_thread(self._dispatch_cold, spec, contribs)
            self._warm_specs.add(spec)

        with tracer.span("channel.amix", self.chan_id):
            audio = (
                amix([c.audio for c in contribs])
                if contribs
                else silence(self.fmt.audio_channels, self.fmt.samples_per_frame)
            )

        self._last_layer_specs = dict(zip(contrib_layers, (c.spec for c in contribs)))
        stamps = [c.loadstamp for c in contribs if c.loadstamp is not None]
        frame = ChannelFrame(
            timestamp=self.timestamp,
            packed=packed,
            rgba=rgba,
            audio=audio,
            width=self.fmt.width,
            height=self.fmt.height,
            packed_format=self.out_format,
            loadstamp=min(stamps) if stamps else None,
        )

        # ROUTE taps: the frame's tensors are shared, not copied (no one
        # writes into them, consumer/consumer.py); a row-sharded channel's
        # frame as its bands left it
        if self.taps and rgba is not None:
            banded = self._sp_program(spec).last_rgba if self._sp_mesh is not None else None
            vf = VideoFrame(
                timestamp=self.timestamp,
                format=RGBA_F32,
                payload=rgba if banded is None else banded,
                width=self.fmt.width,
                height=self.fmt.height,
            )
            af = AudioFrame(timestamp=self.timestamp, samples=audio)
            for tap in self.taps:
                tap.push(vf, af)
        for num, taps in self.layer_taps.items():
            idx = contrib_layers.index(num) if num in contrib_layers else -1
            if idx < 0:
                continue
            c = contribs[idx]
            payload = c.params.get("src")
            if payload is None:
                continue
            vf = VideoFrame(
                timestamp=self.timestamp,
                format=c.spec.src_format,
                payload=payload,
                width=self.fmt.width,
                height=self.fmt.height,
            )
            af = AudioFrame(timestamp=self.timestamp, samples=c.audio)
            for tap in taps:
                tap.push(vf, af)

        self.timestamp += 1
        return frame

    async def deliver(self, frame: ChannelFrame) -> list:
        """Hand ``frame`` to every consumer at once, each under a
        ``consumer.deliver`` span: their results, with the exception in
        place of the result of a consumer that raised."""

        async def one(consumer: Consumer) -> None:
            with tracer.span("consumer.deliver", self.chan_id):
                await consumer.deliver(frame)

        return await asyncio.gather(*(one(c) for c in self.consumers), return_exceptions=True)

    async def run(self) -> None:
        self.running = True
        self.clock.reset()
        frame_num = 0
        while self.running:
            await self.clock.wait(frame_num)
            try:
                frame = await self.render_frame()
                for r in await self.deliver(frame):
                    if isinstance(r, Exception):
                        print(f"channel {self.chan_id}: consumer error: {r}")
            except asyncio.CancelledError:
                raise
            except Exception as err:
                # one bad frame must not take the channel down
                # (the reference catches per-channel, index.ts:156-170)
                print(f"channel {self.chan_id}: frame {frame_num} error: {err}")
            frame_num += 1

    def start(self) -> None:
        if self._task is None or self._task.done():
            # prepare the empty-channel (black/silence) program so the
            # pacing loop starts clean
            self._prewarm(self._spec(()))
            self._task = asyncio.create_task(self.run())

    async def shutdown(self) -> None:
        self.running = False
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self.clear(None)
        for c in self.consumers:
            c.release()
        self.consumers.clear()

    # --------------------------------------------------------- metrics

    def stats(self) -> dict[str, Any]:
        """The channel's figures for INFO.  Render p50 / p99 are host ms of
        its recent ``channel.tick`` spans, 0 while the tracer has none
        (it is off; the server starts it)."""
        ticks = tracer.durations("channel.tick", self.chan_id) or [0.0]
        return {
            "channel": self.chan_id,
            "format": self.fmt.name,
            "frames": self.timestamp,
            "late_frames": self.clock.late_frames,
            "render_p50_ms": float(np.percentile(ticks, 50) * 1e3),
            "render_p99_ms": float(np.percentile(ticks, 99) * 1e3),
            "layers": sorted(self.layers),
            "consumers": len(self.consumers),
            # per-consumer real-time drop counters (latest-wins /
            # drop-mode consumers shed load instead of stalling)
            "consumer_dropped": [
                int(getattr(c, "dropped", 0)) for c in self.consumers
            ],
        }
