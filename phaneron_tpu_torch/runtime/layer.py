"""Layer: foreground/background source slots, transitions, lifecycle
(counterpart of phaneron_tpu/runtime/layer.py).

Parity with the reference Layer + Transitioner pair (src/layer.ts,
src/transitioner.ts): a current and a next source spec, LOADBG/PLAY
promotion, cut/dissolve/wipe transitions with frame-counted progress
(mix = 1 - k/len, transitioner.ts:170), AUTO-play chaining and
'end'/'transitionComplete' events (layer.ts:128-162).

Instead of per-stage kernel valves, a Layer contributes a
(LayerSpec, params, audio) triple per channel tick; the channel runs
all layers through one frame program.  Cadence adaptation (25 fps
sources on a 50 Hz channel, field-rate doubling for interlaced sources)
happens here (ffmpegProducer.ts:557-566, yadif.ts:115-145).

An interlaced wire source deinterlaces in its slot: one yadif pair launch
(``make_yadif_pair_field_program``) gives both field ticks of a frame
period, and the channel program sees progressive ``rgba_f32`` fields.
The port's pair kernel covers every geometry, so every interlaced wire
source of a channel on one device takes this route (the JAX package
gates it on VMEM).  A row-sharded channel's slots (``ring=True``) keep
the in-program ring, as the JAX package's do: each tick hands the
channel program the 3-frame ring as ``src_ring`` with its field
``parity``, and the program's yadif ring runs band by band.

Per tick the slot hands the channel device tensors only: the matrices
from ``Mixer.matrix_on`` (uploaded once a change from pinned memory) and
the dissolve's mix made on the device by ``torch.full``, so a warm tick
makes the host wait for nothing.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..audio.engine import LinearResampler, Rechunker, adapt_channels, crossfade, silence
from ..config import VideoFormat
from ..graph.pipeline import LayerSpec, make_unpack_program, make_yadif_pair_field_program
from ..ops.formats import get_format
from ..runtime.frame import RGBA_F32, VideoFrame
from ..runtime.mixer import Mixer
from ..runtime.stream import END
from ..utils.metrics import tracer
from .types import LayerContribution, TransitionSpec

__all__ = ["Layer", "SourceSlot", "TransitionSpec", "opaque_format"]


def opaque_format(fmt: str) -> bool:
    """An opaque wire format (alpha == the constant 1): its frames ring
    and deinterlace as alpha-free (3, H, W) frames."""
    try:
        return not get_format(fmt).INFO.is_rgb
    except KeyError:
        return False


class SourceSlot:
    """One bound producer + mixer with pull cadence and the 3-frame ring
    its pair deinterlace reads."""

    def __init__(
        self,
        producer,
        mixer: Mixer,
        channel_fmt: VideoFormat,
        col_spec: str = "709",
        gamma_mode: str = "analytic",
        device: torch.device | str = "cuda",
        plain: bool = False,
        ring: bool = False,
    ):
        self.producer = producer
        self.mixer = mixer
        self.keep_ring = ring  # a row-sharded channel's: hand the ring, not the pair's fields
        self._parities: Optional[tuple] = None  # 0-d int32 parity 0 and 1 on the device
        self.channel_fmt = channel_fmt
        self.col_spec = col_spec
        self.gamma_mode = gamma_mode
        self.device = torch.device(device)
        self.plain = plain
        self._pair_fields = None  # (first, second) in emission order
        self.video = producer.video_stream()
        self.audio = producer.audio_stream()
        self.rechunker = Rechunker(
            channel_fmt.audio_channels, channel_fmt.samples_per_frame
        )
        self.audio_chunks: deque = deque()
        self.audio_ended = False
        self._resampler = None  # created on first off-rate audio chunk
        self.last: Optional[VideoFrame] = None
        self.ended = False
        self.failed = False  # ended via producer error, not natural END
        self.paused = True
        self.frames_seen = 0
        self.ticks = 0
        # interlaced sources double to field rate through the pair deinterlace
        self.ring: deque = deque(maxlen=3)
        self._unpack = None

    @property
    def interlaced(self) -> bool:
        return self.last.interlaced if self.last else self.producer.fmt.interlaced

    def _pull_ratio(self) -> int:
        """Channel ticks per source frame."""
        src_fps = self.producer.fmt.fps / self.producer.fmt.fields
        ratio = self.channel_fmt.fps / max(src_fps, 1e-9)
        return max(1, round(ratio))

    async def _pull_video(self) -> None:
        try:
            frame = await self.video.next()
        except Exception as err:
            # producer failure degrades to source-end, never up the
            # frame loop (the reference's per-source degradation)
            print(f"source {self.producer.source_id} failed: {err}")
            self.failed = True
            self.ended = True
            return
        if frame is END:
            self.ended = True
            return
        self.last = frame
        self.frames_seen += 1
        if frame.interlaced:
            if self._unpack is None and frame.format != RGBA_F32:
                # opaque wire formats ring as alpha-free (3, H, W) frames:
                # yadif, the warp and the unpack each drop 1/4 of their
                # traffic (pipeline._process_layer_rgb3)
                self._unpack = make_unpack_program(
                    frame.format,
                    frame.width,
                    frame.height,
                    self.col_spec,
                    self.col_spec,
                    self.gamma_mode,
                    channels=3 if opaque_format(frame.format) else 4,
                    plain=self.plain,
                )
            rgba = frame.payload if frame.format == RGBA_F32 else self._unpack(frame.payload)
            self.ring.append(rgba)
            self._pair_fields = None  # ring advanced: recompute the pair

    async def tick(self) -> Optional[dict]:
        """Advance one channel tick; return graph params for this source
        (or None when not yet ready)."""
        with tracer.span("slot.video"):
            return await self._tick()

    async def _tick(self) -> Optional[dict]:
        ratio = self._pull_ratio()
        need_pull = (not self.paused) and (self.last is None or self.ticks % ratio == 0)
        if need_pull and not self.ended:
            await self._pull_video()
        tick_in_frame = self.ticks % ratio
        self.ticks += 1

        if self.last is None:
            return None

        if self._deinterlaced():
            if len(self.ring) < 3:
                return None
            is_second = tick_in_frame % 2 == 1
            if self.keep_ring:
                # field parity: the first field (tff) keeps even rows
                # (yadif.ts:104), the second odd; the ring rides as a tuple
                if self._parities is None:
                    self._parities = tuple(torch.full((), p, dtype=torch.int32, device=self.device)
                                           for p in (0, 1))
                parity = (1 if self.last.tff else 0) ^ (0 if is_second else 1)
                return {"src_ring": tuple(self.ring), "parity": self._parities[parity]}
            if self._pair_fields is None:
                prog = make_yadif_pair_field_program(
                    self.last.height,
                    self.last.width,
                    bool(self.last.tff),
                    channels=self.ring[0].shape[-3],
                    plain=self.plain,
                )
                self._pair_fields = prog(*self.ring)
            return {"src": self._pair_fields[1 if is_second else 0]}
        return {"src": self.last.payload}

    def _deinterlaced(self) -> bool:
        """An interlaced wire source: its slot deinterlaces it."""
        return self.interlaced and self.last is not None and self.last.format != RGBA_F32

    def layer_spec_fields(self) -> dict:
        """Static structure this slot contributes to the LayerSpec."""
        fmt = self.last.format if self.last else self.producer.pix_format
        deint = self.interlaced and fmt != RGBA_F32
        src_size = None
        if self.last is not None and (self.last.width, self.last.height) != (
            self.channel_fmt.width,
            self.channel_fmt.height,
        ):
            src_size = (self.last.width, self.last.height)
        # a deinterlaced slot hands the channel progressive fields, or
        # its ring (src_opaque records the 3-channel alpha-free frame shape
        # so prewarm predicts the right structure)
        return {
            "src_format": RGBA_F32 if deint else fmt,
            "deinterlace": deint and self.keep_ring,
            "src_size": src_size,
            "src_opaque": deint and opaque_format(fmt),
        }

    async def audio_tick(self) -> np.ndarray:
        """This tick's audio chunk (silence when paused or starved)."""
        with tracer.span("slot.audio"):
            return await self._audio_tick()

    async def _audio_tick(self) -> np.ndarray:
        while not self.audio_chunks and not self.audio_ended and not self.paused:
            try:
                af = await self.audio.next()
            except Exception:
                self.audio_ended = True
                break
            if af is END:
                self.audio_ended = True
                tail = self.rechunker.flush()
                if tail is not None:
                    self.audio_chunks.append(tail)
                break
            samples = af.samples
            if af.sample_rate != self.channel_fmt.audio_sample_rate:
                # source-rate media: continuous-phase linear resample to
                # the channel rate (mixer.ts srcSampleRate->dstSampleRate)
                if self._resampler is None:
                    self._resampler = LinearResampler(
                        af.sample_rate,
                        self.channel_fmt.audio_sample_rate,
                        samples.shape[0],
                    )
                samples = self._resampler.push(samples)
                if samples.shape[1] == 0:
                    continue
            samples = adapt_channels(samples, self.channel_fmt.audio_channels)
            self.audio_chunks.extend(self.rechunker.push(samples))
        if self.paused or not self.audio_chunks:
            return silence(self.channel_fmt.audio_channels, self.channel_fmt.samples_per_frame)
        return self.mixer.apply_audio(self.audio_chunks.popleft())

    def set_paused(self, paused: bool) -> None:
        self.paused = paused
        self.producer.set_paused(paused)

    def release(self) -> None:
        self.producer.release()
        self.video.stop()
        self.audio.stop()


class Layer:
    """Current/next source slots with transition lifecycle (layer.ts)."""

    def __init__(
        self,
        channel_fmt: VideoFormat,
        col_spec="709",
        gamma_mode="analytic",
        device: torch.device | str = "cuda",
        plain: bool = False,
        ring: bool = False,
    ):
        self.channel_fmt = channel_fmt
        self.ring = ring  # slots keep the in-program yadif ring (a row-sharded channel)
        self.col_spec = col_spec
        self.gamma_mode = gamma_mode
        self.device = torch.device(device)
        self.plain = plain
        self.cur: Optional[SourceSlot] = None
        self.next: Optional[SourceSlot] = None
        self.mask: Optional[SourceSlot] = None
        self.transition: Optional[TransitionSpec] = None
        self.pending_transition: Optional[TransitionSpec] = None
        self.transition_pos = 0
        self.auto_play = False
        self._end_cbs: list[Callable] = []
        self._transition_done = asyncio.Event()

    # ------------------------------------------------------- lifecycle

    def _slot(self, producer, mixer) -> SourceSlot:
        return SourceSlot(
            producer, mixer, self.channel_fmt, self.col_spec, self.gamma_mode,
            device=self.device, plain=self.plain, ring=self.ring,
        )

    def load(
        self,
        producer,
        mixer: Mixer,
        preview: bool = False,
        auto_play: bool = False,
        transition: Optional[TransitionSpec] = None,
        mask_producer=None,
        mask_mixer: Optional[Mixer] = None,
    ) -> None:
        """LOADBG/LOAD (layer.ts:164-205): bind to the background slot;
        with preview, promote immediately but stay paused."""
        slot = self._slot(producer, mixer)
        self.next = slot
        self.auto_play = auto_play
        self.pending_transition = transition
        if mask_producer is not None:
            self.mask = self._slot(mask_producer, mask_mixer or Mixer(1, 1))
        if preview and self.cur is None:
            self.cur = self.next
            self.next = None
            self.cur.set_paused(True)

    def play(self) -> None:
        """PLAY (layer.ts:207-237): promote next -> cur, with transition
        when one was loaded."""
        if self.next is not None:
            tr = self.pending_transition
            if tr is not None and tr.type != "cut" and self.cur is not None:
                self.transition = tr
                self.transition_pos = 0
                self._transition_done.clear()
                self.next.set_paused(False)
                if self.mask:
                    self.mask.set_paused(False)
            else:
                if self.cur:
                    self.cur.release()
                self.cur = self.next
                self.next = None
        if self.cur:
            self.cur.set_paused(False)

    def pause(self) -> None:
        if self.cur:
            self.cur.set_paused(True)

    def resume(self) -> None:
        if self.cur:
            self.cur.set_paused(False)

    def stop(self) -> None:
        """STOP: release the current source, keep the layer (black)."""
        if self.cur:
            self.cur.release()
            self.cur = None

    def clear(self) -> None:
        for slot in (self.cur, self.next, self.mask):
            if slot:
                slot.release()
        self.cur = self.next = self.mask = None
        self.transition = None

    @property
    def visible(self) -> bool:
        return self.cur is not None

    def on_end(self, cb: Callable) -> None:
        self._end_cbs.append(cb)

    async def wait_transition_complete(self) -> None:
        if self.transition is not None:
            await self._transition_done.wait()

    # ----------------------------------------------- MIXER param routing

    def _active_mixer(self) -> Optional[Mixer]:
        slot = self.cur or self.next
        return slot.mixer if slot else None

    def set_anchor(self, x, y):
        m = self._active_mixer()
        return bool(m and m.set_anchor(x, y))

    def set_fill(self, x, y, sx, sy):
        m = self._active_mixer()
        return bool(m and m.set_fill(x, y, sx, sy))

    def set_rotation(self, turns):
        m = self._active_mixer()
        return bool(m and m.set_rotation(turns))

    def set_volume(self, v):
        m = self._active_mixer()
        return bool(m and m.set_volume(v))

    def query(self, name: str):
        m = self._active_mixer()
        if not m:
            return None
        return {
            "anchor": m.anchor,
            "fill": m.fill,
            "rotation": m.rotation,
            "volume": m.volume,
        }.get(name)

    # --------------------------------------------------------- per tick

    def _fire_end(self):
        for cb in self._end_cbs:
            cb(self)

    def _mix(self, mix: float) -> torch.Tensor:
        """The dissolve weight as a 0-d float32 tensor made on the device
        (no host copy)."""
        return torch.full((), mix, dtype=torch.float32, device=self.device)

    async def poll(self) -> Optional[LayerContribution]:
        """One channel tick: returns this layer's graph contribution."""
        with tracer.span("layer.poll"):
            return await self._poll()

    async def _poll(self) -> Optional[LayerContribution]:
        if self.cur is None:
            return None

        # (JAX's mixed dissolve, where one side's geometry misses the pair
        # kernel and both sides take the ring, cannot happen here: a
        # channel's interlaced wire sources all take the pair route, or on
        # a row-sharded channel all keep the ring)
        cur_params = await self.cur.tick()
        cur_fields = self.cur.layer_spec_fields()
        mixer = self.cur.mixer
        has_tf = not mixer.is_identity

        in_transition = self.transition is not None and self.next is not None
        next_params = None
        if in_transition:
            next_params = await self.next.tick()
            if next_params is None:
                # the incoming source hasn't produced a frame: hold the
                # transition and show cur alone this tick.  If it died
                # before ever producing, cancel the transition.
                if self.next.ended:
                    self.next.release()
                    self.next = None
                    self.transition = None
                    self._transition_done.set()
                in_transition = False

        if in_transition:
            tr = self.transition
            self.transition_pos += 1
            k = self.transition_pos
            mix = max(0.0, 1.0 - k / max(tr.length, 1))

            # BOTH sources' mixers shape the transition structure: the
            # incoming source may carry a transform the current one
            # doesn't (and vice versa), and a rotation on either side
            # disqualifies the axis-aligned fast path
            next_mixer = self.next.mixer
            has_tf = has_tf or not next_mixer.is_identity
            both_axis_aligned = mixer.axis_aligned and next_mixer.axis_aligned

            params: dict = {}
            if cur_params:
                params.update(cur_params)
            nf = self.next.layer_spec_fields()
            if "src_ring" in next_params:
                params["src_b_ring"] = next_params["src_ring"]
                params["parity"] = next_params["parity"]
            else:
                params["src_b"] = next_params["src"]

            same_mat = True
            if has_tf:
                params["matrix"] = mixer.matrix_on(self.device)
                params["matrix_b"] = next_mixer.matrix_on(self.device)
                same_mat = bool(np.array_equal(mixer.matrix, next_mixer.matrix))
            # warp_bucket / rot_bucket stay -1: they are the TPU kernels'
            # scale and rotation codes, which no port kernel reads
            spec_kwargs = dict(
                transition=tr.type,
                has_transform=has_tf,
                axis_aligned=both_axis_aligned,
                warp_same_mat=same_mat,
                src_b_format=nf["src_format"],
            )
            if cur_fields.get("src_opaque"):
                # one spec covers both sources: the alpha==1 shortcut
                # only holds when BOTH wire formats are non-RGB
                cur_fields = dict(cur_fields, src_opaque=bool(nf.get("src_opaque")))
            if tr.type == "dissolve":
                params["mix"] = self._mix(mix)
            elif tr.type == "wipe" and self.mask is not None:
                mask_params = await self.mask.tick()
                if mask_params and "src" in mask_params:
                    params["mask"] = mask_params["src"]
                    spec_kwargs["mask_format"] = self.mask.last.format
                else:  # mask not ready: degrade to cut-through of cur
                    spec_kwargs["transition"] = "dissolve"
                    params["mix"] = self._mix(1.0)

            # equal-gain crossfade matching the video mix weights — not
            # the reference's amix/2 (which ducks the whole transition
            # 6 dB); a tone present on both sources stays at unity
            audio = crossfade(
                await self.cur.audio_tick(), await self.next.audio_tick(), mix
            )

            if k >= tr.length or self.cur.ended:
                # promote (layer.ts:138-147)
                self.cur.release()
                if self.mask:
                    self.mask.release()
                    self.mask = None
                self.cur = self.next
                self.next = None
                self.transition = None
                self._transition_done.set()

            if cur_params is None:
                return None
            spec = LayerSpec(**cur_fields, **spec_kwargs)
            stamp = self.cur.last.loadstamp if self.cur and self.cur.last else None
            return LayerContribution(spec, params, audio, stamp)

        # ------- steady state: single source.  END fires on natural end
        # (frames seen) AND on a producer that failed before its first
        # frame — the restart chain must engage either way
        if self.cur.ended and (self.cur.frames_seen > 0 or self.cur.failed) and not getattr(self.cur, "_end_fired", False):
            self.cur._end_fired = True
            self._fire_end()
            if self.auto_play and self.next is not None:
                self.cur.release()
                self.cur = self.next
                self.next = None
                self.cur.set_paused(False)
                cur_params = await self.cur.tick()
                cur_fields = self.cur.layer_spec_fields()
                mixer = self.cur.mixer
                has_tf = not mixer.is_identity

        if cur_params is None:
            return None
        params = dict(cur_params)
        if has_tf:
            params["matrix"] = mixer.matrix_on(self.device)
        spec = LayerSpec(
            **cur_fields,
            has_transform=has_tf,
            axis_aligned=mixer.axis_aligned,
        )
        audio = await self.cur.audio_tick()
        stamp = self.cur.last.loadstamp if self.cur.last else None
        return LayerContribution(spec, params, audio, stamp)
