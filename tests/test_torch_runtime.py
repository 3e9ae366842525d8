"""Port parity for the runtime: the same calls go to the JAX package's
``Channel(use_pallas=False)`` and to the port's ``Channel(device="cpu")``,
both fed by their test-pattern producers, and every frame is compared.

Contracts: packed frames within 1 code of JAX (0 expected), audio exactly
equal, the same lifecycle (promotion, end events).  An interlaced source
takes JAX's in-program yadif ring here and the port's slot-side pair
deinterlace; the two are exact against each other
(tests/test_torch_interlace.py).  Also: the port's test patterns equal
JAX's bit for bit, a warm structure dispatches inline, and a channel runs
on CUDA unless it is given the CPU, with no fallback."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu.config import VideoFormat as JVideoFormat
from phaneron_tpu.consumer.consumer import Consumer as JConsumer
from phaneron_tpu.producer import producer as jproducer
from phaneron_tpu.producer import test_pattern as jpattern
from phaneron_tpu.runtime import channel as jchannel
from phaneron_tpu.runtime import types as jtypes
from phaneron_tpu_torch.config import VideoFormat
from phaneron_tpu_torch.consumer.consumer import Consumer
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.producer import producer as tproducer
from phaneron_tpu_torch.producer import test_pattern as tpattern
from phaneron_tpu_torch.runtime import channel as tchannel
from phaneron_tpu_torch.runtime import types as ttypes
from torch_parity import max_code_delta

torch.set_num_threads(1)

TINY = (96, 64)
TINY_I = (256, 64)  # an interlaced 50-field channel
FMT_ARGS = dict(
    tiny=("tiny", 1, 96, 64, 96, 50, 1, 48000, 2),
    tiny25=("tiny25", 1, 96, 64, 96, 25, 1, 48000, 2),  # a 25 fps source
    tiny_i=("tiny_i", 2, 256, 64, 256, 50, 1, 48000, 2),
)
BOXES = [(0.02 + 0.003 * i, 0.0, 0.9, 0.9) for i in range(4)]  # bench.py's interlaced boxes


def _recorder(base):
    """A consumer that pairs the channel's field ticks into interlaced
    frames (Consumer._init_field_pairing) and keeps each pair."""

    class Recorder(base):
        async def initialise(self, fmt):
            await super().initialise(fmt)
            self._init_field_pairing(fmt)
            self.pairs = []

        async def deliver(self, frame):
            out = self._pair_field(frame, frame.timestamp)
            if out is not None:
                self.pairs.append(out[0][0])

    return Recorder


def _package(jax_side: bool):
    if jax_side:
        return SimpleNamespace(
            jax=True, fmt=lambda name: JVideoFormat(*FMT_ARGS[name]),
            channel=lambda fmt, reg: jchannel.Channel(1, fmt, reg, use_pallas=False),
            LoadParams=jproducer.LoadParams, Transition=jtypes.TransitionSpec,
            Registry=jproducer.ProducerRegistry, pattern=jpattern.create_test_pattern_producer,
            Recorder=_recorder(JConsumer), words=lambda t: np.asarray(t),
        )
    return SimpleNamespace(
        jax=False, fmt=lambda name: VideoFormat(*FMT_ARGS[name]),
        channel=lambda fmt, reg: tchannel.Channel(1, fmt, reg, device="cpu"),
        LoadParams=tproducer.LoadParams, Transition=ttypes.TransitionSpec,
        Registry=tproducer.ProducerRegistry, pattern=tpattern.create_test_pattern_producer,
        Recorder=_recorder(Consumer), words=words_to_numpy,
    )


def _registry(ns, source_fmt=None):
    if source_fmt is None:
        return ns.Registry([ns.pattern])
    src = ns.fmt(source_fmt)
    return ns.Registry([lambda sid, params, _fmt: ns.pattern(sid, params, src)])


async def _frames(ns, ch, n: int, rec: list) -> None:
    for _ in range(n):
        f = await ch.render_frame()
        rec.append(("frame", ns.words(f.packed[0]), np.asarray(f.audio)))


# Each scenario drives one channel through a sequence of calls and
# returns its record: ("frame", words, audio) per tick and (name, value)
# lifecycle facts.


async def empty(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    rec = []
    await _frames(ns, ch, 2, rec)
    return rec


async def play_bars(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    assert await ch.load_source(1, ns.LoadParams("BARS"))
    assert ch.play(1)
    rec = []
    await _frames(ns, ch, 4, rec)
    return rec


async def dissolve_promotes(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    assert await ch.load_source(1, ns.LoadParams("BARS"))
    ch.play(1)
    rec = []
    await _frames(ns, ch, 1, rec)
    assert await ch.load_source(1, ns.LoadParams("RAMP"), transition=ns.Transition("dissolve", 4))
    ch.play(1)
    lay = ch.layer(1)
    rec.append(("in transition", lay.transition is not None))
    await _frames(ns, ch, 4, rec)
    rec.append(("promoted", lay.transition is None and lay.next is None))
    await _frames(ns, ch, 2, rec)
    return rec


async def pause(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    assert await ch.load_source(1, ns.LoadParams("RAMP"))
    ch.play(1)
    rec = []
    await _frames(ns, ch, 1, rec)
    ch.pause(1)
    await _frames(ns, ch, 2, rec)
    ch.resume(1)
    await _frames(ns, ch, 2, rec)
    return rec


async def length_limited(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    assert await ch.load_source(1, ns.LoadParams("BARS", length=3))
    ch.play(1)
    ended = []
    ch.layer(1).on_end(lambda _l: ended.append(True))
    rec = []
    await _frames(ns, ch, 6, rec)
    rec.append(("ended", ended))
    return rec


async def cadence_25_on_50(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns, "tiny25"))
    assert await ch.load_source(1, ns.LoadParams("RAMP"))
    ch.play(1)
    rec = []
    await _frames(ns, ch, 8, rec)
    return rec


async def dissolve_audio(ns):
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    assert await ch.load_source(1, ns.LoadParams("BARS"))
    ch.play(1)
    rec = []
    await _frames(ns, ch, 1, rec)
    assert await ch.load_source(1, ns.LoadParams("BARS"), transition=ns.Transition("dissolve", 6))
    ch.play(1)
    await _frames(ns, ch, 6, rec)
    return rec


async def interlaced_dve_dissolve(ns):
    """Four layers, each a dissolve from BARS to RAMP under one MIXER FILL
    box (set on both sources), at field rate; a consumer pairs the field
    ticks into interlaced frames."""
    ch = ns.channel(ns.fmt("tiny_i"), _registry(ns))
    for num, box in enumerate(BOXES):
        assert await ch.load_source(num, ns.LoadParams("BARS"))
        ch.play(num)
        assert ch.layer(num).set_fill(*box)
        assert await ch.load_source(num, ns.LoadParams("RAMP"), transition=ns.Transition("dissolve", 12))
        ch.layer(num).next.mixer.set_fill(*box)
        ch.play(num)
    consumer = ns.Recorder()
    await ch.add_consumer(consumer)
    rec = []
    for _ in range(10):
        f = await ch.render_frame()
        rec.append(("frame", ns.words(f.packed[0]), np.asarray(f.audio)))
        await consumer.deliver(f)
    rec.append(("layer spec", {k: getattr(ch._last_layer_specs[0], k)
                               for k in ("src_format", "transition", "has_transform", "src_opaque")}))
    rec += [("pair", ns.words(p), None) for p in consumer.pairs]
    return rec


async def warm_inline(ns):
    """The first frame of a structure dispatches on a worker thread; its
    warm frames inline, on the event loop's thread."""
    ch = ns.channel(ns.fmt("tiny"), _registry(ns))
    loop_thread = threading.get_ident()
    on_loop = []
    orig = ch._dispatch

    def record(spec, contribs):
        on_loop.append(threading.get_ident() == loop_thread)
        return orig(spec, contribs)

    ch._dispatch = record
    assert await ch.load_source(1, ns.LoadParams("BARS"))
    ch.play(1)
    rec = []
    await _frames(ns, ch, 3, rec)
    assert await ch.load_source(2, ns.LoadParams("RAMP"))
    ch.play(2)
    n = 3
    await _frames(ns, ch, 3, rec)
    assert on_loop == [False, True, True, False, True, True], on_loop
    rec.append(("first dispatches off the loop", (on_loop[0], on_loop[n])))
    return rec


SCENARIOS = [empty, play_bars, dissolve_promotes, pause, length_limited, cadence_25_on_50,
             dissolve_audio, interlaced_dve_dissolve, warm_inline]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_channel_matches_jax(scenario):
    want = run(scenario(_package(jax_side=True)))
    got = run(scenario(_package(jax_side=False)))
    assert [r[0] for r in got] == [r[0] for r in want]
    w, h = TINY_I if scenario is interlaced_dve_dissolve else TINY
    for g, x in zip(got, want):
        if g[0] in ("frame", "pair"):
            assert g[1].shape == x[1].shape and g[1].dtype == x[1].dtype
            assert max_code_delta(g[1], x[1], w, h) <= 1
            if g[2] is not None:
                np.testing.assert_array_equal(g[2], x[2])
        else:
            assert g[1] == x[1], g[0]
    frames = [r[1] for r in got if r[0] == "frame"]
    if scenario is cadence_25_on_50:  # each source frame exactly twice, in order
        for k in range(0, len(frames), 2):
            assert np.array_equal(frames[k], frames[k + 1])
            if k + 2 < len(frames):
                assert not np.array_equal(frames[k], frames[k + 2])
    if scenario is pause:  # paused frames hold; resumed ones move on
        assert np.array_equal(frames[1], frames[2])
        assert not np.array_equal(frames[2], frames[3])
    if scenario is interlaced_dve_dissolve:
        facts = dict(r for r in got if r[0] == "layer spec")
        assert facts["layer spec"] == dict(src_format="rgba_f32", transition="dissolve",
                                           has_transform=True, src_opaque=True)
        assert len([r for r in got if r[0] == "pair"]) == 5


# ------------------------------------------------------- test patterns

PATTERN_FORMATS = ("v210", "yuv422p10le", "yuv422p8", "yuv420p", "nv12", "rgba8", "bgra8")


@pytest.mark.parametrize("pix", PATTERN_FORMATS)
@pytest.mark.parametrize("kind", ("BARS", "RAMP", "BLACK"))
def test_test_pattern_frames_equal_jax(kind, pix):
    """Every phase of a pattern, built on the device by the port's pack
    program, equals JAX's bit for bit (v210: JAX's word planes put back
    into interleaved words)."""
    url = f"{kind}@{pix}"

    async def frames(jax_side):
        ns = _package(jax_side)
        producer = ns.pattern("1-1", ns.LoadParams(url), ns.fmt("tiny"))
        if not jax_side:
            producer.device = torch.device("cpu")
        await producer.initialise()
        return producer._frames

    want, got = run(frames(True)), run(frames(False))
    assert len(got) == len(want) == (1 if kind == "BLACK" else 16)
    for g, x in zip(got, want):
        assert len(g) == len(x)
        for gp, xp in zip(g, x):
            xp = np.asarray(xp)
            if pix == "v210":  # (4, H, G) word planes -> (H, G*4) words
                xp = xp.transpose(1, 2, 0).reshape(xp.shape[1], -1)
                gp = words_to_numpy(gp)
            else:
                gp = gp.numpy()
            assert gp.shape == xp.shape
            np.testing.assert_array_equal(gp, xp.astype(gp.dtype))


def test_registry_gives_producers_the_channel_device():
    async def main():
        reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer])
        p = await reg.create_source("1-1", tproducer.LoadParams("BLACK"), VideoFormat(*FMT_ARGS["tiny"]), "cpu")
        assert p.device == torch.device("cpu") and p._frames[0][0].device.type == "cpu"
        assert await reg.create_source("1-1", tproducer.LoadParams("NOT_A_PATTERN"),
                                       VideoFormat(*FMT_ARGS["tiny"]), "cpu") is None

    run(main())


# -------------------------------------------------------------- device


def test_channel_runs_on_cuda_unless_given_the_cpu():
    """No device: cuda:0, or a RuntimeError where CUDA is missing (never a
    CPU fallback); device='cpu' runs on the CPU; a row-sharded channel
    runs on its device group, the CPU only when the group names it, and
    raises on a CUDA group where CUDA is missing."""
    reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer])
    fmt = VideoFormat(*FMT_ARGS["tiny"])
    if torch.cuda.is_available():
        assert tchannel.Channel(1, fmt, reg).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tchannel.Channel(1, fmt, reg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tchannel.Channel(1, fmt, reg, device="cuda")
    assert tchannel.Channel(1, fmt, reg, device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tchannel.Channel(1, fmt, reg, device="cpu", sp_devices=["cuda:0", "cuda:1"])
    sharded = tchannel.Channel(1, fmt, reg, sp_devices=["cpu", "cpu"])
    assert sharded.device == torch.device("cpu") and sharded._sp_mesh.shape == {"sp": 2}


def test_run_paces_and_delivers_every_tick():
    """Channel.run on the event loop: every rendered tick reaches the
    consumer, and stopping the loop ends it after a whole tick."""

    class Count(Consumer):
        async def deliver(self, frame):
            self.seen = getattr(self, "seen", 0) + 1

    async def main():
        import asyncio

        reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer])
        ch = tchannel.Channel(1, VideoFormat(*FMT_ARGS["tiny"]), reg, device="cpu")
        consumer = Count()
        await ch.add_consumer(consumer)
        assert await ch.load_source(1, tproducer.LoadParams("BARS"))
        ch.play(1)
        ch.start()
        await asyncio.sleep(0.3)
        ch.running = False
        await asyncio.wait_for(ch._task, 5)
        stats = ch.stats()
        assert stats["frames"] == consumer.seen == ch.clock.total_frames >= 5
        await ch.shutdown()

    run(main())
