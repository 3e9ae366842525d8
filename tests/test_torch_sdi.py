"""Port parity for the SDI pair over fake hardware backends, and the
interlaced ingest chain: the JAX package's SDIConsumer / SDICaptureProducer
and the port's on the same inputs and the same virtual-clock schedule.

Counterparts of tests/test_sdi_consumer.py, test_sdi_producer.py and
test_interlace_e2e.py.  Contracts: displayed frames (v210 words) and
audio s32 equal JAX's; display times and late_frames equal JAX's over the
same virtual clock; a captured interlaced sequence comes out of the
channel bit-exact, field markers intact, as JAX's does; the interlaced
raw-file chain writes JAX's bytes."""

import wave

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu import config as jconfig
from phaneron_tpu.consumer.sdi_consumer import SDIConsumer as JSDIConsumer
from phaneron_tpu.producer import producer as jproducer
from phaneron_tpu.producer import sdi_capture as jsdi
from phaneron_tpu.producer import test_pattern as jpattern
from phaneron_tpu.runtime import channel as jchannel
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.consumer.consumer import ChannelFrame
from phaneron_tpu_torch.consumer.sdi_consumer import SDIConsumer
from phaneron_tpu_torch.graph.pipeline import make_pack_program
from phaneron_tpu_torch.ops.formats import get_format
from phaneron_tpu_torch.producer import producer as tproducer
from phaneron_tpu_torch.producer import sdi_capture as tsdi
from phaneron_tpu_torch.producer import test_pattern as tpattern
from phaneron_tpu_torch.runtime import channel as tchannel
from phaneron_tpu_torch.utils.fixtures import interlaced_v210_frame

torch.set_num_threads(1)

FMT_I = ("96i", 2, 96, 64, 96, 50, 1, 48000, 2)
FMT_P = ("96p200", 1, 96, 64, 96, 200, 1, 48000, 2)
N_FRAMES = 6


class FakeBackend:
    """Playout on a VIRTUAL clock (the test owns time): ``wait_until``
    advances it at once, so the pacer's accounting is asserted exactly."""

    def __init__(self):
        self.opened = None
        self.frames = []  # (hw_time, planes as numpy, audio_s32, ts)
        self.closed = False
        self.t = 0.0

    def hardware_time(self) -> float:
        return self.t

    async def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)

    async def open(self, device_index, fmt, keyer=False):
        self.opened = (device_index, fmt.name, keyer)

    async def display_frame(self, planes, audio_s32, ts):
        self.frames.append((self.t, [np.asarray(p) for p in planes], audio_s32, ts))

    def close(self):
        self.closed = True


def _frame(ts, fmt, packed, level=0.0):
    audio = np.full((fmt.audio_channels, fmt.samples_per_frame), level, dtype=np.float32)
    return ChannelFrame(timestamp=ts, packed=packed, rgba=None, audio=audio, width=fmt.width,
                        height=fmt.height, packed_format="v210")


def _both(fmt_fields, params=None):
    """(JAX consumer, its backend, port consumer, its backend) initialised."""
    out = []
    for cls, vf in ((JSDIConsumer, jconfig.VideoFormat), (SDIConsumer, tconfig.VideoFormat)):
        backend = FakeBackend()
        cons = cls({"backend": backend, **(params or {})})
        run(cons.initialise(vf(*fmt_fields)))
        out += [cons, backend]
    return out


def test_requires_backend():
    with pytest.raises(RuntimeError, match="DeckLink"):
        run(SDIConsumer({}).initialise(tconfig.VideoFormat(*FMT_P)))


def test_interlaced_field_pair_packing_and_s32_audio_equal_jax():
    """Two field-rate frames become one displayed frame, paired in the
    packed domain (no RGBA emit): even lines from the first field, odd
    from the second, both fields' audio as s32; the same words and audio
    as JAX's consumer displays."""
    import jax.numpy as jnp

    from phaneron_tpu.consumer.consumer import ChannelFrame as JFrame
    from phaneron_tpu.graph.pipeline import make_pack_program as jpack

    jcons, jback, cons, back = _both(FMT_I, {"device": 2})
    assert back.opened == jback.opened == (2, "96i", False)
    assert not cons.needs_rgba
    h, w = 64, 96
    black = np.zeros((4, h, w), np.float32)
    white = np.ones((4, h, w), np.float32)
    pack, jp = make_pack_program("v210", w, h, "709"), jpack("v210", w, h, "709")
    fmt = tconfig.VideoFormat(*FMT_I)

    async def drive(c, b, to_planes, frame_cls):
        for ts, (rgba, level) in enumerate(((black, 0.25), (white, -0.25))):
            f = _frame(ts, fmt, to_planes(rgba), level)
            await c.deliver(frame_cls(**vars(f)))
            if ts == 0:
                assert b.frames == []  # the first field pends

    run(drive(jcons, jback, lambda x: jp(jnp.asarray(x)), JFrame))
    run(drive(cons, back, lambda x: pack(torch.from_numpy(x)), ChannelFrame))
    assert len(back.frames) == len(jback.frames) == 1
    (_, planes, audio_s32, _), (_, jplanes, jaudio, _) = back.frames[0], jback.frames[0]
    assert planes[0].dtype == np.uint32 and np.array_equal(planes[0], np.asarray(jplanes[0]))
    y, u, v = get_format("v210").unpack_codes([torch.from_numpy(planes[0].view(np.int32))], w, h)
    assert (y[0::2] == 64).all() and (y[1::2] == 940).all() and (u == 512).all() and (v == 512).all()
    assert audio_s32.dtype == np.int32 and np.array_equal(audio_s32, jaudio)
    half = fmt.samples_per_frame * fmt.audio_channels
    assert audio_s32.shape == (2 * half,) and (audio_s32[:half] > 0).all() and (audio_s32[half:] < 0).all()
    cons.release()
    assert back.closed


def _schedule(kind: str):
    """A virtual-clock schedule: [(clock jump before the delivery or None,
    ...)] for each genlock case of tests/test_sdi_consumer.py."""
    if kind == "burst":
        return [None] * 16
    if kind == "late":  # miss two slots outright
        return [None, None, ("add", 4.0)]
    if kind == "half":  # 0.6 of a period late: counted, the origin resyncs
        return [None, None, ("set", 2.6), None]
    return [None, ("set", 1.3), None]  # "jitter": 0.3 late, tolerated


@pytest.mark.parametrize("kind", ["burst", "late", "half", "jitter"])
def test_genlock_pacing_equals_jax(kind):
    """Display times and late_frames of the port's pacer equal JAX's over
    the same virtual-clock schedule (and the JAX tests' own numbers)."""
    jcons, jback, cons, back = _both(FMT_P)
    assert cons.frame_period == pytest.approx(0.005)
    p = cons.frame_period
    fmt = tconfig.VideoFormat(*FMT_P)
    words = np.zeros((64, 64), np.uint32)

    async def drive(c, b, planes):
        for i, jump in enumerate(_schedule(kind)):
            if jump is not None:
                b.t = b.t + jump[1] * p if jump[0] == "add" else jump[1] * p
            await c.deliver(_frame(i, fmt, planes))

    run(drive(jcons, jback, [words]))
    run(drive(cons, back, [torch.from_numpy(words.view(np.int32))]))
    times = [t for t, *_ in back.frames]
    assert times == [t for t, *_ in jback.frames]
    assert cons.late_frames == jcons.late_frames
    assert all(np.array_equal(f[1][0], words) for f in back.frames)
    want = {"burst": [i * p for i in range(16)], "half": [0, p, 2.6 * p, 3.6 * p], "jitter": [0, 1.3 * p, 2 * p]}
    if kind in want:
        assert times == pytest.approx(want[kind], abs=1e-9)
    assert cons.late_frames == {"burst": 0, "late": 1, "half": 1, "jitter": 0}[kind]


# ---------------------------------------------------------------- capture


class FakeCaptureBackend:
    """n interlaced wire frames (utils/fixtures' field markers), each with
    two fields of s32 tone audio, then end-of-input."""

    def __init__(self, n=N_FRAMES, tone=0.25, as_words=False):
        self.opened = None
        self.closed = False
        self.frames = [interlaced_v210_frame(96, 64, k) for k in range(n)]
        self.as_words = as_words
        self._i = 0
        fmt = tconfig.VideoFormat(*FMT_I)
        wave_ = np.full(fmt.samples_per_frame * 2 * fmt.audio_channels, tone, dtype=np.float64)
        self.audio_s32 = (wave_ * 2**31).astype(np.int32)

    async def open(self, device_index, fmt):
        self.opened = (device_index, fmt.name)

    async def capture_frame(self):
        if self._i >= len(self.frames):
            return None
        words = self.frames[self._i]
        self._i += 1
        return (words if self.as_words else words.tobytes()), self.audio_s32, float(self._i)

    def close(self):
        self.closed = True


def teardown_module():
    jsdi.set_capture_backend(None)
    tsdi.set_capture_backend(None)


async def _loop(jax_side: bool, capture, playout):
    """DECKLINK DEVICE 2 -> interlaced channel -> SDI consumer."""
    if jax_side:
        jsdi.set_capture_backend(lambda device, fmt: capture)
        reg = jproducer.ProducerRegistry([jsdi.create_sdi_capture_producer, jpattern.create_test_pattern_producer])
        ch = jchannel.Channel(1, jconfig.VideoFormat(*FMT_I), reg, use_pallas=False)
        cons, lp = JSDIConsumer({"backend": playout, "device": 3}), jproducer.LoadParams
    else:
        tsdi.set_capture_backend(lambda device, fmt: capture)
        reg = tproducer.ProducerRegistry([tsdi.create_sdi_capture_producer, tpattern.create_test_pattern_producer])
        ch = tchannel.Channel(1, tconfig.VideoFormat(*FMT_I), reg, device="cpu")
        cons, lp = SDIConsumer({"backend": playout, "device": 3}), tproducer.LoadParams
    await ch.add_consumer(cons)
    assert await ch.load_source(1, lp("DECKLINK", extra={"device": 2}))
    ch.play(1)
    for _ in range(2 * N_FRAMES + 6):
        await cons.deliver(await ch.render_frame())
    cons.release()
    await ch.shutdown()
    jsdi.set_capture_backend(None)
    tsdi.set_capture_backend(None)
    return cons.late_frames


@pytest.mark.parametrize("as_words", [False, True])
def test_capture_to_playout_loop_equals_jax(as_words):
    """The capture -> yadif -> interlaced pair -> playout loop: displayed
    frames and audio equal JAX's one for one on the same virtual clock;
    from the first content frame they advance bit-exactly through the
    captured sequence, field markers intact, each with both fields' tone."""
    jcap, jplay = FakeCaptureBackend(as_words=as_words), FakeBackend()
    cap, play = FakeCaptureBackend(as_words=as_words), FakeBackend()
    jlate = run(_loop(True, jcap, jplay))
    late = run(_loop(False, cap, play))
    assert cap.opened == (2, "96i") and cap.closed and play.closed
    assert late == jlate == 0
    assert len(play.frames) == len(jplay.frames) >= 3
    for (t, planes, audio, ts), (jt, jplanes, jaudio, jts) in zip(play.frames, jplay.frames):
        assert (t, ts) == (jt, jts)
        assert np.array_equal(planes[0], np.asarray(jplanes[0])) and np.array_equal(audio, jaudio)
    src = [f.reshape(-1) for f in cap.frames]
    match = [next((k for k, s in enumerate(src) if np.array_equal(p[0].reshape(-1), s)), -1)
             for _, p, _, _ in play.frames]
    first = next(j for j, k in enumerate(match) if k >= 0)
    chained = 0
    for j in range(first, len(play.frames)):
        k = match[first] + j - first
        if k >= N_FRAMES - 1:  # the ring's final frame has no 'next'
            break
        assert match[j] == k, f"displayed frame {j}: field pairing slipped"
        audio = play.frames[j][2]
        assert audio.shape == (2 * 960 * 2,) and (audio > 0.2 * 2**31).all()
        chained += 1
    assert chained >= 2
    y, _, _ = get_format("v210").unpack_codes([torch.from_numpy(play.frames[first][1][0].view(np.int32))], 96, 64)
    assert (y[0::2] == 120 + 16 * match[first]).all() and (y[1::2] == 560 + 16 * match[first]).all()


def test_decklink_falls_through_to_bars_without_backend():
    tsdi.set_capture_backend(None)
    reg = tproducer.ProducerRegistry([tsdi.create_sdi_capture_producer, tpattern.create_test_pattern_producer])

    async def main():
        prod = await reg.create_source("1-1", tproducer.LoadParams("DECKLINK"), tconfig.VideoFormat(*FMT_I),
                                       device="cpu")
        prod.release()
        return prod

    assert isinstance(run(main()), tpattern.TestPatternProducer)


def test_factory_rejects_non_decklink_and_declined_device():
    fmt = tconfig.VideoFormat(*FMT_I)
    tsdi.set_capture_backend(lambda device, f: None)
    with pytest.raises(tproducer.InvalidProducerError):
        tsdi.create_sdi_capture_producer("1-1", tproducer.LoadParams("BARS"), fmt)
    with pytest.raises(tproducer.InvalidProducerError):
        tsdi.create_sdi_capture_producer("1-1", tproducer.LoadParams("DECKLINK"), fmt)
    tsdi.set_capture_backend(None)


def test_amcp_device_parse_routes_to_capture():
    """PLAY 1-1 DECKLINK DEVICE 2 parses the device index into
    LoadParams.extra, as JAX's parser does."""
    from phaneron_tpu.control.basic_cmds import _parse_load as jparse
    from phaneron_tpu_torch.control.basic_cmds import _parse_load

    lp, _ = _parse_load(["DECKLINK", "DEVICE", "2"])
    jlp, _ = jparse(["DECKLINK", "DEVICE", "2"])
    assert lp.url == jlp.url == "DECKLINK" and lp.extra == jlp.extra == {"device": 2}


# ---------------------------------------------------------------- interlaced chain

FMT_E2E = ("e2e_i", 2, 256, 64, 256, 50, 1, 48000, 2)  # a 1080i50 channel's cadence at 256x64


def test_interlaced_ingest_yadif_to_interlaced_output_equals_jax(tmp_path):
    """utils/fixtures' interlaced clip -> raw-file producer -> pair
    deinterlace -> interlaced channel -> interlaced file consumer (+ WAV):
    the port writes JAX's bytes, and from the first content frame the
    output equals the source frames in order, field markers intact, with
    two fields of audio a written frame."""
    from phaneron_tpu.consumer.file_consumer import FileConsumer as JFile
    from phaneron_tpu.producer.raw_file import create_raw_file_producer as jraw
    from phaneron_tpu_torch.consumer.file_consumer import FileConsumer
    from phaneron_tpu_torch.producer.raw_file import create_raw_file_producer
    from phaneron_tpu_torch.utils.fixtures import write_interlaced_v210

    w, h = FMT_E2E[2], FMT_E2E[3]
    path, src = write_interlaced_v210(tmp_path, w, h, N_FRAMES, audio_channels=2)

    async def chain(jax_side, out):
        if jax_side:
            reg = jproducer.ProducerRegistry([jraw])
            ch = jchannel.Channel(1, jconfig.VideoFormat(*FMT_E2E), reg, use_pallas=False)
            cons, lp = JFile, jproducer.LoadParams
        else:
            reg = tproducer.ProducerRegistry([create_raw_file_producer])
            ch = tchannel.Channel(1, tconfig.VideoFormat(*FMT_E2E), reg, device="cpu")
            cons, lp = FileConsumer, tproducer.LoadParams
        out.mkdir()
        cons = cons({"path": str(out / "out.v210"), "audio_path": str(out / "out.wav")})
        await ch.add_consumer(cons)
        assert await ch.load_source(1, lp(str(path)))
        ch.play(1)
        for _ in range(2 * N_FRAMES + 6):
            await cons.deliver(await ch.render_frame())
        cons.release()
        await ch.shutdown()

    run(chain(True, tmp_path / "jax"))
    run(chain(False, tmp_path / "port"))
    for name in ("out.v210", "out.wav", "out.v210.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    fbytes = get_format("v210").num_bytes(w, h)[0]
    data = (tmp_path / "port" / "out.v210").read_bytes()
    n_out = len(data) // fbytes
    assert n_out >= 3
    outs = [np.frombuffer(data, "<u4", count=fbytes // 4, offset=i * fbytes) for i in range(n_out)]
    flat = [f.reshape(-1) for f in src]
    match = [next((k for k, s in enumerate(flat) if np.array_equal(o, s)), -1) for o in outs]
    first = next(j for j, k in enumerate(match) if k >= 0)
    n_chain = 0
    for j in range(first, n_out):
        k = match[first] + j - first
        if k >= N_FRAMES - 1:
            break
        assert match[j] == k, f"output frame {j} != source frame {k}: field pairing slipped"
        n_chain += 1
    assert n_chain >= 3
    y, u, v = get_format("v210").unpack_codes([torch.from_numpy(outs[first].view(np.int32).reshape(h, -1).copy())], w, h)
    assert (y[0::2] == 120 + 16 * match[first]).all() and (y[1::2] == 560 + 16 * match[first]).all()
    assert (u == 512).all() and (v == 512).all()
    with wave.open(str(tmp_path / "port" / "out.wav"), "rb") as wf:
        assert wf.getnframes() == n_out * 2 * 960
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
    assert np.abs(pcm).max() > 6000
