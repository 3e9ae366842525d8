"""Port parity for the file-media producers and the cluster ingest: AVI
(v210, MJPG), image sequences, WAV beds, the MJPEG HTTP producer and the
synthetic fixtures, each through the JAX package's producer and the
port's on the same seeded inputs, plus the server's registries.

Counterparts of tests/test_avi_producer.py, test_image_seq.py,
test_wav_producer.py and test_cluster.py.  Contracts: producer frames
equal JAX's payloads (v210 words, rgba8 pixels) bit for bit, Pillow
decodes included (the port decodes in the codec process, JAX on a
thread, with the same calls); channel frames 0 codes from JAX's
``Channel(use_pallas=False)``; audio chunks equal; files the port writes
(AVI containers, ``utils/fixtures``) equal JAX's byte for byte; for each
URL kind the server's registry picks the counterpart of the class JAX's
picks."""

import asyncio
import io
import os
import struct
import wave
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu import config as jconfig
from phaneron_tpu.ops.pallas_kernels import planes_to_words
from phaneron_tpu.producer import producer as jproducer
from phaneron_tpu.producer import test_pattern as jpattern
from phaneron_tpu.runtime import channel as jchannel
from phaneron_tpu.utils import avi as javi
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.ops.formats import get_format
from phaneron_tpu_torch.producer import producer as tproducer
from phaneron_tpu_torch.producer import test_pattern as tpattern
from phaneron_tpu_torch.producer.avi_file import AviProducer, create_avi_producer
from phaneron_tpu_torch.producer.image_seq import ImageSeqProducer, create_image_seq_producer
from phaneron_tpu_torch.producer.raw_file import create_raw_file_producer
from phaneron_tpu_torch.producer.wav_file import WavProducer, create_wav_producer
from phaneron_tpu_torch.runtime import channel as tchannel
from phaneron_tpu_torch.runtime.stream import END
from phaneron_tpu_torch.utils.avi import read_avi, write_avi
from torch_parity import max_code_delta

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
FMT = tconfig.get_video_format("1080p5000")
JFMT = jconfig.get_video_format("1080p5000")
TINY = ("tiny", 1, 96, 64, 96, 50, 1, 48000, 2)
CPU = torch.device("cpu")


def _port(cls, *args):
    prod = cls(*args)
    prod.device = CPU
    return prod


async def _drain(prod, limit=64, audio=False):
    """(frames, first audio chunk) of an initialised-here producer."""
    await prod.initialise()
    vs = prod.video_stream()
    got = []
    while len(got) < limit:
        f = await vs.next()
        if f is END or f.__class__.__name__ == "_End":
            break
        got.append(f)
    a0 = await prod.audio_stream().next() if audio else None
    prod.release()
    return got, a0


def _jax_words(frame) -> np.ndarray:
    return np.asarray(planes_to_words(frame.payload[0]))


def _port_words(frame) -> np.ndarray:
    return words_to_numpy(frame.payload[0])


# ---------------------------------------------------------------- AVI


def _v210_frames(w, h, n):
    base = get_format("v210").fill_buf(w, h)[0]
    return [np.roll(base, k * 3, axis=0).tobytes() for k in range(n)]


def _write_fixture(path, w=96, h=16, n=5, with_audio=True, writer=write_avi):
    frames = _v210_frames(w, h, n)
    audio = None
    if with_audio:
        t = np.arange(n * 1920, dtype=np.float32)
        audio = np.stack([np.sin(2 * np.pi * 440 * t / 48000), np.sin(2 * np.pi * 880 * t / 48000)]) * 0.5
    writer(path, frames, "v210", w, h, 25.0, audio=audio)
    return frames, audio


def test_avi_roundtrip_header_and_chunks_equal_jax(tmp_path):
    """The port's write_avi writes JAX's file byte for byte (RIFF size
    exact); read_avi finds the same header, chunks and audio."""
    frames, _ = _write_fixture(tmp_path / "port.avi")
    _write_fixture(tmp_path / "jax.avi", writer=javi.write_avi)
    raw = (tmp_path / "port.avi").read_bytes()
    assert raw == (tmp_path / "jax.avi").read_bytes()
    assert struct.unpack_from("<I", raw, 4)[0] == len(raw) - 8
    info, jinfo = read_avi(tmp_path / "port.avi"), javi.read_avi(tmp_path / "port.avi")
    assert info.video.fourcc == "v210" and (info.video.width, info.video.height) == (96, 16)
    assert info.video.fps == 25.0 and len(info.video.frames) == 5
    assert info.audio.channels == 2 and info.audio.format_tag == 3
    assert info.video.frames == jinfo.video.frames and info.audio.chunks == jinfo.audio.chunks
    for want, (off, size) in zip(frames, info.video.frames):
        assert raw[off : off + size] == want


@pytest.mark.parametrize("name", ["tone_bars.avi", "tone_bars_mjpg.avi"])
def test_committed_fixtures_parse_as_jax(name):
    info, jinfo = read_avi(FIXTURES / name), javi.read_avi(FIXTURES / name)
    assert asdict(info) == asdict(jinfo)
    assert len(info.video.frames) == (8 if name == "tone_bars.avi" else 6)


def test_movi_beyond_64k_junk(tmp_path):
    p = tmp_path / "clip.avi"
    frames, _ = _write_fixture(p, with_audio=False)
    raw = bytearray(p.read_bytes())
    movi_at = raw.find(b"LIST", 12)
    while raw[movi_at + 8 : movi_at + 12] != b"movi":
        movi_at = raw.find(b"LIST", movi_at + 1)
    junk = b"JUNK" + struct.pack("<I", 80 * 1024) + b"\x00" * (80 * 1024)
    padded = raw[:movi_at] + junk + raw[movi_at:]
    struct.pack_into("<I", padded, 4, len(padded) - 8)
    big = tmp_path / "padded.avi"
    big.write_bytes(padded)
    info = read_avi(big)
    assert asdict(info) == asdict(javi.read_avi(big)) and len(info.video.frames) == 5
    for want, (off, size) in zip(frames, info.video.frames):
        assert bytes(padded)[off : off + size] == want


def _avi_pair(url, fmt_port=FMT, fmt_jax=JFMT, audio=False, **kw):
    from phaneron_tpu.producer.avi_file import AviProducer as JAvi

    jp = JAvi("1-1", jproducer.LoadParams(url=str(url), **kw), fmt_jax)
    tp = _port(AviProducer, "1-1", tproducer.LoadParams(url=str(url), **kw), fmt_port)
    return run(_drain(jp, audio=audio)), run(_drain(tp, audio=audio)), tp


def test_avi_video_bit_exact_and_audio_equal_jax(tmp_path):
    p = tmp_path / "clip.avi"
    frames, _ = _write_fixture(p)
    (jgot, ja0), (got, a0), prod = _avi_pair(p, audio=True)
    assert prod.pix_format == "v210" and len(got) == len(jgot) == 5
    for k, (j, t) in enumerate(zip(jgot, got)):
        assert _port_words(t).tobytes() == _jax_words(j).tobytes() == frames[k]
        assert t.payload[0].dtype == torch.int32 and t.payload[0].device == CPU
    assert a0.samples.shape[0] == FMT.audio_channels  # up-mapped 2 -> 8
    assert a0.sample_rate == ja0.sample_rate == 48000
    assert np.array_equal(a0.samples, ja0.samples) and float(np.abs(a0.samples).max()) > 0.01


def test_avi_seek_and_loop_equal_jax(tmp_path):
    p = tmp_path / "clip.avi"
    frames, _ = _write_fixture(p, with_audio=False)
    (jgot, _), (got, _), _ = _avi_pair(p, seek=3, loop=True, length=4)
    idx = [frames.index(_port_words(f).tobytes()) for f in got[:4]]
    assert idx == [frames.index(_jax_words(f).tobytes()) for f in jgot[:4]] == [3, 4, 3, 4]


def test_avi_rejects_non_avi_and_compressed(tmp_path):
    from phaneron_tpu_torch.producer.producer import InvalidProducerError

    with pytest.raises(InvalidProducerError):
        AviProducer("1-1", tproducer.LoadParams(url=str(tmp_path / "x.mov")), FMT)
    bad = tmp_path / "x.avi"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00AVI junkjunkjunk")
    with pytest.raises(InvalidProducerError):
        AviProducer("1-1", tproducer.LoadParams(url=str(bad)), FMT)


def test_avi_registry_fallback_chain(tmp_path):
    p = tmp_path / "clip.avi"
    _write_fixture(p, with_audio=False)
    reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer, create_avi_producer,
                                      create_raw_file_producer])

    async def drive():
        prod = await reg.create_source("1-1", tproducer.LoadParams(url=str(p)), FMT, device="cpu")
        assert isinstance(prod, AviProducer)
        prod.release()

    run(drive())


@pytest.mark.parametrize("case", ["fixture", "420"])
def test_mjpg_plays_as_jax(tmp_path, case):
    """The committed MJPG fixture (4:4:4 bars, each bar's centre within
    JPEG tolerance of its colour) and a 4:2:0 camera-style MJPG: every
    decoded frame equals JAX's pixel for pixel, alpha 255."""
    pytest.importorskip("PIL")
    from PIL import Image

    if case == "fixture":
        p = FIXTURES / "tone_bars_mjpg.avi"
        h, w = 64, 96
    else:
        w, h = 96, 64
        chunks = []
        for k in range(4):
            rgb = np.zeros((h, w, 3), np.uint8)
            rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2] = 30 * k + 20, 200 - 30 * k, 90
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, "JPEG", quality=92, subsampling="4:2:0")
            chunks.append(buf.getvalue())
        p = tmp_path / "cam420.avi"
        write_avi(p, chunks, "MJPG", w, h, 25.0)
    (jgot, ja0), (got, a0), prod = _avi_pair(p, audio=(case == "fixture"))
    assert prod.pix_format == "rgba8" and len(got) == len(jgot) == (6 if case == "fixture" else 4)
    for j, t in zip(jgot, got):
        px = t.payload[0].numpy()
        assert px.shape == (h, w, 4) and px.dtype == np.uint8 and (px[:, :, 3] == 255).all()
        assert np.array_equal(px, np.asarray(j.payload[0]))
    if case == "fixture":
        bars = np.array([[235, 235, 235], [235, 235, 16], [16, 235, 235], [16, 235, 16],
                         [235, 16, 235], [235, 16, 16], [16, 16, 235], [16, 16, 16]], np.int32)
        for k, f in enumerate(got):
            for i in range(8):
                sample = f.payload[0].numpy()[32, i * 12 + 6, :3].astype(np.int32)
                assert np.abs(sample - bars[(i + k) % 8]).max() <= 12
        assert np.array_equal(a0.samples, ja0.samples) and a0.sample_rate == 48000


def test_record_avi_and_replay_roundtrip_equal_jax(tmp_path):
    """Record a channel to an .avi with the file consumer, then play the
    file back: the port's recording equals JAX's byte for byte, and the
    AVI producer plays it back frame for frame."""
    from phaneron_tpu.consumer.file_consumer import FileConsumer as JFile
    from phaneron_tpu_torch.consumer.file_consumer import FileConsumer

    tiny, jtiny = tconfig.VideoFormat(*TINY), jconfig.VideoFormat(*TINY)

    async def record(jax_side, out):
        if jax_side:
            reg = jproducer.ProducerRegistry([jpattern.create_test_pattern_producer])
            ch, cons, lp = jchannel.Channel(1, jtiny, reg, use_pallas=False), JFile, jproducer.LoadParams
        else:
            reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer])
            ch, cons, lp = tchannel.Channel(1, tiny, reg, device="cpu"), FileConsumer, tproducer.LoadParams
        cons = cons({"path": str(out), "format": "v210"})
        await ch.add_consumer(cons)
        assert await ch.load_source(1, lp("BARS")) and ch.play(1)
        frames = []
        for _ in range(4):
            frame = await ch.render_frame()
            frames.append(np.asarray(frame.packed[0]).tobytes())
            await cons.deliver(frame)
        cons.release()
        await ch.shutdown()
        return frames

    run(record(True, tmp_path / "jax.avi"))
    want = run(record(False, tmp_path / "rec.avi"))
    out = tmp_path / "rec.avi"
    assert out.read_bytes() == (tmp_path / "jax.avi").read_bytes()
    info = read_avi(out)
    assert len(info.video.frames) == 4 and info.video.fourcc == "v210"
    assert info.audio is not None and info.audio.format_tag == 3
    (got, _) = run(_drain(_port(AviProducer, "1-1", tproducer.LoadParams(url=str(out)), tiny)))
    assert [_port_words(f).tobytes() for f in got] == want


# ---------------------------------------------------------------- images

W, H = 96, 64


def _write_pngs(tmp_path, n=5, name="f%04d.png", start=0, alpha=False):
    from PIL import Image

    colours = []
    for k in range(n):
        rgba = np.zeros((H, W, 4), np.uint8)
        rgba[:, :, 0] = 40 * k + 10
        rgba[:, :, 1] = 255 - 40 * k
        rgba[:, :, 2] = 128
        rgba[:, :, 3] = 200 if alpha else 255
        colours.append(rgba)
        Image.fromarray(rgba if alpha else rgba[:, :, :3]).save(tmp_path / (name % (start + k)))
    return colours


def _seq_pair(url, limit=64, **kw):
    from phaneron_tpu.producer.image_seq import ImageSeqProducer as JSeq

    jp = JSeq("1-1", jproducer.LoadParams(url=str(url), **kw), JFMT)
    tp = _port(ImageSeqProducer, "1-1", tproducer.LoadParams(url=str(url), **kw), FMT)
    (jgot, _), (got, _) = run(_drain(jp, limit)), run(_drain(tp, limit))
    return jgot, got, tp


@pytest.mark.parametrize("alpha", [False, True])
def test_png_sequence_bit_exact_as_jax(tmp_path, alpha):
    """PNG is lossless: frames equal the source pixels, alpha kept, and
    JAX's frames."""
    pytest.importorskip("PIL")
    want = _write_pngs(tmp_path, n=5 if not alpha else 2, alpha=alpha)
    jgot, got, prod = _seq_pair(tmp_path / "f%04d.png")
    assert prod.pix_format == "rgba8" and (prod.width, prod.height) == (W, H)
    assert len(got) == len(jgot) == len(want)
    for k, f in enumerate(got):
        assert np.array_equal(f.payload[0].numpy(), want[k])
        assert np.array_equal(f.payload[0].numpy(), np.asarray(jgot[k].payload[0]))


def test_glob_directory_and_printf_expansion(tmp_path):
    pytest.importorskip("PIL")
    from phaneron_tpu.producer.image_seq import _expand as jexpand
    from phaneron_tpu_torch.producer.image_seq import _expand

    _write_pngs(tmp_path, n=3, name="img_%d.png")
    for url in (str(tmp_path / "*.png"), str(tmp_path)):
        assert len(ImageSeqProducer("1-1", tproducer.LoadParams(url=url), FMT).files) == 3
        assert _expand(url) == jexpand(url)
    one = tmp_path / "one"
    one.mkdir()
    _write_pngs(one, n=4, start=1)
    url = str(one / "f%04d.png")
    assert len(ImageSeqProducer("1-1", tproducer.LoadParams(url=url), FMT).files) == 4
    assert _expand(url) == jexpand(url)


def test_still_image_holds_forever(tmp_path):
    pytest.importorskip("PIL")
    _write_pngs(tmp_path, n=1, name="logo%d.png")
    jgot, got, prod = _seq_pair(tmp_path / "logo0.png", limit=7)
    assert prod.still and prod.loop
    assert len(got) == len(jgot) == 7
    assert all(np.array_equal(f.payload[0].numpy(), np.asarray(j.payload[0])) for f, j in zip(got, jgot))


def test_image_seek_loop_length(tmp_path):
    pytest.importorskip("PIL")
    want = _write_pngs(tmp_path, n=5)
    jgot, got, _ = _seq_pair(tmp_path / "f%04d.png", seek=3, loop=True, length=4)
    idx = [next(i for i, w in enumerate(want) if np.array_equal(f.payload[0].numpy(), w)) for f in got]
    jidx = [next(i for i, w in enumerate(want) if np.array_equal(np.asarray(f.payload[0]), w)) for f in jgot]
    assert idx == jidx == [3, 4, 3, 4]


def test_sequence_json_fps(tmp_path):
    pytest.importorskip("PIL")
    _write_pngs(tmp_path, n=3)
    (tmp_path / "sequence.json").write_text('{"fps": 25, "loop": true}')
    prod = ImageSeqProducer("1-1", tproducer.LoadParams(url=str(tmp_path / "f%04d.png")), FMT)
    assert prod.loop and prod.fmt.timescale == 25000 and prod.fmt.fields == 1


def test_image_rejects_non_images(tmp_path):
    from phaneron_tpu_torch.producer.producer import InvalidProducerError

    for url in (str(tmp_path / "x.mov"), "BARS", str(tmp_path / "*.png")):
        with pytest.raises(InvalidProducerError):
            ImageSeqProducer("1-1", tproducer.LoadParams(url=url), FMT)


def test_image_geometry_mismatch_raises(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    from phaneron_tpu_torch.producer.producer import InvalidProducerError

    _write_pngs(tmp_path, n=2)
    Image.new("RGB", (W // 2, H)).save(tmp_path / "f0001.png")
    prod = _port(ImageSeqProducer, "1-1", tproducer.LoadParams(url=str(tmp_path / "f%04d.png")), FMT)

    async def drive():
        await prod.initialise()
        vs = prod.video_stream()
        await vs.next()
        with pytest.raises(InvalidProducerError, match="sequence geometry"):
            await vs.next()
        prod.release()

    run(drive())


def test_image_registry_dispatch_and_channel_equal_jax(tmp_path):
    """PLAY a PNG sequence with alpha, keyed over BARS on layer 1: the
    registry picks the image producer and each channel frame is 0 codes
    from JAX's."""
    pytest.importorskip("PIL")
    from phaneron_tpu.producer.image_seq import create_image_seq_producer as jcreate
    from phaneron_tpu.producer.raw_file import create_raw_file_producer as jraw

    _write_pngs(tmp_path, n=3, alpha=True)
    url = str(tmp_path / "f%04d.png")

    async def play(jax_side):
        if jax_side:
            reg = jproducer.ProducerRegistry([jpattern.create_test_pattern_producer, jcreate, jraw])
            ch, lp = jchannel.Channel(1, jconfig.VideoFormat(*TINY), reg, use_pallas=False), jproducer.LoadParams
            words = np.asarray
        else:
            reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer, create_image_seq_producer,
                                              create_raw_file_producer])
            ch, lp = tchannel.Channel(1, tconfig.VideoFormat(*TINY), reg, device="cpu"), tproducer.LoadParams
            words = words_to_numpy
        assert await ch.load_source(1, lp("BARS")) and ch.play(1)
        assert await ch.load_source(2, lp(url, loop=True)) and ch.play(2)
        name = type(ch.layers[2].cur.producer).__name__
        out = [words((await ch.render_frame()).packed[0]) for _ in range(4)]
        await ch.shutdown()
        return name, out

    (jname, jframes), (name, frames) = run(play(True)), run(play(False))
    assert name == jname == "ImageSeqProducer"
    for j, t in zip(jframes, frames):
        assert max_code_delta(j, t, W, H) == 0


# ---------------------------------------------------------------- WAV

WAV_FMT = ("wav_t", 1, 96, 64, 96, 50, 1, 48000, 2)


def _write_wav(path, samples, rate=48000, channels=1, sampwidth=2):
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(sampwidth)
        wf.setframerate(rate)
        if sampwidth == 1:
            wf.writeframes(np.clip(samples * 127 + 128, 0, 255).astype(np.uint8).tobytes())
        elif sampwidth == 2:
            wf.writeframes((samples * 32767).astype("<i2").tobytes())
        elif sampwidth == 3:
            i = (samples * 8388607).astype("<i4")
            wf.writeframes(i.view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
        else:
            wf.writeframes((samples * 2147483647).astype("<i4").tobytes())


@pytest.mark.parametrize("sampwidth", [1, 2, 3, 4])
def test_wav_plays_audio_with_black_video_as_jax(tmp_path, sampwidth):
    """Every sample width decodes to JAX's chunks (mono up-mapped), and the
    pacing frame is true black (Y 64, Cb Cr 512), JAX's words."""
    from phaneron_tpu.producer.wav_file import WavProducer as JWav

    path = tmp_path / "tone.wav"
    t = np.arange(4096, dtype=np.float32)
    _write_wav(path, 0.5 * np.sin(2 * np.pi * 1000 * t / 48000), sampwidth=sampwidth)

    async def first(prod):
        await prod.initialise()
        chunks = [await prod.audio_stream().next()]
        vf = await prod.video_stream().next()
        prod.release()
        return chunks[0], vf

    ja, jv = run(first(JWav("wav", jproducer.LoadParams(str(path)), jconfig.VideoFormat(*WAV_FMT))))
    ta, tv = run(first(_port(WavProducer, "wav", tproducer.LoadParams(str(path)), tconfig.VideoFormat(*WAV_FMT))))
    assert ta.samples.shape[0] == 2 and np.array_equal(ta.samples, ja.samples)
    rms = float(np.sqrt((ta.samples[0] ** 2).mean()))
    assert 0.3 < rms < 0.4
    assert tv.format == "v210" and tv.payload[0].device == CPU
    assert np.array_equal(_port_words(tv), _jax_words(jv))
    y, u, v = get_format("v210").unpack_codes(tv.payload, 96, 64)
    assert (y == 64).all() and (u == 512).all() and (v == 512).all()


def test_wav_ends_after_audio_and_loops(tmp_path):
    path = tmp_path / "short.wav"
    _write_wav(path, np.zeros(2048, np.float32))
    fmt = tconfig.VideoFormat(*WAV_FMT)

    async def main():
        p = _port(WavProducer, "wav", tproducer.LoadParams(str(path)), fmt)
        await p.initialise()
        audio, video = p.audio_stream(), p.video_stream()
        chunks = 0
        while (await audio.next()) is not END:
            chunks += 1
        assert chunks == 2  # 2048 samples = 2 QUANTA
        frames = 0
        while (await video.next()) is not END:  # the black video ends with the audio
            frames += 1
        assert frames <= 4
        lp = _port(WavProducer, "wav", tproducer.LoadParams(str(path), loop=True), fmt)
        await lp.initialise()
        la = lp.audio_stream()
        for _ in range(5):
            assert (await la.next()) is not END
        lp.release()
        p.release()

    run(main())


def test_wav_rejects_non_wav_and_falls_through_registry(tmp_path):
    from phaneron_tpu_torch.producer.producer import InvalidProducerError

    fmt = tconfig.VideoFormat(*WAV_FMT)
    with pytest.raises(InvalidProducerError):
        WavProducer("wav", tproducer.LoadParams("nope.mp3"), fmt)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a riff wave at all")
    with pytest.raises(InvalidProducerError):
        WavProducer("wav", tproducer.LoadParams(str(bad)), fmt)

    async def main():
        reg = tproducer.ProducerRegistry([create_wav_producer, tpattern.create_test_pattern_producer])
        p = await reg.create_source("s", tproducer.LoadParams("BARS"), fmt, device="cpu")
        assert p is not None and type(p).__name__ == "TestPatternProducer"
        p.release()

    run(main())


# ---------------------------------------------------------------- fixtures


def test_fixtures_write_jax_files(tmp_path):
    """utils/fixtures.write_interlaced_v210 writes JAX's .v210, .pcm and
    sidecar JSON byte for byte."""
    from phaneron_tpu.utils.fixtures import write_interlaced_v210 as jwrite
    from phaneron_tpu_torch.utils.fixtures import write_interlaced_v210

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _, jframes = jwrite(tmp_path / "jax", 96, 64, 3, audio_channels=2)
    path, frames = write_interlaced_v210(tmp_path / "port", 96, 64, 3, audio_channels=2)
    assert all(f.dtype == np.uint32 and np.array_equal(f, np.asarray(j)) for f, j in zip(frames, jframes))
    for name in ("clip.v210", "clip.pcm", "clip.v210.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


# ---------------------------------------------------------------- cluster


def test_mjpeg_loopback_between_channels():
    """Channel 1's MJPEG consumer feeds channel 2's MJPEG producer on
    localhost: every ingested frame equals JAX's decode of the same JPEG
    bytes, and channel 2's frames carry the bars (bright luma)."""
    pytest.importorskip("PIL")
    from phaneron_tpu.producer.mjpeg import MJPEGProducer as JMJPEG
    from phaneron_tpu_torch.consumer.mjpeg_consumer import MJPEGConsumer
    from phaneron_tpu_torch.producer.mjpeg import MJPEGProducer, create_mjpeg_producer

    tiny = tconfig.VideoFormat(*TINY)
    seen = []  # (jpeg bytes, payload)

    async def main():
        reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer, create_mjpeg_producer])
        ch1 = tchannel.Channel(1, tiny, reg, device="cpu")
        out = MJPEGConsumer({"port": 0, "quality": 95})
        await ch1.add_consumer(out)
        assert await ch1.load_source(1, tproducer.LoadParams("BARS")) and ch1.play(1)
        ch2 = tchannel.Channel(2, tiny, reg, device="cpu")
        load = asyncio.create_task(ch2.load_source(1, tproducer.LoadParams(f"http://127.0.0.1:{out.port}/")))
        for _ in range(3):
            await out.deliver(await ch1.render_frame())
            await asyncio.sleep(0.02)
        assert await load
        ch2.play(1)
        prod = ch2.layers[1].cur.producer
        assert isinstance(prod, MJPEGProducer)
        next_jpeg, decode = prod._next_jpeg, prod._decode_upload

        async def recorded():
            jpeg = await next_jpeg()
            seen.append([jpeg])
            return jpeg

        def decode_recorded(jpeg, w, h):
            planes, stamp = decode(jpeg, w, h)
            seen[-1].append(planes[0].clone())
            return planes, stamp

        prod._next_jpeg, prod._decode_upload = recorded, decode_recorded
        frame = None
        for _ in range(6):
            await out.deliver(await ch1.render_frame())
            frame = await ch2.render_frame()
            await asyncio.sleep(0.01)
        out.release()
        ch2.layer(1).clear()
        await ch1.shutdown()
        await ch2.shutdown()
        return frame

    frame = run(main())
    y, _, _ = get_format("v210").unpack_codes(frame.packed, 96, 64)
    assert int(y.max()) > 700
    jprod = JMJPEG("2-1", jproducer.LoadParams("http://127.0.0.1:1/"), jconfig.VideoFormat(*TINY))
    decoded = [s for s in seen if len(s) == 2]
    assert decoded
    for jpeg, payload in decoded:
        (ref,), _ = jprod._decode_upload(jpeg, 96, 64)
        assert np.array_equal(payload.numpy(), np.asarray(ref))


def test_mjpeg_decode_resizes_as_jax():
    """A part at another size is resized to the channel's at Pillow's
    default filter, as JAX's producer does."""
    pytest.importorskip("PIL")
    from PIL import Image

    from phaneron_tpu.producer.mjpeg import MJPEGProducer as JMJPEG
    from phaneron_tpu_torch.utils.jpeg import FIT_RGB, JpegProcess

    rng = np.random.default_rng(3)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(buf, "JPEG", quality=90)
    jprod = JMJPEG("2-1", jproducer.LoadParams("http://127.0.0.1:1/"), jconfig.VideoFormat(*TINY))
    (ref,), _ = jprod._decode_upload(buf.getvalue(), 96, 64)
    codec = JpegProcess()
    out = np.empty((64, 96, 4), np.uint8)
    try:
        assert codec.decode(buf.getvalue(), 96, 64, FIT_RGB, out)
    finally:
        codec.close()
    assert np.array_equal(out, np.asarray(ref))


# ---------------------------------------------------------------- registries


class _Capture:
    def __init__(self, *args):
        self.closed = False

    async def open(self, device_index, fmt):
        pass

    async def capture_frame(self):
        return None

    def close(self):
        self.closed = True


def _media(tmp_path):
    """One source of each URL kind the registries tell apart."""
    from PIL import Image

    avi = tmp_path / "clip.avi"
    _write_fixture(avi, w=96, h=64, with_audio=False)
    wav = tmp_path / "bed.wav"
    _write_wav(wav, np.zeros(4096, np.float32))
    seq = tmp_path / "seq"
    seq.mkdir()
    _write_pngs(seq, n=2)
    Image.new("RGB", (W, H)).save(tmp_path / "logo.png")
    raw = tmp_path / "clip.96x64.v210"
    raw.write_bytes(b"".join(_v210_frames(96, 64, 2)))
    return {
        "bars": "BARS", "ramp": "RAMP@yuv422p10le", "decklink": "DECKLINK", "avi": str(avi),
        "mjpg_avi": str(FIXTURES / "tone_bars_mjpg.avi"), "wav": str(wav), "printf": str(seq / "f%04d.png"),
        "still": str(tmp_path / "logo.png"), "dir": str(seq), "raw": str(raw), "media": str(tmp_path / "x.mxf"),
    }


@pytest.mark.parametrize("backend,stubs", [(False, False), (True, False), (False, True), (True, True)])
def test_registries_pick_the_jax_servers_classes(tmp_path, monkeypatch, backend, stubs):
    """For each URL kind, with and without a capture backend and with and
    without ffmpeg stubs on PATH, the port server's producer registry picks
    the counterpart of the class JAX's picks (or none where JAX's finds
    none); an MJPEG HTTP URL too.  The consumer registries hold the same
    names in the same order."""
    pytest.importorskip("PIL")
    from phaneron_tpu import server as jserver
    from phaneron_tpu.producer import sdi_capture as jsdi
    from phaneron_tpu_torch import server as tserver
    from phaneron_tpu_torch.consumer.mjpeg_consumer import MJPEGConsumer
    from phaneron_tpu_torch.producer import sdi_capture as tsdi
    from phaneron_tpu_torch.utils.fixtures import write_ffmpeg_stubs

    if stubs:
        write_ffmpeg_stubs(tmp_path / "bin", 100, 80)
        monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    urls = _media(tmp_path)
    fmt = tconfig.VideoFormat(*TINY)
    jfmt = jconfig.VideoFormat(*TINY)

    async def picks():
        http = MJPEGConsumer({"port": 0})
        await http.initialise(fmt)
        urls["http"] = f"http://127.0.0.1:{http.port}/"
        out = {}
        try:
            for name, reg, lp, f, kw, sdi in (
                ("jax", jserver.PhaneronServer().producer_registry, jproducer.LoadParams, jfmt, {}, jsdi),
                ("port", tserver.PhaneronServer(device="cpu").producer_registry, tproducer.LoadParams, fmt,
                 {"device": "cpu"}, tsdi),
            ):
                sdi.set_capture_backend(_Capture if backend else None)
                for kind, url in urls.items():
                    prod = await reg.create_source("1-1", lp(url), f, **kw)
                    out[name, kind] = None if prod is None else (type(prod).__module__.split(".", 1)[1],
                                                                 type(prod).__name__)
                    if prod is not None:
                        prod.release()
                sdi.set_capture_backend(None)
        finally:
            http.release()
        return out

    out = run(picks())
    for kind in urls:
        assert out["port", kind] == out["jax", kind], kind
    assert out["port", "decklink"][1] == ("SDICaptureProducer" if backend else "TestPatternProducer")
    assert out["port", "media"] == (("producer.ffmpeg", "FFmpegProducer") if stubs else None)
    assert out["port", "http"] == ("producer.mjpeg", "MJPEGProducer")
    assert list(tserver.default_consumer_registry().factories) == list(jserver.default_consumer_registry().factories)
