"""Port parity for the ffmpeg pair, driven by stub ffmpeg / ffprobe
binaries (``utils/fixtures.write_ffmpeg_stubs``) on PATH: the JAX
package's FFmpegProducer / FFmpegConsumer and the port's over the same
stubs.

Counterparts of tests/test_ffmpeg_producer.py.  Contracts: probe and the
format dispatch equal JAX's; a media file's channel frames (yuv422p10le
and yuv420p sources at the channel's size and at a width that is not a
multiple of 8, stretch-fit, 25 fps doubled on a 50 Hz channel) within 1
code of JAX's ``Channel(use_pallas=False)`` (the planar formats' contract
against JAX's XLA path), with the merged audio tone; audio-only
media plays true black with sound; the consumer's rawvideo and audio
bytes into the stub equal JAX's consumer's for the same frames; a dead
encoder never stalls delivery; without a binary the consumer raises."""

import asyncio
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu import config as jconfig
from phaneron_tpu.producer import producer as jproducer
from phaneron_tpu.runtime import channel as jchannel
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.consumer.consumer import ChannelFrame
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.ops.formats import get_format
from phaneron_tpu_torch.producer import ffmpeg as tff
from phaneron_tpu_torch.producer import producer as tproducer
from phaneron_tpu_torch.producer import test_pattern as tpattern
from phaneron_tpu_torch.runtime import channel as tchannel
from phaneron_tpu_torch.runtime.stream import END
from phaneron_tpu_torch.utils.fixtures import rawvideo_frame, write_ffmpeg_stubs
from torch_parity import max_code_delta

torch.set_num_threads(1)

TINY = ("tiny", 1, 96, 64, 96, 50, 1, 48000, 2)
W_SRC, H_SRC = 100, 80  # deliberately not a multiple of 8
N_FRAMES = 12


def _on_path(monkeypatch, bindir: Path) -> None:
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")


@pytest.fixture
def stubs(tmp_path, monkeypatch):
    def put(pix_fmt="yuv422p10le", width=W_SRC, height=H_SRC):
        bindir = write_ffmpeg_stubs(tmp_path / f"bin_{pix_fmt}_{width}", width, height, pix_fmt, N_FRAMES)
        _on_path(monkeypatch, bindir)
        return bindir

    return put


def test_probe_and_dispatch_equal_jax(stubs):
    from phaneron_tpu.producer import ffmpeg as jff

    stubs()
    info = tff.probe("clip.mxf")
    assert info == jff.probe("clip.mxf") and len(info["streams"]) == 3
    for pix in ("yuv422p10le", "yuv420p", "yuv422p", "nv12", "rgba", "bgra", "yuv444p12le", "yuva420p", "gbrap"):
        assert tff._dispatch_pix(pix) == jff._dispatch_pix(pix), pix
    assert tff._dispatch_pix("yuv422p") == ("yuv422p", "yuv422p8")
    assert tff._dispatch_pix("yuva420p")[0] == "rgba"


@pytest.mark.parametrize("pix", ["yuv422p10le", "yuv420p", "yuv422p", "nv12", "rgba8"])
def test_rawvideo_layout_pads_each_row(pix):
    """Rows of each plane are the unpadded width of that plane (JAX's
    geometry), pitched in the planes the port uploads."""
    layout = tff.rawvideo_layout(pix, W_SRC, H_SRC)
    fmt = get_format(pix)
    assert [r * p for r, _, p in layout] == fmt.num_bytes(W_SRC, H_SRC)
    if pix in ("yuv422p10le", "yuv420p", "yuv422p"):
        sample = 2 if pix == "yuv422p10le" else 1
        rows_c = H_SRC if pix != "yuv420p" else H_SRC // 2
        assert [(r, c) for r, c, _ in layout] == [(H_SRC, W_SRC * sample), (rows_c, 50 * sample),
                                                   (rows_c, 50 * sample)]
    if pix == "rgba8":
        assert layout == [(H_SRC, 4 * W_SRC, 4 * W_SRC)]


async def _play(jax_side: bool, url: str, ticks: int):
    if jax_side:
        from phaneron_tpu.producer import ffmpeg as jff

        ch = jchannel.Channel(1, jconfig.VideoFormat(*TINY), jproducer.ProducerRegistry([jff.create_ffmpeg_producer]),
                              use_pallas=False)
        lp, words = jproducer.LoadParams, np.asarray
    else:
        ch = tchannel.Channel(1, tconfig.VideoFormat(*TINY), tproducer.ProducerRegistry([tff.create_ffmpeg_producer]),
                              device="cpu")
        lp, words = tproducer.LoadParams, words_to_numpy
    assert await ch.load_source(1, lp(url))
    ch.play(1)
    frames, rms = [], []
    for _ in range(ticks):
        f = await ch.render_frame()
        frames.append(words(f.packed[0]))
        rms.append(float(np.sqrt(np.mean(np.square(f.audio)))))
    ch.layer(1).clear()
    await ch.shutdown()
    return frames, rms


@pytest.mark.parametrize("pix", ["yuv422p10le", "yuv420p"])
@pytest.mark.parametrize("size", [(W_SRC, H_SRC), (96, 64)])
def test_media_with_audio_plays_as_jax(stubs, pix, size):
    """A source with two mono audio streams, at the channel's size and at
    100x80 (stretch-fit through the src_size resize): each channel frame
    within 1 code of JAX's XLA path, the contract of the planar file-media
    formats and of src_size frames against it (tests/test_torch_media_channel.py,
    test_torch_resize.py: float32 transfers round a few samples apart).
    Content flows, at most one change every other frame (25 fps on 50 Hz),
    and the merged tone is audible."""
    stubs(pix, *size)
    (jframes, _), (frames, rms) = run(_play(True, "clip.mxf", 8)), run(_play(False, "clip.mxf", 8))
    for j, t in zip(jframes, frames):
        assert max_code_delta(j, t, 96, 64) <= 1
    lumas = [int(get_format("v210").unpack_codes([torch.from_numpy(f.view(np.int32))], 96, 64)[0].max())
             for f in frames]
    assert max(lumas) > 64
    flowing = [x for x in frames if x.any()]
    changes = sum(1 for a, b in zip(flowing, flowing[1:]) if not np.array_equal(a, b))
    assert changes <= len(flowing) // 2 + 1
    assert max(rms) > 0.2


def test_producer_pads_rows_into_the_frames_planes(stubs):
    """The producer's planes are the stub's rawvideo rows padded with zeros
    to the format's pitch."""
    stubs("yuv420p")

    async def main():
        prod = tff.create_ffmpeg_producer("1-1", tproducer.LoadParams("clip.mxf"), tconfig.VideoFormat(*TINY))
        prod.device = torch.device("cpu")
        await prod.initialise()
        f = await prod.video_stream().next()
        prod.release()
        return f

    f = run(main())
    raw = np.frombuffer(rawvideo_frame("yuv420p", W_SRC, H_SRC, 0), np.uint8)
    y = raw[: W_SRC * H_SRC].reshape(H_SRC, W_SRC)
    u = raw[W_SRC * H_SRC : W_SRC * H_SRC + 50 * 40].reshape(40, 50)
    assert f.format == "yuv420p" and (f.width, f.height) == (W_SRC, H_SRC)
    assert [tuple(p.shape) for p in f.payload] == [(80, 104), (40, 52), (40, 52)]
    assert np.array_equal(f.payload[0].numpy()[:, :W_SRC], y) and not f.payload[0].numpy()[:, W_SRC:].any()
    assert np.array_equal(f.payload[1].numpy()[:, :50], u) and not f.payload[1].numpy()[:, 50:].any()


def test_audio_only_media_renders_black_with_sound(stubs, monkeypatch):
    stubs()
    real_probe = tff.probe
    monkeypatch.setattr(tff, "probe", lambda url: {"streams": [s for s in real_probe(url)["streams"]
                                                               if s["codec_type"] == "audio"]})

    async def main():
        ch = tchannel.Channel(1, tconfig.VideoFormat(*TINY), tproducer.ProducerRegistry([tff.create_ffmpeg_producer]),
                              device="cpu")
        assert await ch.load_source(1, tproducer.LoadParams("song.wav"))
        ch.play(1)
        rms = []
        for _ in range(6):
            f = await ch.render_frame()
            rms.append(float(np.sqrt(np.mean(np.square(f.audio)))))
            y, cb, cr = get_format("v210").unpack_codes(f.packed, 96, 64)
            assert int(y.min()) == int(y.max()) == 64
            assert int(cb.min()) == int(cb.max()) == int(cr.min()) == int(cr.max()) == 512
        assert max(rms) > 0.2
        ch.layer(1).clear()
        await ch.shutdown()

    run(main())


def _rgba_frames(n: int) -> list:
    """(RGBA, audio) a frame: yuv422p10le fill_buf ramps, rolled a few
    rows a frame and decoded (pack(unpack(fill_buf)) is exact on both
    sides, so equal bytes are the contract), with seeded audio."""
    from phaneron_tpu_torch.graph.pipeline import make_unpack_program

    rng = np.random.default_rng(17)
    unpack = make_unpack_program("yuv422p10le", 96, 64, "709", "709", plain=True)
    planes = get_format("yuv422p10le").fill_buf(96, 64)
    out = []
    for k in range(n):
        rgba = unpack([torch.from_numpy(np.roll(p, 3 * k, axis=0).copy()) for p in planes]).numpy()
        out.append((rgba, rng.random((2, 960), dtype=np.float32) - 0.5))
    return out


async def _encode(jax_side: bool, out: Path, frames) -> None:
    if jax_side:
        import jax.numpy as jnp

        from phaneron_tpu.consumer.consumer import ChannelFrame as JFrame
        from phaneron_tpu.consumer.ffmpeg_consumer import FFmpegConsumer as JCons

        cons, fmt = JCons({"path": str(out)}), jconfig.VideoFormat(*TINY)
        make = lambda i, rgba, aud: JFrame(i, None, jnp.asarray(rgba), aud, 96, 64)  # noqa: E731
    else:
        from phaneron_tpu_torch.consumer.ffmpeg_consumer import FFmpegConsumer as TCons

        cons, fmt = TCons({"path": str(out)}), tconfig.VideoFormat(*TINY)
        make = lambda i, rgba, aud: ChannelFrame(i, None, torch.from_numpy(rgba), aud, 96, 64)  # noqa: E731
    await cons.initialise(fmt)
    for i, (rgba, aud) in enumerate(frames):
        await cons.deliver(make(i, rgba, aud))
    cons.release()
    for _ in range(200):  # the encoder writes its file once its inputs close
        await asyncio.sleep(0.05)
        if cons.proc is None and Path(str(out) + ".audio").exists():
            break


def test_encode_consumer_writes_jax_bytes(stubs, tmp_path):
    """The same RGBA frames and audio through both consumers into an
    encoder that writes its inputs unchanged: the rawvideo (yuv422p10le,
    rows cropped to 96 and 48 samples) and the f32 audio equal JAX's."""
    stubs()
    frames = _rgba_frames(5)
    run(_encode(True, tmp_path / "jax.nut", frames))
    run(_encode(False, tmp_path / "port.nut", frames))
    video, jvideo = (tmp_path / "port.nut").read_bytes(), (tmp_path / "jax.nut").read_bytes()
    assert len(video) == 5 * (96 + 48 + 48) * 2 * 64
    assert video == jvideo
    planes = get_format("yuv422p10le").fill_buf(96, 64)
    want = b"".join(np.ascontiguousarray(np.roll(p, 3 * k, axis=0)[:, :cols]).tobytes()
                    for k in range(5) for p, cols in zip(planes, (96, 48, 48)))
    assert video == want  # the ramps round-trip: rows cropped to 96 and 48 samples
    audio = (tmp_path / "port.nut.audio").read_bytes()
    assert len(audio) == 5 * 960 * 2 * 4 and audio == (tmp_path / "jax.nut.audio").read_bytes()
    assert audio == b"".join(np.ascontiguousarray(a.T).tobytes() for _, a in frames)


def test_encode_consumer_records_a_channel(stubs, tmp_path):
    """A BARS channel recorded through the encode consumer: one rawvideo
    frame a tick reaches the encoder, with its audio."""
    stubs()
    from phaneron_tpu_torch.consumer.ffmpeg_consumer import FFmpegConsumer

    out = tmp_path / "rec.nut"

    async def main():
        ch = tchannel.Channel(1, tconfig.VideoFormat(*TINY),
                              tproducer.ProducerRegistry([tpattern.create_test_pattern_producer]), device="cpu")
        cons = FFmpegConsumer({"path": str(out)})
        await ch.add_consumer(cons)
        assert await ch.load_source(1, tproducer.LoadParams("BARS")) and ch.play(1)
        for _ in range(3):
            await cons.deliver(await ch.render_frame())
        cons.release()
        await cons._finish_task
        await ch.shutdown()

    run(main())
    assert len(out.read_bytes()) == 3 * (96 + 48 + 48) * 2 * 64
    assert len(Path(str(out) + ".audio").read_bytes()) == 3 * 960 * 2 * 4


def test_dead_encoder_does_not_stall_delivery(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    p = bindir / "ffmpeg"
    p.write_text(f"#!{shutil.which('python3') or 'python3'}\nimport sys\nsys.stdin.buffer.read(1024)\n")
    p.chmod(0o755)
    _on_path(monkeypatch, bindir)
    from phaneron_tpu_torch.consumer.ffmpeg_consumer import FFmpegConsumer

    async def main():
        fmt = tconfig.VideoFormat(*TINY)
        cons = FFmpegConsumer({"path": str(tmp_path / "rec.nut"), "audio": False})
        await cons.initialise(fmt)
        rgba = torch.zeros((4, 64, 96))
        aud = np.zeros((2, 960), np.float32)
        t0 = time.monotonic()
        for i in range(200):  # 4.9 MB: more than the encoder's pipe holds
            await asyncio.wait_for(cons.deliver(ChannelFrame(i, None, rgba, aud, 96, 64)), timeout=30)
        assert time.monotonic() - t0 < 30
        assert cons._failed  # it saw the encoder die and sheds the frames since
        cons.release()
        await asyncio.wait_for(cons._finish_task, 30)

    run(main())


def test_no_binary_raises(monkeypatch, tmp_path):
    """Without ffmpeg the consumer raises RuntimeError (the server reports
    it and keeps serving) and the producer's factory passes the URL on."""
    monkeypatch.setenv("PATH", str(tmp_path))
    from phaneron_tpu_torch.consumer.ffmpeg_consumer import FFmpegConsumer

    with pytest.raises(RuntimeError, match="no ffmpeg binary"):
        FFmpegConsumer({})
    with pytest.raises(tproducer.InvalidProducerError):
        tff.create_ffmpeg_producer("1-1", tproducer.LoadParams("clip.mxf"), tconfig.VideoFormat(*TINY))


def test_real_binary_against_committed_fixture():
    """With a real ffmpeg / ffprobe pair on PATH, the committed fixture
    plays through probe -> dispatch -> decode -> audio; skipped without."""
    ffprobe, ffmpeg = shutil.which("ffprobe"), shutil.which("ffmpeg")
    if not (ffprobe and ffmpeg):
        pytest.skip("no real ffmpeg/ffprobe on PATH")
    try:
        subprocess.run([ffmpeg, "-version"], capture_output=True, timeout=10, check=True)
    except Exception:
        pytest.skip("ffmpeg on PATH is not a real binary")
    fx = Path(__file__).parent / "fixtures" / "tone_bars.avi"
    fmt = tconfig.VideoFormat("tiny", 1, 96, 16, 96, 50, 1, 48000, 2)

    async def drive():
        prod = tff.FFmpegProducer("1-1", tproducer.LoadParams(url=str(fx)), fmt)
        prod.device = torch.device("cpu")
        await prod.initialise()
        vs, frames = prod.video_stream(), []
        while (f := await vs.next()) is not END:
            frames.append(f)
        a0 = await prod.audio_stream().next()
        prod.release()
        return frames, a0

    frames, a0 = run(drive())
    assert len(frames) >= 8 and float(np.abs(a0.samples).max()) > 0.01
