"""Port parity for the consumers and producers the server runs: the same
load through the JAX package's ``Channel(use_pallas=False)`` and the
port's ``Channel(device="cpu")``, each frame delivered to the package's
own consumer, and the outputs compared.

Contracts: the file consumer's raw v210 bytes, sidecar JSON and WAV equal
JAX's, progressive and interlaced (fields paired in the packed domain);
the port's copy of tests/test_file_consumer_release.py's three drain and
abandon contracts; the preview's GET / body and /audio.wav header equal
JAX's; the raw-file producer plays back, with SEEK, LENGTH, LOOP and CALL
SEEK, the frames JAX's plays; a ROUTE channel equals its source; the MJPEG
stream's parts are JPEGs of the channel's frame."""

import asyncio
import io
import json
import threading

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu import config as jconfig
from phaneron_tpu.consumer import file_consumer as jfile
from phaneron_tpu.consumer import preview_consumer as jpreview
from phaneron_tpu.producer import producer as jproducer
from phaneron_tpu.producer import raw_file as jraw
from phaneron_tpu.producer import test_pattern as jpattern
from phaneron_tpu.runtime import channel as jchannel
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.consumer import file_consumer as tfile
from phaneron_tpu_torch.consumer import preview_consumer as tpreview
from phaneron_tpu_torch.consumer.consumer import ChannelFrame
from phaneron_tpu_torch.graph.convert import words_to_numpy
from phaneron_tpu_torch.ops.formats import get_format
from phaneron_tpu_torch.producer import producer as tproducer
from phaneron_tpu_torch.producer import raw_file as traw
from phaneron_tpu_torch.producer import test_pattern as tpattern
from phaneron_tpu_torch.producer.route import make_route_factory
from phaneron_tpu_torch.runtime import channel as tchannel
from torch_parity import max_code_delta

torch.set_num_threads(1)

FMTS = {
    "tiny": ("tiny", 1, 96, 64, 96, 50, 1, 48000, 2),
    "tiny_i": ("tiny_i", 2, 256, 64, 256, 50, 1, 48000, 2),  # an interlaced 50-field channel
}
BOX = (0.1, 0.05, 0.8, 0.8)


def _side(jax_side: bool, fmt_name: str):
    """(channel, LoadParams, TransitionSpec, FileConsumer, words) of one package."""
    if jax_side:
        from phaneron_tpu.runtime.types import TransitionSpec

        reg = jproducer.ProducerRegistry([jpattern.create_test_pattern_producer, jraw.create_raw_file_producer])
        ch = jchannel.Channel(1, jconfig.VideoFormat(*FMTS[fmt_name]), reg, use_pallas=False)
        return ch, jproducer.LoadParams, TransitionSpec, jfile.FileConsumer, np.asarray
    from phaneron_tpu_torch.runtime.types import TransitionSpec

    reg = tproducer.ProducerRegistry([tpattern.create_test_pattern_producer, traw.create_raw_file_producer])
    ch = tchannel.Channel(1, tconfig.VideoFormat(*FMTS[fmt_name]), reg, device="cpu")
    return ch, tproducer.LoadParams, TransitionSpec, tfile.FileConsumer, words_to_numpy


async def _record(jax_side: bool, fmt_name: str, out_dir, ticks: int, box: bool = True) -> list:
    """BARS (under a DVE box) dissolving to RAMP, ticked by render_frame,
    each frame delivered to the package's file consumer (video + WAV);
    returns the channel's packed frames."""
    ch, LoadParams, Transition, FileConsumer, words = _side(jax_side, fmt_name)
    out_dir.mkdir()
    cons = FileConsumer({"path": str(out_dir / "out.v210"), "audio_path": str(out_dir / "out.wav")})
    await ch.add_consumer(cons)
    assert await ch.load_source(1, LoadParams("BARS"))
    assert ch.play(1)
    if box:
        assert ch.layer(1).set_fill(*BOX)
    frames = []
    for t in range(ticks):
        if t == 4:
            assert await ch.load_source(1, LoadParams("RAMP"), transition=Transition("dissolve", 4))
            assert ch.play(1)
        frame = await ch.render_frame()
        frames.append(words(frame.packed[0]))
        await cons.deliver(frame)
    cons.release()
    assert cons.leaked_threads == 0
    await ch.shutdown()
    return frames


@pytest.mark.parametrize("fmt_name,ticks,box", [("tiny", 10, False), ("tiny", 10, True), ("tiny_i", 16, True)])
def test_file_consumer_writes_jax_bytes(tmp_path, fmt_name, ticks, box):
    """The recording is the channel's frames byte for byte (interlaced:
    each pair of field ticks' rows interleaved), and its raw v210 bytes,
    sidecar JSON and WAV equal JAX's.  Under a progressive DVE box the
    channel's own frames are held to the runtime's contract, 1 code from
    JAX's (the warp family's), and so is the recording."""
    run(_record(True, fmt_name, tmp_path / "jax", ticks, box))
    ticked = run(_record(False, fmt_name, tmp_path / "port", ticks, box))
    w, h = FMTS[fmt_name][2:4]
    interlaced = fmt_name == "tiny_i"
    n = ticks // 2 if interlaced else ticks
    port, ref = ((tmp_path / side / "out.v210").read_bytes() for side in ("port", "jax"))
    assert len(port) == len(ref) == n * get_format("v210").num_bytes(w, h)[0]
    words = lambda b: np.frombuffer(b, np.uint32).reshape(n, h, -1)
    for k, (a, b) in enumerate(zip(words(port), words(ref))):
        if interlaced:
            top, bottom = ticked[2 * k], ticked[2 * k + 1]
            assert np.array_equal(a[0::2], top[0::2]) and np.array_equal(a[1::2], bottom[1::2])
        else:
            assert np.array_equal(a, ticked[k])
        assert max_code_delta(a, b, w, h) <= 1
    if interlaced or not box:
        assert port == ref
    for name in ("out.v210.json", "out.wav"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    meta = json.loads((tmp_path / "port" / "out.v210.json").read_text())
    assert meta["interlaced"] == interlaced


# ---- tests/test_file_consumer_release.py's contracts, on the port's consumer

TINY = tconfig.VideoFormat(*FMTS["tiny"])


def _frame(ts: int) -> ChannelFrame:
    words = get_format("v210").fill_buf(96, 64)[0] + np.uint32(ts % 7)
    return ChannelFrame(
        timestamp=ts,
        packed=[torch.from_numpy(words.view(np.int32))],
        rgba=None,
        audio=np.zeros((2, 960), np.float32),
        width=96,
        height=64,
    )


def test_release_drains_every_delivered_frame(tmp_path):
    """All delivered frames are on disk after release, in order, with the
    last in-flight frame between queue and ring; more frames than the
    consumer's pinned-buffer depth backpressure and still arrive."""

    async def main():
        out = tmp_path / "out.v210"
        cons = tfile.FileConsumer({"path": str(out), "format": "v210"})
        await cons.initialise(TINY)
        n = cons.DEPTH + 8
        for i in range(n):
            await cons.deliver(_frame(i))
        cons.release()
        assert cons.leaked_threads == 0
        assert cons.written == n
        fbytes = get_format("v210").num_bytes(96, 64)[0]
        data = out.read_bytes()
        assert len(data) == n * fbytes
        for i in (0, n - 1):
            ref = _frame(i).packed[0].numpy().tobytes()
            assert data[i * fbytes:(i + 1) * fbytes] == ref

    run(main())


def test_release_rescues_spinning_fetch_via_stop_event(tmp_path):
    """A fetch thread spinning on a full ring is rescued by release's stop
    event inside the grace join — clean close, nothing leaked."""

    async def main():
        cons = tfile.FileConsumer({"path": str(tmp_path / "out.v210"), "format": "v210", "join_fetch_s": 0.3})
        await cons.initialise(TINY)
        cons._ring.try_write = lambda data: False  # the ring stays full
        await cons.deliver(_frame(0))
        cons.release()
        assert cons.leaked_threads == 0
        assert cons._fh is None
        assert cons._ring is None  # clean close ran
        cons.release()  # idempotent

    run(main())


def test_release_abandons_wedged_fetch_without_corruption(tmp_path):
    """A fetch thread blocked past its join budget is abandoned — ring and
    file handles leaked to it, consumer marked closed — and never has the
    ring closed under it."""

    async def main():
        cons = tfile.FileConsumer({"path": str(tmp_path / "out.v210"), "format": "v210", "join_fetch_s": 0.3})
        await cons.initialise(TINY)
        wedge = threading.Event()

        def blocked_write(data):
            wedge.wait(60)
            return False  # then the loop observes _stop and exits

        cons._ring.try_write = blocked_write
        await cons.deliver(_frame(0))
        fetch = cons._threads[0]
        cons.release()
        assert cons.leaked_threads >= 1
        assert cons._fh is None
        assert cons._ring is not None
        cons.release()
        wedge.set()
        fetch.join(timeout=5)
        assert not fetch.is_alive()

    run(main())


# ---- the preview consumer

def test_preview_body_and_wav_header_equal_jax():
    """The same frame to both previews: GET / gives equal rgba8 (sRGB)
    bodies and headers, /audio.wav equal headers and PCM."""
    rng = np.random.default_rng(7)
    rgba = rng.random((4, 64, 96), dtype=np.float32)
    t = np.arange(960, dtype=np.float32)
    tone = 0.5 * np.sin(2 * np.pi * 440 * t / 48000)
    audio = np.stack([tone, -tone]).astype(np.float32)

    async def get(port, path, n):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
        await w.drain()
        head = await r.readuntil(b"\r\n\r\n")
        body = await asyncio.wait_for(r.readexactly(n), 10)
        w.close()
        return head, body

    async def serve(jax_side):
        if jax_side:
            import jax.numpy as jnp

            cons, frame_rgba = jpreview.PreviewConsumer({"port": 0}), jnp.asarray(rgba)
            fmt = jconfig.VideoFormat(*FMTS["tiny"])
        else:
            cons, frame_rgba, fmt = tpreview.PreviewConsumer({"port": 0}), torch.from_numpy(rgba), TINY
        await cons.initialise(fmt)
        port = cons._server.sockets[0].getsockname()[1]
        frame = ChannelFrame(timestamp=0, packed=None, rgba=frame_rgba, audio=audio)
        await cons.deliver(frame)
        await cons._task
        out = [await get(port, "/", 96 * 64 * 4)]
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(b"GET /audio.wav HTTP/1.1\r\n\r\n")
        await w.drain()
        head = await r.readuntil(b"\r\n\r\n")
        await asyncio.sleep(0.05)  # the listener is registered
        await cons.deliver(ChannelFrame(timestamp=1, packed=None, rgba=frame_rgba, audio=audio))
        await cons._task
        out.append((head, await asyncio.wait_for(r.readexactly(44 + 960 * 4), 10)))
        w.close()
        cons.release()
        return out

    jax_out, port_out = run(serve(True)), run(serve(False))
    assert port_out == jax_out
    assert b"200 OK" in port_out[0][0] and port_out[1][1][:4] == b"RIFF"


def test_mjpeg_stream_sends_jpeg_parts_of_the_frame():
    pytest.importorskip("PIL")
    from PIL import Image

    from phaneron_tpu_torch.consumer.mjpeg_consumer import BOUNDARY, MJPEGConsumer
    from phaneron_tpu_torch.graph.pipeline import make_pack_program

    ramp = np.linspace(0.0, 1.0, 96, dtype=np.float32)
    rgba = torch.from_numpy(np.stack([np.broadcast_to(ramp, (64, 96)), np.broadcast_to(ramp[::-1], (64, 96)),
                                      np.full((64, 96), 0.3, np.float32), np.ones((64, 96), np.float32)]).copy())

    async def main():
        cons = MJPEGConsumer({"port": 0, "quality": 95})
        await cons.initialise(TINY)
        r, w = await asyncio.open_connection("127.0.0.1", cons.port)
        w.write(b"GET / HTTP/1.1\r\n\r\n")
        await w.drain()
        head = await r.readuntil(b"\r\n\r\n")
        while not cons._clients:
            await asyncio.sleep(0.01)
        await cons.deliver(ChannelFrame(timestamp=0, packed=None, rgba=rgba, audio=np.zeros((2, 960), np.float32)))
        await cons._task
        part_head = await r.readuntil(b"\r\n\r\n")
        n = int(part_head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        jpeg = await r.readexactly(n)
        w.close()
        cons.release()
        return head, part_head, jpeg

    head, part_head, jpeg = run(main())
    assert b"multipart/x-mixed-replace; boundary=" + BOUNDARY in head
    assert part_head.startswith(b"--" + BOUNDARY + b"\r\nContent-Type: image/jpeg\r\n")
    img = np.asarray(Image.open(io.BytesIO(jpeg)))
    ref = make_pack_program("rgba8", 96, 64, "sRGB")(rgba)[0].numpy()[..., :3]
    assert img.shape == (64, 96, 3)
    assert np.abs(img.astype(int) - ref).mean() < 8  # JPEG at quality 95


# ---- the raw-file producer

def _clip(tmp_path, n: int = 6):
    from phaneron_tpu_torch.ops.formats import v210

    frames = []
    for k in range(n):
        words = np.roll(v210.fill_buf(96, 64)[0], 4 * k, axis=1)  # a distinct in-gamut ramp a frame
        frames.append(words.tobytes())
    clip = tmp_path / "clip.96x64.v210"
    clip.write_bytes(b"".join(frames))
    return clip


@pytest.mark.parametrize("seek,length,loop", [(0, None, True), (2, 3, False), (4, None, True)])
def test_raw_file_playback_equals_jax(tmp_path, seek, length, loop):
    """A clip played with SEEK / LENGTH / LOOP, with a CALL SEEK at tick 5:
    each tick's packed frame equals JAX's."""
    clip = _clip(tmp_path)

    async def play(jax_side):
        ch, LoadParams, _, _, words = _side(jax_side, "tiny")
        assert await ch.load_source(1, LoadParams(str(clip), loop=loop, seek=seek, length=length))
        assert ch.play(1)
        out = []
        for t in range(10):
            if t == 5:
                assert ch.layers[1].cur.producer.seek(1)  # CALL 1-1 SEEK 1
            out.append(words((await ch.render_frame()).packed[0]))
        await ch.shutdown()
        return out

    jax_frames, port_frames = run(play(True)), run(play(False))
    for j, t in zip(jax_frames, port_frames):
        assert max_code_delta(j, t, 96, 64) == 0
        assert np.array_equal(j, t)
    assert len({f.tobytes() for f in port_frames}) > 2  # the clip's frames, not one


def test_raw_file_plays_back_the_file_consumers_interlaced_output(tmp_path):
    """The file consumer's interlaced recording (with its sidecar) plays
    back through the raw-file producer on an interlaced channel as JAX
    plays it."""
    # full-frame content: on boxes' edges JAX's XLA yadif (the CPU's) and
    # its Pallas kernel, which the port's pair follows, differ (ROADMAP C2)
    run(_record(False, "tiny_i", tmp_path / "rec", 16, box=False))
    clip = tmp_path / "rec" / "out.v210"

    async def play(jax_side):
        ch, LoadParams, _, _, words = _side(jax_side, "tiny_i")
        assert await ch.load_source(1, LoadParams(str(clip)))
        assert ch.play(1)
        out = [words((await ch.render_frame()).packed[0]) for _ in range(12)]
        await ch.shutdown()
        return out

    jax_frames, port_frames = run(play(True)), run(play(False))
    for j, t in zip(jax_frames, port_frames):
        assert max_code_delta(j, t, 256, 64) == 0


# ---- ROUTE

def test_route_channel_equals_its_source(tmp_path):
    """route://1 on channel 2 (its rgba frames through the tap) gives
    channel 1's packed frames (a clip of distinct frames under a DVE box),
    a fixed number of ticks later."""
    clip = _clip(tmp_path)

    async def main():
        channels = {}
        reg = tproducer.ProducerRegistry([make_route_factory(channels.get), tpattern.create_test_pattern_producer,
                                          traw.create_raw_file_producer])
        for n in (1, 2):
            channels[n] = tchannel.Channel(n, TINY, reg, device="cpu")
        assert await channels[1].load_source(1, tproducer.LoadParams(str(clip), loop=True)) and channels[1].play(1)
        assert channels[1].layer(1).set_fill(*BOX)
        assert await channels[2].load_source(1, tproducer.LoadParams("route://1")) and channels[2].play(1)
        src, routed = [], []
        for _ in range(12):
            src.append(words_to_numpy((await channels[1].render_frame()).packed[0]))
            routed.append(words_to_numpy((await channels[2].render_frame()).packed[0]))
        for ch in channels.values():
            await ch.shutdown()
        return src, routed

    src, routed = run(main())
    assert len({f.tobytes() for f in src[:6]}) == 6  # a distinct frame a tick
    delays = [d for d in range(3) if all(np.array_equal(routed[k], src[k - d]) for k in range(3, 12))]
    assert len(delays) == 1, delays
