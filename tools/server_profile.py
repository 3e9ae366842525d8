#!/usr/bin/env python3
"""Where the server's event loop goes, consumer by consumer (on the card).

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/server_profile.py [--seconds 3] [--periods 8] [--ingest-only]

Starts ``PhaneronServer`` on configs/quad_1080i_1chip.json (as
chip_smoke.py's server phase does: file paths and ports changed in
memory) once for each set of consumers — none, the two file consumers,
the preview, the MJPEG stream (with a client reading it), all four —
builds four BARS boxes a channel over AMCP, and runs paced.  For each it
prints every channel's ticks and late_frames in the window, render p50
host ms, and the event loop's lag (a 5 ms sleep's overshoot, p50 / p99 /
max).  Before that it times what a consumer's host work costs the loop:
pinning a 1080i v210 frame's host buffer, and a 1080p JPEG encode with
Pillow on a thread (the main thread's longest 1 ms sleep meanwhile shows
whether the encode holds the GIL) and through utils/jpeg.py's encoder
process.  Then the cluster ingest: the MJPEG stream of channel 4 (four
BARS boxes) played by channel 2 (``PLAY 2-1 http://...``, the MJPEG
producer), once with each part decoded in the producer's codec process
(utils/jpeg.py, as shipped) and once with Pillow decoding on the loader
thread, the loop's lag probed the same way.  Last, with every consumer
attached and the paced loops stopped, it profiles server periods (each channel's two ticks,
render_frame and deliver, with the consumers' drains) under
torch.profiler (tools/port_profile.py ``profile``): device busy, kernels
by name, and the port tracer's spans — host and device ms of
``layer.poll``, ``channel.dispatch`` and the frame program's stages, and
of each channel's ``consumer.deliver`` (the consumer each channel has is
printed first).  The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import asyncio
import io
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import port_profile as pp  # noqa: E402

SETS = {"none": set(), "file": {"file"}, "screen": {"screen"}, "mjpeg": {"mjpeg"},
        "all": {"file", "screen", "mjpeg"}}


def host_costs(torch) -> None:
    from phaneron_tpu_torch.utils import hostio
    from phaneron_tpu_torch.utils.jpeg import JpegProcess

    t0 = time.perf_counter()
    for _ in range(4):
        hostio.host_buffer(5_529_600, torch.device("cuda", 0))
    print(f"pinned host buffer, 5,529,600 bytes: {(time.perf_counter() - t0) / 4 * 1e3:.3f} ms each")
    rgba = (np.random.default_rng(0).random((1080, 1920, 4)) * 255).astype(np.uint8)

    def stall(encode) -> tuple:
        done = threading.Event()

        def work():
            for _ in range(10):
                encode()
            done.set()

        t = threading.Thread(target=work)
        t0 = time.perf_counter()
        t.start()
        sleeps = []
        while not done.is_set():
            a = time.perf_counter()
            time.sleep(0.001)
            sleeps.append(time.perf_counter() - a)
        t.join()
        return (time.perf_counter() - t0) / 10 * 1e3, max(sleeps) * 1e3

    def pillow():
        from PIL import Image

        Image.fromarray(np.ascontiguousarray(rgba[:, :, :3]), "RGB").save(io.BytesIO(), "JPEG", quality=85)

    encoder = JpegProcess()
    encoder.encode(rgba, 1920, 1080, 85)  # start the process
    for name, fn in (("Pillow on a thread", pillow),
                     ("utils/jpeg.py process", lambda: encoder.encode(rgba, 1920, 1080, 85))):
        ms, worst = stall(fn)
        print(f"1080p JPEG, {name}: {ms:.3f} ms a frame; the main thread's longest 1 ms sleep meanwhile "
              f"{worst:.3f} ms")
    encoder.close()


async def start_set(name: str, out_dir: str, mjpeg_parts: list):
    """A started server on the default config with the consumers of
    ``name``, four BARS boxes a channel built over AMCP, warm."""
    from phaneron_tpu_torch.server import PhaneronServer

    cfg = cs.server_config(out_dir)
    for cc in cfg.channels:
        if cc.device["name"] not in SETS[name]:
            cc.device = {}
    server = PhaneronServer(cfg)
    await server.start()
    amcp = cs.AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
    for (c, i), box in cs.server_boxes(len(server.channels)).items():
        await amcp.call(f"PLAY {c}-{i} BARS", ["202 PLAY OK"])
        await amcp.call(f"MIXER {c}-{i} FILL " + " ".join(map(str, box)), ["202 MIXER OK"])
    await amcp.close()
    for ch in server.channels.values():
        await ch.wait_prewarmed()
    reader = None
    if "mjpeg" in SETS[name]:
        reader = asyncio.create_task(cs.mjpeg_reader(server.channels[4].consumers[0].port, mjpeg_parts))
    await asyncio.sleep(1.5)  # past the structures' first frames
    return server, reader


async def stop_set(server, reader) -> None:
    if reader is not None:
        reader.cancel()
        await asyncio.gather(reader, return_exceptions=True)
    await cs.stop_paced(server)
    await server.shutdown()


async def paced_window(server, seconds: float) -> str:
    """Every channel's ticks, late_frames and render p50 and the loop's lag
    (a 5 ms sleep's overshoot) over ``seconds`` of the running server."""
    lags = []

    async def probe():
        while True:
            a = time.perf_counter()
            await asyncio.sleep(0.005)
            lags.append(time.perf_counter() - a - 0.005)

    probe_task = asyncio.create_task(probe())
    from phaneron_tpu_torch.utils.metrics import tracer

    before = {n: (ch.timestamp, ch.clock.late_frames) for n, ch in server.channels.items()}
    tracer.reset()  # the server started it: render p50 of the window's ticks
    t0 = time.perf_counter()
    await asyncio.sleep(seconds)
    window = time.perf_counter() - t0
    probe_task.cancel()
    rows = [f"ch{n} {ch.timestamp - before[n][0]} ticks, {ch.clock.late_frames - before[n][1]} late, "
            f"render p50 {ch.stats()['render_p50_ms']:.4f} ms" for n, ch in server.channels.items()]
    lag_ms = [x * 1e3 for x in lags]
    return (f"{window:.3f} s window; " + "; ".join(rows) + f"; loop lag p50 "
            f"{cs.percentile(lag_ms, 50):.4f} p99 {cs.percentile(lag_ms, 99):.4f} max "
            f"{max(lag_ms, default=float('nan')):.4f} ms ({len(lag_ms)} probes)")


async def run_set(name: str, out_dir: str, seconds: float) -> None:
    server, reader = await start_set(name, out_dir, [])
    print(f"consumers {name}: " + await paced_window(server, seconds))
    await stop_set(server, reader)


class ThreadDecode:
    """The MJPEG producer's codec, decoding with Pillow on the calling
    (loader) thread: what the JAX package's producer does."""

    def start(self) -> None:
        pass

    def decode(self, data, width: int, height: int, mode: int, out) -> bool:
        from phaneron_tpu_torch.utils.jpeg import decode_rgba

        out[:] = np.frombuffer(decode_rgba(data, width, height, mode), np.uint8)
        return True

    def close(self) -> None:
        pass


async def run_ingest(decode: str, out_dir: str, seconds: float) -> None:
    """Channel 4's MJPEG stream ingested by channel 2, its parts decoded
    in the codec process ('process') or on the loader thread ('thread')."""
    server, reader = await start_set("mjpeg", out_dir, [])
    producer = None
    try:
        amcp = cs.AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
        port = server.channels[4].consumers[0].port
        await amcp.call(f"PLAY 2-1 http://127.0.0.1:{port}/", ["202 PLAY OK"])
        await amcp.close()
        producer = server.channels[2].layers[1].cur.producer
        if decode == "thread":
            producer._codec.close()
            producer._codec = ThreadDecode()
        await asyncio.sleep(1.0)  # past the first parts
        slot = server.channels[2].layers[1].cur
        seen = slot.frames_seen
        line = await paced_window(server, seconds)
        print(f"mjpeg ingest, decode on the {decode}: {slot.frames_seen - seen} parts ingested; {line}")
    finally:
        # channel 2's tick waits for its next part: its loop ends while
        # channel 4 still streams, then the others
        server.channels[2].running = False
        await asyncio.wait_for(server.channels[2]._task, 30)
        await stop_set(server, reader)


def profile_period(torch, card: str, out_dir: str, periods: int) -> None:
    """Server periods with every consumer, the paced loops stopped, under
    torch.profiler with the tracer's spans recorded."""
    loop = asyncio.new_event_loop()
    server, reader = loop.run_until_complete(start_set("all", out_dir, []))
    loop.run_until_complete(cs.stop_paced(server))
    print("consumers: " + ", ".join(f"channel {n} {server.config.channels[n - 1].device.get('name')}"
                                    for n in server.channels))
    chans = list(server.channels.values())

    def period():
        for _ in (0, 1):
            for ch in chans:
                loop.run_until_complete(cs.server_tick(ch))
        loop.run_until_complete(asyncio.sleep(0))  # the preview and MJPEG drains take their step

    pp.profile(torch, "server: 4 x 1080i50 channels with file, file, preview and MJPEG consumers, "
                      "one frame period", period, periods, card, spans=True)
    loop.run_until_complete(stop_set(server, reader))
    pending = asyncio.all_tasks(loop)
    for task in pending:  # the streams' pumps and the last drains end with the server
        task.cancel()
    loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
    loop.close()


def main(torch, seconds: float, periods: int, ingest_only: bool = False) -> None:
    out_dir = tempfile.mkdtemp(prefix="phaneron_server_profile_")
    if not ingest_only:
        for name in SETS:
            asyncio.run(run_set(name, out_dir, seconds))
    for decode in ("process", "thread", "thread", "process"):
        asyncio.run(run_ingest(decode, out_dir, seconds))
    if not ingest_only:
        profile_period(torch, cs.card_line(), out_dir, periods)


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        sys.exit("server_profile: needs a CUDA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--periods", type=int, default=8)
    ap.add_argument("--ingest-only", action="store_true", help="only the MJPEG ingest's two decode placements")
    args = ap.parse_args()
    print(cs.card_line())
    if not args.ingest_only:
        host_costs(torch)
    main(torch, args.seconds, args.periods, args.ingest_only)
