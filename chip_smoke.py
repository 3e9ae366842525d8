#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Exits 1 unless CUDA is available; prints the card's name and power
   limit (nvidia-smi) and the torch / CUDA versions.
2. Builds the kernels from phaneron_tpu_torch/csrc (nvcc, sm_90a; one
   nvcc per source, all started together) and prints the build seconds
   and ptxas's register counts.
3. Compares each kernel with its plain PyTorch version on the card, at
   the 1080p shapes of the main paths, on seeded random words over the
   full 10-bit code range and on the formats' fill_buf ramps:
   v210_unpack (4 and 3 channels) and planar422_unpack exactly (both
   gather gamma'->linear from one table), v210_pack <= 1 code on random
   inputs and pack(unpack(fill_buf)) == fill_buf bit-exact (also at
   widths with a pitch pad), warp (4 and 3 channels, single and pair)
   <= 5e-5, yadif_ring and yadif_pair on seeded random opaque rings (C 3
   and 4, opaque, tff and bff, with and without skip_spatial, both
   parities read from device memory; at 1920x1080, 1920x1081 and
   1918x1080, every ring of 1-5 rows by 1-7 columns, and 31-33 and 63-65
   rows by 63-66 columns, the staged tiles' edges) max |delta| == 0,
   packed_composite over (3, H, W)
   frames (the interlaced tick; emits packed, rgba and both) 0 codes and
   max |delta| 0; then, to <= 1 code (expected 0), packed_composite over
   v210 words, fused_v210 (cut and dissolve at mixes 0, 0.35, 0.37 and
   1, at 1920x1080, 3840x2160, 1918x1080, 1280x720, 1280x16, 200x7 and
   every width 1-13 at 3 rows; the cut also == K1 + K2 on the card),
   combine_pack (4-channel and (rgb, wy, wx) layers) and packed_warp
   (single, shared-matrix pair, distinct-matrix pair, max |delta| 0), and
   each fused kernel's delta against the staged kernels it replaces (a
   record; combine_pack's == combine_rgb + K2 on the card, checked); then
   K2 and B5 swept at widths 1-13 (3 rows), 200x7 and 1918x8 (K2 on
   random RGB(A) and the decoded ramps, C 4 and 3, the round trips of
   even widths bit-exact; B5 with 1, 2 and 8 layers alternating RGBA and
   (rgb, wy, wx) layers, also == combine_rgb + K2; both with every frame
   one float off its 16-byte alignment at 200 and 1918, the kernel's
   4-byte copies) <= 1 code from their plain versions; then the
   straggler modes: rotate (single, dissolve and wipe
   pairs under one matrix or two, C 4 and 3, at 25, 100 and -7 degrees)
   and K4's wipe and distinct-matrix pairs <= 5e-5, packed_composite's
   rgba and both emits (v210 words and rgb3) <= 2e-4 and <= 1 code; then
   packed_composite's shared-memory windows at their edges, over v210
   words and over rgb3 frames (flips, minifying boxes at scale 0.5 and
   0.25, offsets past the frame edge, 1918 wide; emits packed, both and
   rgba; v210: 0 codes and max |delta| 0 expected, rgb3: held to 0), with
   the (tile, source) pairs each took on the window and direct branches
   (the 0.25 box must reach the direct branch, the flips and the
   progressive matrices must stay on the window); then rotate's
   shared-memory windows at their edges (single, dissolve and wipe pairs
   under one matrix or two, C 3 and 4, at 0, 45, 90, 100, 180 and 270
   degrees, scales 0.25, 0.9 and 2 and two offsets past the frame, at 1x1,
   7x5, 1918x1081, 1917x1079 and 3840x2160: max |delta| 0), each launch's
   window/direct (tile, source) counts equal to ops/rotate.py
   window_counts' and both branches taken; then K4 and B6's decoded
   windows at their edges (K4 single, dissolve and wipe pairs under one
   matrix or two, C 3 and 4; B6 single, shared-matrix and distinct-matrix
   pairs; flips, the media picture in picture, minifying boxes at scale
   0.25 and 0.3 that reach B6's direct branch, a magnifying box, offsets
   that put whole tiles off the frame; at 1x1 to 13x7, 1280x720,
   1918x1080, 1920x1080 and 3840x2160: max |delta| 0), each B6 launch's
   window/direct counts equal to ops/packed_warp.py warp_window_counts',
   both branches taken; then
   the planar kernels of the file-media formats at 1920x1080, 1918x1080
   (a pitch pad) and 1920x1081 (an odd height), on seeded full-range
   random planes (10-bit codes in [0, 1023]) and the fill_buf ramps:
   planar422_unpack at 10 bit (B10), planar420_unpack (B12, yuv420p and
   nv12) max |delta| 0; planar422_pack (B11, 8 and 10 bit) and
   planar420_pack (B13, yuv420p and nv12) <= 1 code on random RGBA (C 4
   and 3) and pack(unpack(fill_buf)) == fill_buf bit-exact, pad included;
   the planar unpacks and packs swept from 1x1 to 3840x2160 (partial
   quads, a width not a multiple of 4, odd heights; C 3 and 4 into the
   packs, random and ramps; each plane, or the RGB frame, one sample off
   its alignment at two sizes), the unpacks max |delta| 0, the packs'
   max code delta printed (<= 1, expected 0); rgb8_unpack (rgba8 and
   bgra8) at 3840x2160, 1920x1080, 1917x1079, 130x7 and 5x3 on random
   planes, under the analytic 709 transfer and the sRGB LUT, each plane
   also 4 bytes off its alignment, max |delta| 0 and one launch a call;
   and the stage programs of every format against their plain versions:
   make_unpack_program at channels 3 and 4 (max |delta| 0),
   make_pack_program, make_interlaced_pack_program("yuv420p") and
   make_interlaced_word_pack_program("yuv422p10le") (<= 1 code); then
   packed_composite's whole-stack and RGBA modes: over (4, H, W)
   premultiplied RGBA frames (the rgba kind, B16's counterpart) with
   coverage and top alpha, emits rgba, both and packed, and over v210
   words with top alpha (B15's), emits rgba and both (<= 2e-4 and <= 1
   code, expected 0).
4. Drives each main path through make_channel_program (or the stage
   programs), every launch count set to 0 just before and read just
   after, each frame's words <= 1 code from the plain path on the card;
   the packed composite's launches are also split by mode (source kind,
   emit, alpha) from the frame program's calls that raised its count, and
   the pipeline's torch combine and alpha fix-up calls are counted, and
   no frame may build fused_v210's transfer corrections or the packs'
   l2g corrections:
   - entry: the entry() structure (a v210 dissolve with an axis-aligned
     DVE under a yuv422p8 layer) at 1920x1080 over 50 frames, mix
     ramping 0 -> 1 and the DVE scale animating 0.90 -> 1.0: one
     packed_warp, planar422_unpack and combine_pack launch a frame; the
     l2g corrections are dropped first and the program's prepare(),
     called twice, must build them once (the straggler and keyed
     programs' prepare() is called before their frames too);
   - progressive: bench.py composite_step (4 DVE + dissolve layers, a
     matrix each, 8 distinct v210 sources: rolled fill_buf ramps and
     seeded random words, mixes animating) at 3840x2160 and 1920x1080:
     exactly one packed_composite launch a frame and no v210_unpack,
     warp, combine_pack, v210_pack or packed_warp;
   - playout: one v210 clip as a cut, and a dissolve between two clips
     with the mix animating, at 1920x1080 and 3840x2160, the program's
     prepare() called first: one fused_v210 launch a frame;
   - stage_programs: the producer unpack and consumer pack stage programs
     round-trip the fill_buf ramp bit for bit (v210_unpack, v210_pack);
   - interlaced: the default load, four 1080i50 channels as bench.py
     interlaced_channels_step: per channel 8 distinct seeded v210 sources
     and 4 DVE + dissolve layers (a distinct axis-aligned matrix per
     layer, mix animating), over 8 frame periods, each: unpack the new
     frame of every source to 3 channels, advance its ring, one
     make_yadif_pair_field_program call per source, two channel-program
     ticks (each one packed_composite launch), one
     make_interlaced_word_pack_program;
   - ring_route: the in-program ring route (deinterlace=True layers over
     the same rings, parity on the card) for the two ticks of one
     channel: it must equal the pair route bit for bit; its device ms a
     tick (8 yadif_ring + 1 packed_composite, a CUDA graph replayed);
   - straggler channels (bench.py composite_variant_step): 3 DVE +
     dissolve layers under a one_rotation or wipe top layer at 3840x2160
     and 1920x1080 (1 v210_unpack, 1 packed_composite emitting rgba, 1
     rotate or warp, 1 combine_pack a frame), a rotated distinct-matrix
     dissolve at 1080p, and two emit_rgba channels at 1080p (the
     progressive frame: 1 packed_composite emitting both with the top
     layer's alpha, no torch combine or fix-up; one_rotation: the torch
     combine and 1 v210_pack), whose rgba frame must be within 2e-4 of
     the plain path's and carry the top layer's alpha;
   - media: the file-media channel at 1920x1080 and 3840x2160, 8 frames
     each, its dissolve's mix animating 0 -> 1: a yuv422p10le clip (cut),
     a yuv420p clip under a picture-in-picture DVE dissolving to an nv12
     clip under the same matrix, a keyed rgba8 lower third; yuv422p10le
     out with emit_rgba, the rgba frame packed by the preview (rgba8,
     sRGB) and file (nv12) consumer stage programs; at 1080p the l2g
     corrections are dropped first and the program's prepare(), called
     twice, must build them once.  A frame: 1
     planar422_unpack (10 bit), 2 planar420_unpack, 1 rgb8_unpack, 1 warp
     pair, torch ops for the combine, 1 planar422_pack, then 1
     planar420_pack and the rgba8 pack in torch ops; every plane <= 1 code
     from the plain path's, the rgba frame within 2e-4 with the graphic's
     alpha;
   - multibox: the file-media quad split (MIXER 1-n FILL over file clips),
     8 frames at 1920x1080 and 3840x2160 into v210 with emit_rgba (SDI and
     a ROUTE tap) and at 1920x1080 into yuv422p10le (a file record), the
     dissolve's mix animating 0 -> 1: three boxes at scale 0.5 in three
     quadrants (a yuv422p10le clip; a 1280x720 yuv420p clip, src_size,
     dissolving to a 1280x720 nv12 clip; an nv12 clip) under the keyed
     rgba8 graphic at title-safe scale 0.95.  A frame: 1 planar422_unpack
     (10 bit), 3 planar420_unpack, 1 rgb8_unpack, torch ops for the two
     resizes, 1 packed_composite (rgba kind, top alpha; emit both
     into v210, rgba then 1 planar422_pack into yuv422p10le); no warp,
     combine_pack, v210_pack or torch combine;
   - progressive_yuv422p10le: the progressive 4-layer frame at 1920x1080
     into yuv422p10le: 1 packed_composite (v210 words, emit rgba, top
     alpha) and 1 planar422_pack a frame;
   - keyed_straggler: the keyed rgba8 graphic over two yuv422p8 -> nv12
     boxes over a rotated v210 clip, 1920x1080 into v210 with emit_rgba,
     the boxes' mixes animating 0 -> 1.  A frame: 1 v210_unpack, 1 rotate,
     2 planar422_unpack, 2 planar420_unpack, 1 rgb8_unpack, 1
     packed_composite over the boxes (rgba kind, emit rgba, coverage alpha), 1 warp for the graphic,
     which stays staged, the torch combine and 1 v210_pack; the rgba
     frame carries the graphic's own warped alpha;
   - runtime (``phase_runtime``): port Channels (runtime/channel.py) with
     test-pattern sources (packed on the card at load by K2 and B11), a
     kernel set against a plain=True set, frames through render_frame,
     each delivered to a recording Consumer: the default load
     (configs/quad_1080i_1chip.json, four 1080i50 channels, each four
     layers dissolving BARS -> RAMP under bench.py's interlaced boxes,
     the consumer pairing the field ticks), 3 steady periods after the
     rings fill, each 32 v210_unpack, 32 yadif_pair and 8 packed_composite
     (rgb3, packed, top) as the stage-driven period, frames and paired
     words <= 1 code from the plain set; a 1080p50 playout channel (a MIX
     between two v210 patterns, one fused_v210 a tick) and an entry()
     channel (a v210 DVE dissolve under a yuv422p8 pattern, one
     packed_warp, planar422_unpack and combine_pack a tick), 4 ticks each;
     a warm period (tick) of every kernel channel under
     torch.cuda.set_sync_debug_mode("error"); the runtime period timed in
     turns with the stage-driven one; then the four 1080i50 kernel
     channels under Channel.run for PACED_SECONDS: every rendered tick
     delivered, one packed_composite a tick, each channel's frames,
     late_frames and render p50 / p99 (host ms) printed;
   - server (``phase_server``): PhaneronServer (server.py) on
     configs/quad_1080i_1chip.json through ServerConfig.load, its file
     paths and ports changed in memory only (two file consumers, a
     preview, an MJPEG stream; AMCP and OSC on ports the OS picks).  Over
     TCP: PLAY n-i BARS and MIXER n-i FILL (bench.py's boxes) on four
     layers of each channel, LOADBG 1-1 RAMP MIX 50 and PLAY 1-1, then,
     once the dissolve has ended, MIXER 1-1 FILL for the RAMP, INFO,
     INFO 1, REQ tokens, VERSION and ADD 2 DECKLINK (400: not ported),
     every response line checked and each round trip timed; an MJPEG
     client reads the stream; SERVER_PACED_SECONDS paced, with an INFO
     every 100 ms: each channel's ticks, late_frames, render p50 / p99
     host ms, the file consumers' frames written and MB/s, the AMCP round
     trip p50 / p99, and every rendered tick delivered.  Then, the loops
     stopped, 3 steady periods counted (16 v210_unpack, 16 yadif_pair,
     8 packed_composite rgb3 a period: 'packed' on the file channels,
     'both' on the preview and MJPEG ones), a warm period under
     torch.cuda.set_sync_debug_mode("error") with every consumer
     attached, the last written interlaced frame of channels 1 and 2 0
     codes from a plain=True twin (given the same commands through the
     control plane, each source PLAYed with SEEK to the server source's
     last frame at its field parity), the preview's GET / body <= 1
     code from the twin's rgba8 pack, the MJPEG part headers (where PIL
     imports); and a second session that PLAYs channel 1's recording
     back through the raw-file producer, its last written frame 0 codes
     from a plain channel playing it; and a third on
     configs/quad_1080i_2chip.json, whose channels name chips 0 and 1:
     each placed on cuda:(chip % device count), as the JAX server wraps
     it (all four on cuda:0 with one card), PLAY n-1 BARS, every rendered
     tick delivered;
   - media I/O (``phase_media_io``), at 1920x1080, each against a plain
     twin given the same commands: the SDI loop (a 1080i50 Channel, PLAY
     1-1 DECKLINK DEVICE 1 over the port's control plane, a fake capture
     card registered with set_capture_backend serving
     utils/fixtures.write_interlaced_v210's clip and its PCM, an
     SDIConsumer over a virtual-clock playout card; 1 v210_unpack, 1
     yadif_pair and 2 combine_pack a period; every displayed frame 0
     codes from the twin's, the captured frames in order with their field
     markers, the captured s32 audio, late_frames 0); the file media
     through the server's AMCP on the default config (a v210 AVI, an MJPG
     AVI, a keyed PNG sequence over BARS, a WAV bed, one a channel; 3
     v210_unpack, 1 yadif_pair, 2 fused_v210, 4 v210_pack, 2
     combine_pack and 4 rgb8_unpack (none without Pillow) a period; every frame 0 codes from the twins, the WAV's
     samples equal); the cluster ingest (channel 4's MJPEG stream played
     by channel 2 over HTTP, paced: each checked part equal to the plain
     decode of its JPEG, the event loop's lag); the ffmpeg pair over stub
     binaries at the front of PATH (a 1080p50 Channel, a yuv422p10le
     source and a yuv420p box: 1 planar422_unpack, 1 planar420_unpack, 1
     warp, 1 v210_pack and the ffmpeg consumer's planar422_pack a tick;
     frames 0 codes, the consumer's rawvideo equal to the twin's packs);
     the loaders' host ms and MB/s.  The MJPG AVI, the PNG sequence and
     the ingest need Pillow and print "skipped" without it.
5. Times, with CUDA events after warm-up, the median ms per frame (or
   period) of each path, kernel and plain (batches of back-to-back
   frames), the progressive frame also on the staged K1 (3 ch) + K5
   (rgb3) route, and each frame's latency with the card idle before and
   after; then each kernel against its plain version at a main path's
   shapes (the kernel's and the library call's device time: calls
   captured into a CUDA graph and replayed between events; the plain
   version's eagerly), K4 and rotate also against
   torch.nn.functional.grid_sample on the same frames; packed_composite
   also in each whole-stack and rgba mode at a main path's shapes; K1,
   K5 over v210 words and fused_v210 (the UHD dissolve) also on the rolled
   fill_buf ramps (coherent content, beside the random words); K2 at
   3840x2160 (C 3 and 4) and on the one_rotation emit_rgba and keyed
   paths' frames, B5 on the mixed 4-layer stack and the one_rotation and
   wipe paths' 2-layer stacks at both sizes (v210_pack_inputs);
   rgb8_unpack on the media channel's graphic at 1920x1080 (its record)
   and 3840x2160; rotate also at 0 degrees; K4 also at the media picture in picture and the UHD
   wipe frame's shape, B6 under two matrices; and packed_composite's,
   rotate's and B6's window/direct counts at every timed shape (for B6
   the entry pair, alone and under two matrices), none of which may leave
   the window.

Prints one JSON line of per-kernel records (bound_ms: the least bytes
the function must move over 3.35 TB/s, or its float32 operations,
counted from the kernel's source, over 67 TFLOP/s, whichever is larger;
"modes": the kernel's other timed shapes and modes),
then, as the last line, {"ok": true, "device": {...}}.  Any failed phase
raises and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H = 1920, 1080
UHD_W, UHD_H = 3840, 2160
FRAMES = 50  # entry path frames
PROG_FRAMES = 4  # progressive frames per geometry
PLAYOUT_FRAMES = 8  # playout frames per geometry and transition
SEED = 1234

TOL_UNPACK = 0.0  # kernel and plain version gather gamma'->linear from one table
TOL_WARP = 5e-5
TOL_CODES = 1

# interlaced default load (bench.py interlaced_channels_step)
N_CHANNELS = 4
N_SOURCES = 8  # per channel: 4 dissolve layers
PERIODS = 8  # frame periods driven and checked (two 20 ms field ticks each)
PERIOD_MS = 40.0  # 1080i50
TFF = True
ROW_STEP = 3  # rows each source moves per period

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float32 operations per element, counted from csrc/: one each for add,
# subtract, multiply, divide, abs, min, max, floor, rint and powf;
# compares and selects are not counted
OPS_G2L = 4  # phn::g2l: scale, rint, max, min (the table gather is a load)
OPS_L2G = 8  # phn::l2g: scale, rint, max, min, scale, then offset, scale, powf
OPS_DECODE_PX = 3 * 6 + 3 * OPS_G2L + 3 * 5  # 3x4 matrix, transfers, 3x3 gamut
OPS_RGB8_DECODE_PX = 3 * 5  # rgb8_unpack: the 3x3 gamut (the transfer is a gather)
OPS_ENCODE_PX = 3 * OPS_L2G + 9 + 9  # transfers, luma row, two chroma rows every other pixel
OPS_WARP_PX = 18  # per output pixel and matrix: ix, iy, px, py, floor and fraction
OPS_WARP_SAMPLE = 12  # sample(): three lerps
OPS_MIX = 4  # v * mix + vb * (1 - mix)
OPS_ALPHA = 6  # packed composite: wy, wx, 1 - wy * wx
OPS_OVER = 2  # out * k + v
OPS_COVER = 2  # packed composite rgba emit: cover * k + a
OPS_YADIF_SAMPLE = 50 + 39  # spatial_pred + temporal_clamp, per predicted sample
# rotate.cu affine_taps per output pixel and matrix: ix, iy, px, py, u, v,
# floors, fractions and the clamps of the tap index
OPS_AFFINE_PX = 26

# the straggler channels (bench.py composite_variant_step)
STRAGGLER_FRAMES = 4  # frames per geometry and variant
TOL_RGBA = 2e-4  # the rgba emit against the plain path

# the file-media channel (yuv422p10le, yuv420p / nv12, rgba8 sources;
# yuv422p10le out, rgba8 and nv12 consumers)
MEDIA_FRAMES = 8  # frames per geometry
MEDIA_DVE = dict(scale_x=0.5, scale_y=0.5, offset_x=0.2, offset_y=-0.15)  # picture in picture
# every registry format once (the aliases name the same modules)
FORMAT_NAMES = ("v210", "yuv422p10le", "yuv422p8", "yuv420p", "nv12", "rgba8", "bgra8")
# the 4:2:0 encode: luma every pixel, two chroma rows every fourth
OPS_ENCODE_420_PX = 3 * OPS_L2G + 9 + 18 / 4
OPS_K = 1  # packed composite, rgba kind: k = 1 - alpha of the sampled plane

# the file-media multi-box channel (a quad split of file clips)
MULTIBOX_FRAMES = 8  # frames per geometry and output
MULTIBOX_CLIP = (1280, 720)  # L1's clip pair: a 720p H.264 clip and its nv12 successor
# box -> (offset_x, offset_y) at scale 0.5: transform_matrix maps output
# to input, so a box moves against the sign of its offset
QUADRANTS = {"top_left": (0.25, 0.25), "top_right": (-0.25, 0.25), "bottom_left": (0.25, -0.25)}
# the runtime phase: port Channels (runtime/channel.py) on one event loop
RUNTIME_DISSOLVE_TICKS = 100_000  # a MIX this long: every measured tick is mid-dissolve
RUNTIME_FILL_PERIODS = 3  # the rings fill over two periods; the third's first tick prepares the structure
RUNTIME_PERIODS = 3  # steady 1080i50 periods checked and counted
RUNTIME_TICKS = 4  # steady ticks of each 1080p50 channel
PACED_SECONDS = 4.0  # the four 1080i50 channels under Channel.run
# the TPU kernels K5's whole-stack modes stand for
B15 = "phaneron_tpu/ops/pallas_composite.py:407"
B16 = "phaneron_tpu/ops/pallas_warp.py:910"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """ptxas's resource lines (-Xptxas -v), each after the kernel it
    describes: '<kernel>: Used N registers, ..., S bytes smem' (static
    shared memory; a dynamic window is the launch's own) and its spills."""
    import re

    out, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
            try:  # demangled where binutils is there; the mangled name names the kernel too
                kernel = subprocess.run(["c++filt", kernel], capture_output=True, text=True,
                                        timeout=10).stdout.strip() or kernel
            except (OSError, subprocess.SubprocessError):
                pass
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def time_ms(torch, fn, batches: int = 7, calls: int = 10, warmup: int = 3) -> float:
    """Median over ``batches`` of the mean ms per call of ``calls``
    back-to-back fn() calls between two CUDA events, after warm-up.  The
    host enqueues ahead of the card, so this is the device time per call
    unless launching takes the host longer than the card takes to run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def latency_ms(torch, fn, reps: int = 30) -> float:
    """Median host-clock ms of one fn() call that starts and ends with
    the card idle (synchronised before and after)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(torch, fn, batches: int = 7, calls: int = 10, warmup: int = 3) -> float:
    """Median over ``batches`` of the device ms per call: ``calls`` fn()
    calls captured once into a CUDA graph (each wrapper launches on the
    current stream, which the capture owns) and replayed between two CUDA
    events, so the host's cost of a wrapper call (tens of microseconds of
    Python) does not hide a kernel shorter than it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def best_of_two(torch, kernel_fn, plain_fn, plain_kw=None) -> tuple[float, float]:
    """Kernel ms (device time, device_ms) and plain ms (time_ms: many
    small torch ops, host and device), the better of two runs each, in
    turns."""
    plain_kw = plain_kw or {}
    ms = [device_ms(torch, kernel_fn)]
    pms = [time_ms(torch, plain_fn, **plain_kw)]
    ms.append(device_ms(torch, kernel_fn))
    pms.append(time_ms(torch, plain_fn, **plain_kw))
    return min(ms), min(pms)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least ms the card could take: bytes over HBM bandwidth or
    operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_words(rng, width: int, height: int) -> np.ndarray:
    from phaneron_tpu_torch.ops.formats import v210

    return rng.integers(0, 2**32, size=(height, v210.pitch_bytes(width) // 4), dtype=np.uint32)


def code_delta(torch, a, b, width: int, height: int) -> int:
    from phaneron_tpu_torch.ops.formats import v210

    ca = v210.unpack_codes([a], width, height)
    cb = v210.unpack_codes([b], width, height)
    return max(int((x - y).abs().max()) for x, y in zip(ca, cb))


def format_planes(rng, name: str, width: int, height: int) -> list:
    """Seeded random planes of a format over its full code range (v210:
    full-range words; 10-bit planar codes in [0, 1023])."""
    from phaneron_tpu_torch.ops.formats import get_format

    if name == "v210":
        return [random_words(rng, width, height)]
    fmt = get_format(name)
    hi = 1 << fmt.INFO.num_bits
    return [rng.integers(0, hi, size=s, dtype=dt) for s, dt in fmt.plane_shapes(width, height)]


def plane_delta(torch, a, b) -> int:
    """Largest sample difference between two lists of planes of any
    sample type."""
    return max(int((x.to(torch.int32) - y.to(torch.int32)).abs().max()) for x, y in zip(a, b))


def packed_delta(torch, fmt: str, a, b, width: int, height: int) -> int:
    """Largest code difference between two packings of one format."""
    return code_delta(torch, a[0], b[0], width, height) if fmt == "v210" else plane_delta(torch, a, b)


def warp_source_texels(torch, mat, height: int, width: int) -> int:
    """Source texels an axis-aligned warp by ``mat`` reads: the rows and
    columns its in-range taps land on (this run's matrix decides it)."""
    from phaneron_tpu_torch.ops.geometry import _bilinear_setup, _out_coords

    def used(m, off, size):
        i0, _ = _bilinear_setup(m * _out_coords(size, mat.device) + off + 0.5, size)
        taps = torch.cat([i0, i0 + 1])
        return int(taps[(taps >= 0) & (taps < size)].unique().numel())

    return used(mat[1, 1], mat[1, 2], height) * used(mat[0, 0], mat[0, 2], width)


def warp_source_groups(torch, mat, height: int, width: int) -> int:
    """v210 groups an axis-aligned warp by ``mat`` reads: the rows and the
    6-pixel groups of the columns its in-range taps land on."""
    from phaneron_tpu_torch.ops.geometry import _bilinear_setup, _out_coords

    def used(m, off, size, per):
        i0, _ = _bilinear_setup(m * _out_coords(size, mat.device) + off + 0.5, size)
        taps = torch.cat([i0, i0 + 1])
        return int((taps[(taps >= 0) & (taps < size)] // per).unique().numel())

    return used(mat[1, 1], mat[1, 2], height, 1) * used(mat[0, 0], mat[0, 2], width, 6)


def grid_sample_args(torch, srcs, mat):
    """(input, grid) for F.grid_sample computing the same warp: grid
    g = 2 * (m00 * ix + m02) (align_corners=False, zero padding)."""
    from phaneron_tpu_torch.ops.geometry import _out_coords

    _, h, w = srcs[0].shape
    gx = 2.0 * (mat[0, 0] * _out_coords(w, mat.device) + mat[0, 2])
    gy = 2.0 * (mat[1, 1] * _out_coords(h, mat.device) + mat[1, 2])
    grid = torch.stack([gx[None, :].expand(h, w), gy[:, None].expand(h, w)], dim=-1)
    return torch.stack(srcs), grid[None].expand(len(srcs), h, w, 2).contiguous()


def affine_grid_args(torch, srcs, mat):
    """(input, grid) for F.grid_sample computing the affine warp:
    g = 2 * (mat[:2] @ (ix, iy, 1)) (align_corners=False, zero padding)."""
    from phaneron_tpu_torch.ops.geometry import _out_coords

    _, h, w = srcs[0].shape
    ix = _out_coords(w, mat.device)[None, :]
    iy = _out_coords(h, mat.device)[:, None]
    gx = 2.0 * (mat[0, 0] * ix + mat[0, 1] * iy + mat[0, 2])
    gy = 2.0 * (mat[1, 0] * ix + mat[1, 1] * iy + mat[1, 2])
    grid = torch.stack([gx.expand(h, w), gy.expand(h, w)], dim=-1)
    return torch.stack(srcs), grid[None].expand(len(srcs), h, w, 2).contiguous()


def affine_source_texels(torch, mat, height: int, width: int) -> int:
    """Source texels an affine warp by ``mat`` reads: the distinct
    in-range taps of every output pixel (this run's matrix decides it)."""
    from phaneron_tpu_torch.ops.geometry import _bilinear_setup, _out_coords

    ix = _out_coords(width, mat.device)[None, :]
    iy = _out_coords(height, mat.device)[:, None]
    x0, _ = _bilinear_setup(mat[0, 0] * ix + mat[0, 1] * iy + mat[0, 2] + 0.5, width)
    y0, _ = _bilinear_setup(mat[1, 0] * ix + mat[1, 1] * iy + mat[1, 2] + 0.5, height)
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            taps.append((y * width + x)[ok])
    return int(torch.cat(taps).unique().numel())


def phase_kernels(torch, dev, rng) -> dict:
    """K1-K4 (the staged path's unpacks, pack and warp) against their
    plain versions at 1080p."""
    from phaneron_tpu_torch.graph.convert import to_tensor, words_to_numpy
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import v210, yuv422p8
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp, warp_plain

    rec = {}
    err = lambda a, b: float((a - b).abs().max())

    # K1: two sources per launch, as the main path gives it
    words = [to_tensor(random_words(rng, W, H), dev), to_tensor(v210.fill_buf(W, H)[0], dev)]
    got = K.v210_unpack(words, W, H)
    want = K.v210_unpack_plain(words, W, H)
    e1 = max(err(a, b) for a, b in zip(got, want))
    for width, height in ((1280, 16), (100, 16)):  # pitch pads, partial last group
        ws = [to_tensor(random_words(rng, width, height), dev)]
        e1 = max(e1, err(K.v210_unpack(ws, width, height)[0], K.v210_unpack_plain(ws, width, height)[0]))
    print(f"K1 v210_unpack max |kernel - plain| = {e1:.3e} (<= {TOL_UNPACK})")
    check(e1 <= TOL_UNPACK, f"v210_unpack error {e1}")
    rec["v210_unpack"] = dict(max_abs_err=e1, args=(words, W, H))

    # K2: codes on random inputs, and the bit-exact fill_buf round trip
    rgb_rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, H, W)).astype(np.float32)).to(dev)
    d2 = 0
    for rgb in (rgb_rand, got[0], got[0][:3].contiguous()):
        d2 = max(d2, code_delta(torch, K.v210_pack(rgb), K.v210_pack_plain(rgb), W, H))
    print(f"K2 v210_pack max code delta vs plain on random inputs = {d2} (<= {TOL_CODES})")
    check(d2 <= TOL_CODES, f"v210_pack code delta {d2}")
    for width, height in ((W, H), (1280, 720), (100, 16)):
        fill = v210.fill_buf(width, height)[0]
        rt = K.v210_pack(K.v210_unpack([to_tensor(fill, dev)], width, height)[0])
        same = np.array_equal(words_to_numpy(rt), fill)
        print(f"K2(K1(fill_buf)) == fill_buf at {width}x{height}: {same}")
        check(same, f"v210 round trip at {width}x{height}")
    rec["v210_pack"] = dict(max_abs_err=float(d2), args=(got[0],))

    # K3: random 8-bit planes and the ramp
    e3 = 0.0
    for width in (W, 720):
        p = yuv422p8.pitch(width)
        rand = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in ((H, p), (H, p // 2), (H, p // 2))]
        for planes in (rand, yuv422p8.fill_buf(width, H)):
            pt = [to_tensor(x, dev) for x in planes]
            e3 = max(e3, err(K.planar422_unpack(pt, width, H), K.planar422_unpack_plain(pt, width, H)))
    print(f"K3 planar422_unpack max |kernel - plain| = {e3:.3e} (<= {TOL_UNPACK})")
    check(e3 <= TOL_UNPACK, f"planar422_unpack error {e3}")
    y422 = [to_tensor(x, dev) for x in yuv422p8.fill_buf(W, H)]
    rec["planar422_unpack"] = dict(max_abs_err=e3, args=(y422, W, H))

    # K4: single and pair, several axis-aligned matrices
    a = torch.from_numpy(rng.random((4, H, W), dtype=np.float32)).to(dev)
    b = torch.from_numpy(rng.random((4, H, W), dtype=np.float32)).to(dev)
    mix = torch.tensor(0.35, device=dev)
    e4 = 0.0
    for kw in (dict(scale_x=0.9, offset_x=0.05), dict(scale_x=0.9, scale_y=0.9, offset_x=0.02),
               dict(scale_x=0.5, scale_y=2.0, offset_y=-0.1), dict(flip_h=True, scale_x=1.3), dict()):
        mat = to_tensor(transform_matrix(W, H, **kw), dev)
        e4 = max(e4, err(warp(a, mat), warp_plain(a, mat)))
        e4 = max(e4, err(warp(a, mat, b, mix), warp_plain(a, mat, b, mix)))
    print(f"K4 warp max |kernel - plain| = {e4:.3e} (<= {TOL_WARP})")
    check(e4 <= TOL_WARP, f"warp error {e4}")
    mat = to_tensor(transform_matrix(W, H, scale_x=0.9, offset_x=0.05), dev)
    rec["warp"] = dict(max_abs_err=e4, args=(got[0], mat, got[1], mix))
    torch.cuda.synchronize()
    return rec


def phase_interlaced_kernels(torch, dev, rng, rec: dict) -> None:
    """The kernels of the interlaced default load against their plain
    versions at 1920x1080: K1 and K4 with 3 channels, yadif ring and
    pair (C 3 and 4, opaque, tff and bff, both parities)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import yadif as Y
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp, warp_plain

    err = lambda a, b: float((a - b).abs().max())

    # K1, 3 channels: one source per launch (the unpack stage program)
    # and two, random words and the ramp
    words = [to_tensor(random_words(rng, W, H), dev), to_tensor(v210.fill_buf(W, H)[0], dev)]
    e1 = max(
        err(a, b) for a, b in zip(K.v210_unpack(words, W, H, channels=3),
                                  K.v210_unpack_plain(words, W, H, channels=3))
    )
    one = [words[0]]
    e1 = max(e1, err(K.v210_unpack(one, W, H, channels=3)[0],
                     K.v210_unpack_plain(one, W, H, channels=3)[0]))
    print(f"K1 v210_unpack, 3 channels, max |kernel - plain| = {e1:.3e} (<= {TOL_UNPACK})")
    check(e1 <= TOL_UNPACK, f"v210_unpack 3-channel error {e1}")
    rec["v210_unpack"]["max_abs_err"] = max(rec["v210_unpack"]["max_abs_err"], e1)
    rec["v210_unpack"]["rgb3_args"] = (one, W, H, "709", "709", 3)

    # K4, 3 channels, single and pair
    a = torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev)
    b = torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev)
    mix = torch.tensor(0.45, device=dev)
    e4 = 0.0
    for kw in (dict(scale_x=0.9, scale_y=0.9, offset_x=0.02), dict(scale_x=0.5, scale_y=2.0, offset_y=-0.1),
               dict(flip_h=True, scale_x=1.3), dict()):
        mat = to_tensor(transform_matrix(W, H, **kw), dev)
        e4 = max(e4, err(warp(a, mat), warp_plain(a, mat)))
        e4 = max(e4, err(warp(a, mat, b, mix), warp_plain(a, mat, b, mix)))
    print(f"K4 warp, 3 channels, max |kernel - plain| = {e4:.3e} (<= {TOL_WARP})")
    check(e4 <= TOL_WARP, f"warp 3-channel error {e4}")
    mat = to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02), dev)
    rec["warp"]["max_abs_err"] = max(rec["warp"]["max_abs_err"], e4)
    rec["warp"]["rgb3_args"] = (a, mat, b, mix)
    # the library call computing the same warps (both sources, no mix)
    gs_in, gs_grid = grid_sample_args(torch, [a, b], mat)
    gs = torch.nn.functional.grid_sample(gs_in, gs_grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=False)
    e_gs = max(err(gs[0], warp_plain(a, mat)), err(gs[1], warp_plain(b, mat)))
    print(f"grid_sample vs plain warp max |delta| = {e_gs:.3e} (a record: the library's own rounding)")
    rec["warp"]["library_args"] = (gs_in, gs_grid)

    # yadif ring and pair: seeded random opaque rings, with and without
    # the spatial check; then the tile edges of the pair kernel
    ey = 0.0
    cases = 0

    def yadif_cases(ring, opaque, tffs=(True, False), skips=(False, True)):
        nonlocal ey, cases
        for tff in tffs:
            for skip in skips:
                kw = dict(skip_spatial=skip, opaque=opaque)
                for parity in (0, 1):
                    par = torch.tensor(parity, dtype=torch.int32, device=dev)
                    ey = max(ey, err(Y.yadif_ring(*ring, par, tff, **kw), Y.yadif_ring_plain(*ring, parity, tff, **kw)))
                    cases += 1
                got, want = Y.yadif_pair(*ring, tff, **kw), Y.yadif_pair_plain(*ring, tff, **kw)
                ey = max(ey, max(err(g, w) for g, w in zip(got, want)))
                cases += 1

    def yadif_ring_of(r, channels, h, w):
        ring = [torch.from_numpy(r.random((channels, h, w), dtype=np.float32)).to(dev) for _ in range(3)]
        if channels == 4:
            for f in ring:
                f[3] = 1.0
        return ring

    for channels, opaque in ((3, False), (4, False), (4, True)):
        ring = yadif_ring_of(rng, channels, H, W)
        yadif_cases(ring, opaque)
        if channels == 3:
            rec["yadif_ring"] = dict(args=(*ring, torch.tensor(1, dtype=torch.int32, device=dev), TFF))
            rec["yadif_pair"] = dict(args=(*ring, TFF))
    # heights and widths off the pair kernel's 64 x 32 tiles and its 16-byte
    # rows, and rings down to one row and one column (their own seed, so
    # the later phases keep their inputs)
    edge_rng = np.random.default_rng(SEED + 8)
    for h, w in ((1081, W), (H, 1918)):
        for channels, opaque in ((3, False), (4, False), (4, True)):
            yadif_cases(yadif_ring_of(edge_rng, channels, h, w), opaque)
    for i, (h, w) in enumerate((h, w) for h in range(1, 6) for w in range(1, 8)):
        channels, opaque = ((3, False), (4, False), (4, True))[i % 3]
        yadif_cases(yadif_ring_of(edge_rng, channels, h, w), opaque, tffs=(i % 2 == 0,))
    # the ring kernel's 64-column tiles of 32 rows (and the pair's 64 x 32):
    # heights one below, at and one above one and two tiles' rows, widths
    # one below, at and one above a tile, and one off 16 bytes
    for i, (h, w) in enumerate((h, w) for h in (31, 32, 33, 63, 64, 65) for w in (63, 64, 65, 66)):
        channels, opaque = ((3, False), (4, False), (4, True))[i % 3]
        yadif_cases(yadif_ring_of(edge_rng, channels, h, w), opaque, tffs=(i % 2 == 0,))
    print(f"yadif_ring / yadif_pair max |kernel - plain| = {ey} over {cases} cases (C 3 and 4, opaque, tff "
          "and bff, skip_spatial, both parities from device memory; 1920x1080, 1920x1081, 1918x1080, every "
          "ring of 1-5 rows by 1-7 columns, and 31-33 and 63-65 rows by 63-66 columns; == 0)")
    check(ey == 0.0, f"yadif kernels differ from their plain versions by {ey}")
    rec["yadif_ring"]["max_abs_err"] = ey
    rec["yadif_pair"]["max_abs_err"] = ey

    # packed composite: the default load's tick (4 dissolve layers,
    # distinct matrices), and cuts between dissolves under matrices that
    # scale up, flip and leave the frame
    from phaneron_tpu_torch.ops.composite import combine_rgb
    from phaneron_tpu_torch.ops.packed_warp import packed_composite, packed_composite_plain
    from phaneron_tpu_torch.ops.warp import warp_alpha_vectors

    srcs = [torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev) for _ in range(8)]
    tick_mats = [to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev)
                 for i in range(4)]
    odd_mats = [to_tensor(transform_matrix(W, H, **kw), dev) for kw in (
        dict(scale_x=0.5, scale_y=2.0, offset_y=-0.1), dict(flip_h=True, scale_x=1.3),
        dict(), dict(scale_x=0.7, scale_y=0.6, offset_x=0.45))]
    mixes = [torch.tensor(0.2 + 0.15 * i, device=dev) for i in range(4)]
    d5 = d_staged = 0
    e5 = 0.0
    for cfg, mats in (((2, 2, 2, 2), tick_mats), ((2, 1, 2, 1), odd_mats)):
        mx = [m if n == 2 else None for n, m in zip(cfg, mixes)]
        args = (srcs[:sum(cfg)], cfg, mats, mx)
        got = packed_composite(*args)
        d5 = max(d5, code_delta(torch, got, packed_composite_plain(*args), W, H))
        for emit in ("both", "rgba"):
            frame, want = packed_composite(*args, emit=emit), packed_composite_plain(*args, emit=emit)
            if emit == "both":
                d5 = max(d5, code_delta(torch, frame[0], want[0], W, H))
                frame, want = frame[1], want[1]
            e5 = max(e5, err(frame, want))
        layers, s = [], 0
        for n, mat, m in zip(cfg, mats, mx):
            rgb = warp(srcs[s], mat) if n == 1 else warp(srcs[s], mat, srcs[s + 1], m)
            layers.append((rgb, *warp_alpha_vectors(H, W, mat)))
            s += n
        d_staged = max(d_staged, code_delta(torch, got, K.v210_pack(combine_rgb(layers)), W, H))
        if cfg == (2, 2, 2, 2):
            rec["packed_composite"] = dict(args=args)
    print(f"packed_composite (rgb3) max code delta vs plain = {d5} (== 0), rgba and both frames max |delta| = "
          f"{e5} (== 0); vs K4 + combine_rgb + K2 on the card = {d_staged} (a record)")
    check(d5 == 0 and e5 == 0.0, f"packed_composite (rgb3): {d5} codes, frame error {e5}")
    rec["packed_composite"]["max_abs_err"] = float(d5)
    torch.cuda.synchronize()


def phase_packed_source_kernels(torch, dev, rng, rec: dict) -> None:
    """The kernels of the progressive, playout and entry paths against
    their plain versions at 1920x1080 from seeded full-range random words:
    packed_composite over v210 words, fused_v210, combine_pack and
    packed_warp; and against the staged kernels each one fuses."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.formats import v210, yuv422p8
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp, warp_alpha_vectors

    words = lambda w=W, h=H: to_tensor(random_words(rng, w, h), dev)
    delta = lambda a, b, w=W, h=H: code_delta(torch, a, b, w, h)
    err = lambda a, b: float((a - b).abs().max())
    a, b = words(), words()
    fill = to_tensor(v210.fill_buf(W, H)[0], dev)
    mix = torch.tensor(0.35, device=dev)

    # packed composite, v210 words: the progressive frame's 4 dissolves and
    # cuts between dissolves under matrices that scale up, flip and leave
    srcs = [words() for _ in range(8)]
    prog_mats = [to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev)
                 for i in range(4)]
    odd_mats = [to_tensor(transform_matrix(W, H, **kw), dev) for kw in (
        dict(scale_x=0.5, scale_y=2.0, offset_y=-0.1), dict(flip_h=True, scale_x=1.3),
        dict(), dict(scale_x=0.7, scale_y=0.6, offset_x=0.45))]
    mixes = [torch.tensor(0.4 + 0.05 * i, device=dev) for i in range(4)]
    d7 = d7_staged = 0
    for cfg, mats in (((2, 2, 2, 2), prog_mats), ((2, 1, 2, 1), odd_mats)):
        mx = [m if n == 2 else None for n, m in zip(cfg, mixes)]
        kw = dict(src_kind="packed", size=(W, H))
        got = PW.packed_composite(srcs[:sum(cfg)], cfg, mats, mx, **kw)
        d7 = max(d7, delta(got, PW.packed_composite_plain(srcs[:sum(cfg)], cfg, mats, mx, **kw)))
        staged = PW.packed_composite(K.v210_unpack(srcs[:sum(cfg)], W, H, channels=3), cfg, mats, mx)
        d7_staged = max(d7_staged, delta(got, staged))
    print(f"packed_composite (v210 words) max code delta vs plain = {d7} (<= {TOL_CODES}); vs "
          f"K1 (3 ch) + K5 (rgb3) on the card = {d7_staged} (a record)")
    check(d7 <= TOL_CODES, f"packed_composite (packed) code delta {d7}")
    rec["packed_composite"]["max_abs_err"] = max(rec["packed_composite"]["max_abs_err"], float(d7))

    # fused v210: cut and dissolve at the main paths' sizes, a pitch pad
    # (1918), 720p, widths with a partial group and a pitch pad (1280; 200,
    # whose last 192-pixel segment ends in a partial group and pad groups)
    # and every width 1-13 at 3 rows; mixes 0, 1, 0.37 and 0.35
    d3 = d3_staged = 0
    sizes = [(W, H), (UHD_W, UHD_H), (1918, H), (1280, 720), (1280, 16), (200, 7)] + [(w, 3) for w in range(1, 14)]
    for w, h in sizes:
        x, y = (words(w, h), words(w, h)) if (w, h) != (W, H) else (a, fill)
        for args in [(x, w, h)] + [(x, w, h, y, torch.tensor(m, device=dev)) for m in (0.0, 1.0, 0.37)] + [
                (x, w, h, y, mix)]:
            got = K.fused_v210(*args)
            d3 = max(d3, delta(got, K.fused_v210_plain(*args), w, h))
        d3_staged = max(d3_staged, delta(K.fused_v210(x, w, h), K.v210_pack(K.v210_unpack([x], w, h)[0]), w, h))
    print(f"fused_v210 max code delta vs plain = {d3} (<= {TOL_CODES}); cut vs K1 + K2 on the card "
          f"= {d3_staged} (== 0), at {', '.join(f'{w}x{h}' for w, h in sizes)}")
    check(d3 <= TOL_CODES, f"fused_v210 code delta {d3}")
    check(d3_staged == 0, f"fused_v210 cut {d3_staged} codes from K1 + K2 on the card")
    rec["fused_v210"] = dict(max_abs_err=float(d3))

    # packed warp: single, shared-matrix pair, distinct-matrix pair
    m = to_tensor(transform_matrix(W, H, scale_x=0.9, offset_x=0.05), dev)
    mb = to_tensor(transform_matrix(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05), dev)
    e6 = 0.0
    for args in ((a, m, W, H), (a, m, W, H, b, mix), (a, m, W, H, b, mix, mb)):
        e6 = max(e6, err(PW.packed_warp(*args), PW.packed_warp_plain(*args)))
    fa, fb = K.v210_unpack([a, b], W, H)
    e6_staged = err(PW.packed_warp(a, m, W, H, b, mix), warp(fa, m, fb, mix))
    print(f"packed_warp max |kernel - plain| = {e6} over single, shared and distinct pairs (== 0); "
          f"pair vs K1 + K4 on the card = {e6_staged} (a record)")
    check(e6 == 0.0, f"packed_warp differs from its plain version by {e6}")
    rec["packed_warp"] = dict(max_abs_err=e6)

    # combine + pack: the entry frame's layers, and 4-channel and (rgb, wy, wx) layers mixed
    y422 = K.planar422_unpack([to_tensor(p, dev) for p in yuv422p8.fill_buf(W, H)], W, H)
    entry_layers = [PW.packed_warp(a, m, W, H, b, mix), y422]
    mixed = [fa, (fb[:3].contiguous(), *warp_alpha_vectors(H, W, m)), entry_layers[0],
             (fa[:3].contiguous(), *warp_alpha_vectors(H, W, mb))]
    d5 = max(delta(K.combine_pack(l), K.combine_pack_plain(l)) for l in (entry_layers, mixed))
    from phaneron_tpu_torch.ops.composite import combine_rgb

    d5_staged = delta(K.combine_pack(mixed), K.v210_pack(combine_rgb(mixed)))
    print(f"combine_pack max code delta vs plain = {d5} (<= {TOL_CODES}); vs combine_rgb + K2 on "
          f"the card = {d5_staged} (== 0)")
    check(d5 <= TOL_CODES, f"combine_pack code delta {d5}")
    check(d5_staged == 0, f"combine_pack {d5_staged} codes from combine_rgb + K2 on the card")
    rec["combine_pack"] = dict(max_abs_err=float(d5))
    torch.cuda.synchronize()


# K2's and B5's edge sweep: widths that end a group part-way (1-13), a
# 192-pixel segment part-way (200) and the 1918 pitch pad
V210_SWEEP = [(w, 3) for w in range(1, 14)] + [(200, 7), (1918, 8)]


def phase_v210_pack_sweep(torch, dev, rng, rec: dict) -> None:
    """K2 and B5 at V210_SWEEP against their plain versions (<= TOL_CODES;
    the kernels' powf-exact transfer makes it the plain version's own
    rounding differences only): K2 on seeded random RGB(A) in [-0.05, 1.05]
    and the decoded fill_buf ramp (whose round trip must be bit-exact at
    the even widths: at an odd one fill_buf leaves fields of the last
    pixel pair 0 that the pack fills), C 4 and 3; B5 with 1, 2 and
    MAX_LAYERS layers (the kernel's three instances) alternating
    premultiplied RGBA frames and (rgb, wy, wx) layers, also ==
    combine_rgb + K2 on the card; and both with every frame one float past
    a 16-byte boundary at 1918 and 200 (the kernel's 4-byte copies, which
    every width not a multiple of 4 takes too)."""
    from phaneron_tpu_torch.graph.convert import to_tensor, words_to_numpy
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.composite import combine_rgb
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp_alpha_vectors

    def moved(x):
        buf = torch.empty(x.numel() + 1, dtype=torch.float32, device=dev)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    d2 = d5 = d5_staged = 0
    cases = 0
    for w, h in V210_SWEEP:
        delta = lambda a, b: code_delta(torch, a, b, w, h)
        fill = v210.fill_buf(w, h)[0]
        ramp = K.v210_unpack([to_tensor(fill, dev)], w, h)[0]
        if w % 2 == 0:  # at an odd width fill_buf leaves fields of the last pixel pair 0 that the pack fills
            check(np.array_equal(words_to_numpy(K.v210_pack(ramp)), fill), f"v210_pack sweep: round trip at {w}x{h}")
        rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, w)).astype(np.float32)).to(dev)
        frames = [x[:c].contiguous() for x in (ramp, rand) for c in (4, 3)]
        if w in (200, 1918):
            frames.append(moved(rand[:3]))
        for x in frames:
            d2 = max(d2, delta(K.v210_pack(x), K.v210_pack_plain(x)))
        for n in (1, 2, K.MAX_LAYERS):
            layers = []
            for m in range(n):
                if m % 2 == 0:
                    a = torch.from_numpy(rng.random((1, h, w), dtype=np.float32)).to(dev)
                    rgb = torch.from_numpy(rng.uniform(-0.05, 1.05, (3, h, w)).astype(np.float32)).to(dev)
                    layers.append(torch.cat([rgb * a, a]))
                else:
                    mat = to_tensor(transform_matrix(w, h, scale_x=0.8 + 0.02 * m, scale_y=0.9, offset_x=0.01 * m), dev)
                    rgb = torch.from_numpy(rng.random((3, h, w), dtype=np.float32)).to(dev)
                    layers.append((rgb, *warp_alpha_vectors(h, w, mat)))
            stacks = [layers]
            if w in (200, 1918):
                stacks.append([tuple(moved(t) for t in f) if isinstance(f, tuple) else moved(f) for f in layers])
            for ls in stacks:
                got = K.combine_pack(ls)
                d5 = max(d5, delta(got, K.combine_pack_plain(ls)))
                d5_staged = max(d5_staged, delta(got, K.v210_pack(combine_rgb(ls))))
                cases += 1
    sizes = ", ".join(f"{w}x{h}" for w, h in V210_SWEEP)
    print(f"v210_pack sweep ({sizes}; random RGB(A) and the decoded ramps, C 4 and 3, round trips bit-exact, "
          f"one float off alignment at 200 and 1918) max code delta vs plain = {d2} (<= {TOL_CODES})")
    print(f"combine_pack sweep ({cases} stacks of 1, 2 and 8 layers, RGBA and (rgb, wy, wx) alternating, one float "
          f"off alignment at 200 and 1918) max code delta vs plain = {d5} (<= {TOL_CODES}); vs combine_rgb + K2 on "
          f"the card = {d5_staged} (== 0)")
    check(d2 <= TOL_CODES, f"v210_pack sweep code delta {d2}")
    check(d5 <= TOL_CODES, f"combine_pack sweep code delta {d5}")
    check(d5_staged == 0, f"combine_pack sweep {d5_staged} codes from combine_rgb + K2 on the card")
    rec["v210_pack"]["max_abs_err"] = max(rec["v210_pack"]["max_abs_err"], float(d2))
    rec["combine_pack"]["max_abs_err"] = max(rec["combine_pack"]["max_abs_err"], float(d5))
    torch.cuda.synchronize()


def k5_branches(torch, dev, args, kw) -> list:
    """[window, direct]: the (tile, source) pairs of one packed composite
    launch that sampled a shared-memory decode window and straight from
    the words."""
    from phaneron_tpu_torch.ops import packed_warp as PW

    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    PW.packed_composite(*args, branches=counts, **kw)
    return counts.tolist()


def phase_window_edges(torch, dev, rng, rec: dict) -> None:
    """K5's shared-memory windows at their edges, against
    packed_composite_plain at 1920x1080, over seeded full-range random
    words (v210 kind: decode windows) and seeded random (3, H, W) frames
    (rgb3 kind: copied windows): flips, a minifying box at scale 0.5 and
    at 0.25 (windows 2x and 4x the tile per axis, too large for shared
    memory: the direct branch), offsets past the frame edge, and the
    progressive matrices and a flip at 1918x1080 (a pitch pad, and frame
    rows that are not 16-byte aligned); each as 4 dissolve layers and as
    dissolves between cuts, emits packed, both (top alpha) and rgba
    (coverage).  v210: 0 codes and max |delta| 0 expected, <= 1 code and
    <= 2e-4 held; rgb3: 0 codes and max |delta| 0 held."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    err = lambda a, b: float((a - b).abs().max())
    mixes = [torch.tensor(0.3 + 0.1 * i, device=dev) for i in range(4)]
    quads = list(QUADRANTS.values()) + [(-0.25, -0.25)]
    cases = {  # label -> (width, matrices, whether every tile must sample a window)
        "flip_h": (W, [dict(flip_h=True, scale_x=0.9, scale_y=0.9, offset_x=0.03 - 0.01 * i) for i in range(4)], True),
        "flip_hv": (W, [dict(flip_h=True, flip_v=True, scale_x=1.3, scale_y=0.8)] * 4, True),
        "minify_0.5": (W, [dict(scale_x=0.5, scale_y=0.5, offset_x=ox, offset_y=oy) for ox, oy in quads], False),
        # the tiles outside the box sample an empty window
        "minify_0.25": (W, [dict(scale_x=0.25, scale_y=0.25, offset_x=0.1 * i) for i in range(4)], False),
        "off_frame": (W, [dict(scale_x=0.7, scale_y=0.6, offset_x=0.45),
                          dict(scale_x=0.9, scale_y=0.9, offset_x=-0.3, offset_y=0.4), dict(offset_x=1.5),
                          dict(scale_x=1.2, offset_y=-0.7)], False),
        "progressive_1918": (1918, [dict(scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i) for i in range(4)],
                             True),
        "flip_1918": (1918, [dict(flip_h=True, scale_x=0.9, scale_y=0.9)] * 4, True),
    }
    srcs = {("packed", w): [to_tensor(random_words(rng, w, H), dev) for _ in range(8)] for w in (W, 1918)}
    srcs.update({("rgb3", w): [torch.from_numpy(rng.random((3, H, w), dtype=np.float32)).to(dev) for _ in range(8)]
                 for w in (W, 1918)})
    d_max = {"packed": 0, "rgb3": 0}
    e_max = {"packed": 0.0, "rgb3": 0.0}
    branches = {"packed": {}, "rgb3": {}}
    for label, (w, kws, window_only) in cases.items():
        mats = [to_tensor(transform_matrix(w, H, **kw), dev) for kw in kws]
        for kind in ("packed", "rgb3"):
            counts = [0, 0]
            for cfg in ((2, 2, 2, 2), (2, 1, 2, 1)):
                args = (srcs[kind, w][:sum(cfg)], cfg, mats, [m if n == 2 else None for n, m in zip(cfg, mixes)])
                for emit, alpha in (("packed", "top"), ("both", "top"), ("rgba", "coverage")):
                    kw = dict(src_kind=kind, size=(w, H), emit=emit, alpha=alpha)
                    got, want = PW.packed_composite(*args, **kw), PW.packed_composite_plain(*args, **kw)
                    if emit != "rgba":
                        d_max[kind] = max(d_max[kind], code_delta(torch, got if emit == "packed" else got[0],
                                                                  want if emit == "packed" else want[0], w, H))
                    if emit != "packed":
                        e_max[kind] = max(e_max[kind], err(got if emit == "rgba" else got[1],
                                                           want if emit == "rgba" else want[1]))
                counts = [a + b for a, b in zip(counts, k5_branches(torch, dev, args, dict(src_kind=kind, size=(w, H))))]
            branches[kind][label] = counts
            check(not window_only or counts[1] == 0,
                  f"packed_composite {kind} {label}: window/direct {counts}, every tile expected on the window branch")
    print(f"packed_composite window edges (flip, minify 0.5 / 0.25, off frame, 1918 wide): v210 words max code "
          f"delta vs plain = {d_max['packed']} (<= {TOL_CODES}), frames max |delta| = {e_max['packed']:.3e} (<= "
          f"{TOL_RGBA}); rgb3 frames {d_max['rgb3']} codes, frames max |delta| = {e_max['rgb3']:.3e} (== 0); "
          f"window/direct (tile, source) pairs {branches}")
    for kind in ("packed", "rgb3"):
        check(branches[kind]["minify_0.25"][1] > 0, f"packed_composite {kind}: the minifying box did not reach the "
                                                    "direct branch")
    check(d_max["packed"] <= TOL_CODES, f"packed_composite window edges code delta {d_max['packed']}")
    check(e_max["packed"] <= TOL_RGBA, f"packed_composite window edges frame error {e_max['packed']}")
    check(d_max["rgb3"] == 0 and e_max["rgb3"] == 0.0,
          f"packed_composite rgb3 window edges: {d_max['rgb3']} codes, frame error {e_max['rgb3']}")
    rec["packed_composite"]["max_abs_err"] = max(rec["packed_composite"]["max_abs_err"], float(max(d_max.values())))
    rec["packed_composite"]["rgba_max_abs_err"] = max(rec["packed_composite"]["rgba_max_abs_err"], *e_max.values())
    torch.cuda.synchronize()


def rotate_branches(torch, dev, args, kw) -> list:
    """[window, direct]: the (tile, source) pairs of one rotate launch
    that sampled a shared-memory window and straight from the frame."""
    from phaneron_tpu_torch.ops import rotate as R

    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    R.rotate(*args, branches=counts, **kw)
    return counts.tolist()


def phase_rotate_edges(torch, dev, rng, rec: dict) -> None:
    """rotate's shared-memory windows at their edges, against rotate_plain:
    single, dissolve pair (one shared matrix or two) and wipe pair (one
    matrix or two), C 3 and 4, at 0, 45, 90, 100, 180 and 270 degrees and
    scales 0.25, 0.9 and 2, and two offsets past the frame, at 1x1, 7x5,
    1918x1081, 1917x1079 (an odd width: single-texel copies) and 3840x2160
    (seeded random frames and masks).  Every case
    max |delta| 0; each launch's window/direct (tile, source) counts must
    equal those ops/rotate.py window_counts gives, and both branches must
    be taken."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import rotate as R
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    mix = torch.tensor(0.37, device=dev)
    worst, counts, cases = 0.0, {}, 0
    for w, h in ((1, 1), (7, 5), (1918, 1081), (1917, 1079), (UHD_W, UHD_H)):
        frames = {c: [torch.from_numpy(rng.random((c, h, w), dtype=np.float32)).to(dev) for _ in range(2)]
                  for c in (3, 4)}
        mask = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        mats = {f"{deg} deg x{s}": dict(rotate=deg / 360.0, scale_x=s, scale_y=s)
                for deg in (0, 45, 90, 100, 180, 270) for s in (0.25, 0.9, 2.0)}
        mats["100 deg x0.9 offset (1.3, -0.2)"] = dict(rotate=100 / 360.0, scale_x=0.9, scale_y=0.9, offset_x=1.3,
                                                       offset_y=-0.2)
        mats["30 deg x1.1 offset (-0.7, 0.9)"] = dict(rotate=30 / 360.0, scale_x=1.1, scale_y=1.1, offset_x=-0.7,
                                                      offset_y=0.9)
        per_size = {}
        for label, kw_m in mats.items():
            m = to_tensor(transform_matrix(w, h, **kw_m), dev)
            mb = to_tensor(transform_matrix(w, h, **dict(kw_m, rotate=kw_m["rotate"] + 30 / 360.0,
                                                         scale_x=0.8 * kw_m["scale_x"], offset_x=0.05)), dev)
            single = R.window_counts(m, w, h, False)
            pair_m, pair_mb = R.window_counts(m, w, h, True), R.window_counts(mb, w, h, True)
            total = [0, 0]
            for c in (3, 4):
                a, b = frames[c]
                for args, kw, expect in (((a, m), {}, single),
                                         ((a, m, b, mix), {}, [2 * x for x in pair_m]),
                                         ((a, m, b, mix, mb), {}, [x + y for x, y in zip(pair_m, pair_mb)]),
                                         ((a, m, b), dict(mask=mask), [2 * x for x in pair_m]),
                                         ((a, m, b), dict(mat_b=mb, mask=mask), [x + y for x, y in zip(pair_m, pair_mb)])):
                    got, want = R.rotate(*args, **kw), R.rotate_plain(*args, **kw)
                    worst = max(worst, float((got - want).abs().max()))
                    branches = rotate_branches(torch, dev, args, kw)
                    check(branches == expect, f"rotate {w}x{h} {label} C {c}: window/direct {branches}, "
                                              f"window_counts gives {expect}")
                    total = [x + y for x, y in zip(total, branches)]
                    cases += 1
            per_size[label] = total
        counts[f"{w}x{h}"] = per_size
    print(f"rotate window edges: {cases} cases (single, dissolve and wipe pairs under one matrix or two, C 3 and 4; "
          f"0/45/90/100/180/270 degrees at scales 0.25/0.9/2 and two offsets past the frame; 1x1, 7x5, 1918x1081, "
          f"1917x1079, 3840x2160) max |kernel - plain| = {worst:.3e} (== 0); window/direct (tile, source) pairs per case, "
          f"summed over modes and C, equal to window_counts': {counts}")
    check(worst == 0.0, f"rotate window edges differ from the plain version by {worst}")
    taken = [sum(v[i] for per in counts.values() for v in per.values()) for i in (0, 1)]
    check(min(taken) > 0, f"rotate window edges: window/direct pairs {taken}, both branches expected")
    rec["rotate"]["window_edges"] = counts
    torch.cuda.synchronize()


def packed_warp_branches(torch, dev, args) -> list:
    """[window, direct]: the (tile, source) pairs of one packed warp
    launch that sampled a decoded shared-memory window and decoded each
    tap from the words."""
    from phaneron_tpu_torch.ops import packed_warp as PW

    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    PW.packed_warp(*args, branches=counts)
    return counts.tolist()


# matrices at the axis-aligned windows' edges: label -> transform_matrix
# keywords (the frame's own size); the minifying boxes' windows exceed
# B6's limit (the direct branch), the offsets put whole tiles off the
# frame (B6's sources +0, not decoded)
AXIS_EDGE_MATS = {
    "x0.9": dict(scale_x=0.9, scale_y=0.9, offset_x=0.02),
    "flip_h": dict(flip_h=True, scale_x=0.9, scale_y=0.9, offset_x=0.03),
    "flip_hv": dict(flip_h=True, flip_v=True, scale_x=1.3, scale_y=0.8),
    "pip_0.5": MEDIA_DVE,
    "minify_0.25": dict(scale_x=0.25, scale_y=0.25, offset_x=0.1),
    "minify_0.3_x2": dict(scale_x=0.3, scale_y=2.0, offset_y=-0.1),
    "magnify_2": dict(scale_x=2.0, scale_y=2.0, offset_x=-0.2),
    "off_frame": dict(scale_x=0.9, scale_y=0.9, offset_x=1.5),
    "off_frame_part": dict(scale_x=0.7, scale_y=0.6, offset_x=0.45, offset_y=-0.4),
}
AXIS_EDGE_SIZES = ((1, 1), (1, 7), (13, 1), (2, 3), (5, 2), (4, 4), (7, 5), (13, 7), (1280, 720),
                   (1918, H), (W, H), (UHD_W, UHD_H))


def phase_axis_warp_edges(torch, dev, rng, rec: dict) -> None:
    """K4 and B6's decoded windows at their edges, against warp_plain and
    packed_warp_plain on seeded random frames, masks and words: every
    matrix of AXIS_EDGE_MATS (flips, the media picture in picture,
    minifying boxes whose windows exceed B6's limit, a magnifying box,
    offsets that put whole tiles off the frame) at every size of
    AXIS_EDGE_SIZES (1x1 to 13x7, 1280x720, 1918x1080, 1920x1080,
    3840x2160); K4 single, dissolve and wipe pairs under one matrix or
    two, C 3 and 4; B6 single, shared-matrix and distinct-matrix pairs.
    Every case max |delta| 0; each B6 launch's window/direct (tile,
    source) counts must equal those of ops/packed_warp.py
    warp_window_counts, and both its branches must be taken."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops import warp as warp_mod
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    mix = torch.tensor(0.37, device=dev)
    worst = {"warp": 0.0, "packed_warp": 0.0}
    taken, direct_at = [0, 0], set()
    cases = {"warp": 0, "packed_warp": 0}
    for w, h in AXIS_EDGE_SIZES:
        frames = {c: [torch.from_numpy(rng.random((c, h, w), dtype=np.float32)).to(dev) for _ in range(2)]
                  for c in (3, 4)}
        mask = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        words = [to_tensor(random_words(rng, w, h), dev) for _ in range(2)]
        for label, kw_m in AXIS_EDGE_MATS.items():
            m = to_tensor(transform_matrix(w, h, **kw_m), dev)
            mb = to_tensor(transform_matrix(w, h, **dict(kw_m, scale_x=0.8 * kw_m.get("scale_x", 1.0),
                                                              offset_y=kw_m.get("offset_y", 0.0) + 0.05)), dev)
            for c in (3, 4):
                a, b = frames[c]
                for args, kw in (((a, m), {}), ((a, m, b, mix), {}), ((a, m, b, mix, mb), {}),
                                 ((a, m, b), dict(mask=mask)), ((a, m, b), dict(mat_b=mb, mask=mask))):
                    got, want = warp_mod.warp(*args, **kw), warp_mod.warp_plain(*args, **kw)
                    worst["warp"] = max(worst["warp"], float((got - want).abs().max()))
                    cases["warp"] += 1
            pw_single = PW.warp_window_counts(m, w, h)
            pw_b = PW.warp_window_counts(mb, w, h)
            for args, expect in (((words[0], m, w, h), pw_single),
                                 ((words[0], m, w, h, words[1], mix), [2 * x for x in pw_single]),
                                 ((words[0], m, w, h, words[1], mix, mb), [x + y for x, y in zip(pw_single, pw_b)])):
                got, want = PW.packed_warp(*args), PW.packed_warp_plain(*args)
                worst["packed_warp"] = max(worst["packed_warp"], float((got - want).abs().max()))
                branches = packed_warp_branches(torch, dev, args)
                check(branches == expect, f"packed_warp {w}x{h} {label}: window/direct {branches}, "
                                          f"warp_window_counts gives {expect}")
                taken = [x + y for x, y in zip(taken, branches)]
                if branches[1]:
                    direct_at.add(label)
                cases["packed_warp"] += 1
    sizes = ", ".join(f"{w}x{h}" for w, h in AXIS_EDGE_SIZES)
    for name in ("warp", "packed_warp"):
        counted = (f"; window/direct (tile, source) pairs {taken}, equal to the plain mirror's launch by launch; "
                   f"direct branch at {sorted(direct_at)}") if name == "packed_warp" else ""
        print(f"{name} window edges: {cases[name]} cases ({', '.join(AXIS_EDGE_MATS)} at {sizes}) max |kernel - "
              f"plain| = {worst[name]:.3e} (== 0){counted}")
        check(worst[name] == 0.0, f"{name} window edges differ from the plain version by {worst[name]}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], worst[name])
        rec[name]["window_edges"] = dict(cases=cases[name])
    check(min(taken) > 0, f"packed_warp window edges: window/direct pairs {taken}, both branches expected")
    check("minify_0.25" in direct_at, "packed_warp: the 0.25 box did not reach the direct branch")
    rec["packed_warp"]["window_edges"]["window_direct"] = taken
    torch.cuda.synchronize()


def rotation_matrix(w: int, h: int, degrees: float, scale: float = 0.9, offset_x: float = 0.0):
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    return transform_matrix(w, h, rotate=degrees / 360.0, scale_x=scale, scale_y=scale, offset_x=offset_x)


def phase_straggler_kernels(torch, dev, rng, rec: dict) -> None:
    """The straggler channels' kernel modes against their plain versions
    at 1920x1080 (C 4 and 3): rotate single, dissolve pair (one shared
    matrix or two) and wipe pair (one or two matrices) at 25, 100 and -7
    degrees; K4's wipe pairs and distinct-matrix dissolve; the packed
    composite's rgba and both emits over v210 words and over (3, H, W)
    frames (3 dissolve layers)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops import rotate as R
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp, warp_plain

    err = lambda a, b: float((a - b).abs().max())
    frame = lambda c: torch.from_numpy(rng.random((c, H, W), dtype=np.float32)).to(dev)
    a4, b4, a3, b3 = frame(4), frame(4), frame(3), frame(3)
    mask = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    mix = torch.tensor(0.35, device=dev)

    def pair_cases(src, src_b, m, mb):
        return [((src, m), {}), ((src, m, src_b, mix), {}), ((src, m, src_b, mix, mb), {}),
                ((src, m, src_b), dict(mask=mask)), ((src, m, src_b), dict(mat_b=mb, mask=mask))]

    er = 0.0
    for angle in (25, 100, -7):
        m = to_tensor(rotation_matrix(W, H, angle), dev)
        mb = to_tensor(rotation_matrix(W, H, angle + 30, 0.8, 0.05), dev)
        for src, src_b in ((a4, b4), (a3, b3)):
            for args, kw in pair_cases(src, src_b, m, mb):
                er = max(er, err(R.rotate(*args, **kw), R.rotate_plain(*args, **kw)))
    print(f"rotate max |kernel - plain| = {er:.3e} over single, dissolve and wipe pairs (shared and "
          f"distinct matrices), C 4 and 3, 25 / 100 / -7 degrees (<= {TOL_WARP})")
    check(er <= TOL_WARP, f"rotate error {er}")
    rot = to_tensor(rotation_matrix(W, H, 100), dev)
    rec["rotate"] = dict(max_abs_err=er, pair_args=(a4, rot, b4, mix, to_tensor(rotation_matrix(W, H, 95, 0.85), dev)),
                         wipe_args=((a4, rot, b4), dict(mask=mask)))

    m = to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.05), dev)
    mb = to_tensor(transform_matrix(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05), dev)
    e4 = 0.0
    for src, src_b in ((a4, b4), (a3, b3)):
        for args, kw in pair_cases(src, src_b, m, mb)[2:]:
            e4 = max(e4, err(warp(*args, **kw), warp_plain(*args, **kw)))
    print(f"K4 warp wipe pairs (shared and distinct matrices) and distinct-matrix dissolve, C 4 and 3, "
          f"max |kernel - plain| = {e4:.3e} (<= {TOL_WARP})")
    check(e4 <= TOL_WARP, f"warp wipe / distinct error {e4}")
    rec["warp"]["max_abs_err"] = max(rec["warp"]["max_abs_err"], e4)
    rec["warp"]["wipe_args"] = ((a4, m, b4), dict(mask=mask))
    rec["warp"]["distinct_args"] = (a4, m, b4, mix, mb)

    mats = [to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev)
            for i in range(3)]
    mixes = [torch.tensor(0.4 + 0.05 * i, device=dev) for i in range(3)]
    words = [to_tensor(random_words(rng, W, H), dev) for _ in range(6)]
    frames = [frame(3) for _ in range(6)]
    e_rgba, d7 = 0.0, 0
    for kind, srcs in (("packed", words), ("rgb3", frames)):
        args = (srcs, (2, 2, 2), mats, mixes)
        kw = dict(src_kind=kind, size=(W, H))
        packed = PW.packed_composite(*args, **kw)
        for emit in ("rgba", "both"):
            got = PW.packed_composite(*args, emit=emit, **kw)
            want = PW.packed_composite_plain(*args, emit=emit, **kw)
            if emit == "both":
                check(torch.equal(got[0], packed), f"packed_composite {kind}: 'both' words differ from 'packed'")
                d7 = max(d7, code_delta(torch, got[0], want[0], W, H))
                got, want = got[1], want[1]
            check(tuple(got.shape) == (4, H, W) and bool(torch.isfinite(got).all()),
                  f"packed_composite {kind} {emit}: frame {tuple(got.shape)}")
            e_rgba = max(e_rgba, err(got, want))
        if kind == "rgb3":
            rec["packed_composite"]["rgb3_emit_args"] = (args, kw)
    print(f"packed_composite rgba / both emits (v210 words and rgb3, 3 dissolve layers) max |frame - "
          f"plain| = {e_rgba:.3e} (<= {TOL_RGBA}), both's words vs plain {d7} codes (<= {TOL_CODES})")
    check(e_rgba <= TOL_RGBA, f"packed_composite rgba emit error {e_rgba}")
    check(d7 <= TOL_CODES, f"packed_composite both emit code delta {d7}")
    rec["packed_composite"]["max_abs_err"] = max(rec["packed_composite"]["max_abs_err"], float(d7))
    rec["packed_composite"]["rgba_max_abs_err"] = e_rgba
    torch.cuda.synchronize()


def phase_planar_kernels(torch, dev, rng, rec: dict) -> None:
    """The planar kernels of the file-media formats against their plain
    versions at 1920x1080, 1918x1080 (a pitch pad) and 1920x1081 (an odd
    height), on seeded full-range random planes and the fill_buf ramps:
    B10's 10-bit unpack and B12 (yuv420p, nv12) max |delta| 0; B11 (8 and
    10 bit) and B13 (yuv420p, nv12) <= 1 code on random RGBA (C 4 and 3)
    and bit-exact ramp round trips, pitch pad included."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import get_format

    err = lambda a, b: float((a - b).abs().max())
    sizes = ((W, H), (1918, H), (W, H + 1))
    unpacks = {name: (K.planar422_unpack, K.planar422_unpack_plain) for name in ("yuv422p10le", "yuv422p8")}
    unpacks.update({name: (K.planar420_unpack, K.planar420_unpack_plain) for name in ("yuv420p", "nv12")})
    packs = {name: (K.planar422_pack, K.planar422_pack_plain) for name in ("yuv422p10le", "yuv422p8")}
    packs.update({name: (K.planar420_pack, K.planar420_pack_plain) for name in ("yuv420p", "nv12")})
    e_unpack = {"planar422_unpack": 0.0, "planar420_unpack": 0.0}
    d_pack = {"planar422_pack": 0, "planar420_pack": 0}
    for name, (unpack, unpack_plain) in unpacks.items():
        pack, pack_plain = packs[name]
        for w, h in sizes:
            fill = get_format(name).fill_buf(w, h)
            for planes in (format_planes(rng, name, w, h), fill):
                pt = [to_tensor(p, dev) for p in planes]
                e_unpack[unpack.__name__] = max(e_unpack[unpack.__name__], err(
                    unpack(pt, w, h, fmt_name=name), unpack_plain(pt, w, h, fmt_name=name)))
            rgb = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, w)).astype(np.float32)).to(dev)
            ramp = unpack([to_tensor(p, dev) for p in fill], w, h, fmt_name=name)
            for x in (rgb, rgb[:3].contiguous(), ramp):
                d_pack[pack.__name__] = max(d_pack[pack.__name__], plane_delta(
                    torch, pack(x, name), pack_plain(x, name)))
            same = all(np.array_equal(g.cpu().numpy(), f) for g, f in zip(pack(ramp, name), fill))
            print(f"{pack.__name__}({unpack.__name__}(fill_buf)) == fill_buf, {name} {w}x{h}: {same}")
            check(same, f"{name} round trip at {w}x{h}")
    covers = {"planar422_unpack": "yuv422p10le and yuv422p8", "planar420_unpack": "yuv420p and nv12"}
    for name, e in e_unpack.items():
        print(f"{name} ({covers[name]}) max |kernel - plain| = {e:.3e} (<= {TOL_UNPACK}) at "
              f"{', '.join(f'{w}x{h}' for w, h in sizes)}, random planes and ramps")
        check(e <= TOL_UNPACK, f"{name} error {e}")
    for name, d in d_pack.items():
        print(f"{name} max code delta vs plain on random RGBA (C 4 and 3) and the ramps = {d} "
              f"(<= {TOL_CODES})")
        check(d <= TOL_CODES, f"{name} code delta {d}")
    rec["planar422_unpack"]["max_abs_err"] = max(rec["planar422_unpack"]["max_abs_err"],
                                                 e_unpack["planar422_unpack"])
    rec["planar420_unpack"] = dict(max_abs_err=e_unpack["planar420_unpack"])
    for name, d in d_pack.items():
        rec[name] = dict(max_abs_err=float(d))
    torch.cuda.synchronize()


PLANAR_SWEEP = ((1, 1), (2, 1), (3, 2), (130, 7), (1918, 1080), (1920, 1081), (UHD_W, UHD_H))
PLANAR_UNALIGNED = ((130, 7), (1920, 1081))


def phase_planar_unpack_sweep(torch, dev, rng, rec: dict) -> None:
    """The planar unpacks (K3/B10: yuv422p8, yuv422p10le; B12: yuv420p,
    nv12) against their plain versions, max |delta| 0, at every size of
    PLANAR_SWEEP (a partial last quad, odd widths and heights, the 1918
    pitch pad, UHD) on seeded random planes and the fill_buf ramps; and
    with each plane in turn one sample past an aligned address
    (PLANAR_UNALIGNED), which takes the 4:2:2 kernel's one-load-a-sample
    path (fresh planes take its vector loads; 4:2:0 loads a sample at a
    time at any address)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import get_format

    err = lambda a, b: float((a - b).abs().max())
    forms = {"yuv422p8": "planar422_unpack", "yuv422p10le": "planar422_unpack", "yuv420p": "planar420_unpack",
             "nv12": "planar420_unpack"}
    e = {"planar422_unpack": 0.0, "planar420_unpack": 0.0}
    cases = {"planar422_unpack": 0, "planar420_unpack": 0}
    for name, kernel in forms.items():
        unpack, plain = getattr(K, kernel), getattr(K, kernel + "_plain")
        for w, h in PLANAR_SWEEP:
            for planes in (format_planes(rng, name, w, h), get_format(name).fill_buf(w, h)):
                pt = [to_tensor(x, dev) for x in planes]
                want = plain(pt, w, h, fmt_name=name)
                e[kernel] = max(e[kernel], err(unpack(pt, w, h, fmt_name=name), want))
                cases[kernel] += 1
                if (w, h) not in PLANAR_UNALIGNED:
                    continue
                for i, t in enumerate(pt):
                    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
                    moved = buf[1:].view(t.shape)
                    moved.copy_(t)
                    off = pt[:i] + [moved] + pt[i + 1:]
                    e[kernel] = max(e[kernel], err(unpack(off, w, h, fmt_name=name), want))
                    cases[kernel] += 1
    sizes = ", ".join(f"{w}x{h}" for w, h in PLANAR_SWEEP)
    for kernel, x in e.items():
        print(f"{kernel} sweep ({cases[kernel]} cases: {sizes}; random planes and ramps; each plane one sample "
              f"off its alignment at {PLANAR_UNALIGNED}) max |kernel - plain| = {x:.3e} (<= {TOL_UNPACK})")
        check(x <= TOL_UNPACK, f"{kernel} sweep error {x}")
        rec[kernel]["max_abs_err"] = max(rec[kernel]["max_abs_err"], x)
    torch.cuda.synchronize()


RGB8_SIZES = ((UHD_W, UHD_H), (W, H), (1917, 1079), (130, 7), (5, 3))


def phase_rgb8_unpack(torch, dev, rng, rec: dict) -> None:
    """rgb8_unpack (rgba8, bgra8) against its plain version, max |delta|
    0, at every size of RGB8_SIZES (a pixel count not a multiple of 4 at
    1917x1079 and 5x3) on seeded random planes, under the analytic
    transfer (709 -> 709) and the reference LUT (sRGB -> 709), each plane
    also 4 bytes off its 16-byte alignment (the kernel's one-load-a-pixel
    path, chosen in the C entry); one launch a call."""
    from phaneron_tpu_torch.ops import kernels as K

    e, cases = 0.0, 0
    for w, h in RGB8_SIZES:
        plane = torch.from_numpy(rng.integers(0, 256, (h, w, 4), dtype=np.uint8)).to(dev)
        buf = torch.empty(plane.numel() + 4, dtype=torch.uint8, device=dev)
        moved = buf[4:].view(plane.shape)
        moved.copy_(plane)
        for name in ("rgba8", "bgra8"):
            for col_spec, gamma_mode in (("709", "analytic"), ("sRGB", "lut")):
                want = K.rgb8_unpack_plain([plane], w, h, col_spec, "709", name, gamma_mode)
                for src in (plane, moved):
                    before = K.rgb8_unpack.launches
                    got = K.rgb8_unpack([src], w, h, col_spec, "709", name, gamma_mode)
                    check(K.rgb8_unpack.launches == before + 1, f"rgb8_unpack {name} {w}x{h}: launches "
                                                                 f"{K.rgb8_unpack.launches - before}")
                    e = max(e, float((got - want).abs().max()))
                    cases += 1
    sizes = ", ".join(f"{w}x{h}" for w, h in RGB8_SIZES)
    print(f"rgb8_unpack ({cases} cases: rgba8 and bgra8 at {sizes}; random planes, analytic 709 and LUT sRGB; "
          f"each plane also 4 bytes off its alignment) max |kernel - plain| = {e:.3e} (<= {TOL_UNPACK})")
    check(e <= TOL_UNPACK, f"rgb8_unpack error {e}")
    rec["rgb8_unpack"] = dict(max_abs_err=e)
    torch.cuda.synchronize()


def phase_planar_pack_sweep(torch, dev, rng, rec: dict) -> None:
    """The planar packs (B11: yuv422p8, yuv422p10le; B13: yuv420p, nv12)
    against their plain versions at every size of PLANAR_SWEEP (a partial
    last quad, a width not a multiple of 4 and the 1918 pitch pad, odd
    heights, UHD) on seeded random RGBA in [-0.05, 1.05] (C 4 and 3) and
    the decoded fill_buf ramps (whose round trip must be bit-exact, but at
    an odd 4:2:2 width, where fill_buf fills the last pair's missing pixel
    and the pack writes it black); and
    at PLANAR_UNALIGNED with the RGB frame one float past a 16-byte
    boundary, which takes the kernels' one-load-a-pixel path (fresh frames
    of a width that is a multiple of 4 take the 16-byte loads).  Prints
    the max code delta (<= TOL_CODES; the kernels' powf-exact transfer
    makes it the plain version's own rounding differences only)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import get_format

    forms = {"yuv422p8": "planar422", "yuv422p10le": "planar422", "yuv420p": "planar420", "nv12": "planar420"}
    d = {"planar422_pack": 0, "planar420_pack": 0}
    cases = {"planar422_pack": 0, "planar420_pack": 0}
    for name, kind in forms.items():
        pack, plain = getattr(K, kind + "_pack"), getattr(K, kind + "_pack_plain")
        unpack = getattr(K, kind + "_unpack")
        fmt = get_format(name)
        for w, h in PLANAR_SWEEP:
            fill = fmt.fill_buf(w, h)
            ramp = unpack([to_tensor(x, dev) for x in fill], w, h, fmt_name=name)
            if w % 2 == 0 or kind == "planar420":  # an odd 4:2:2 width's fill_buf fills the missing pixel
                same = all(np.array_equal(g.cpu().numpy(), f) for g, f in zip(pack(ramp, name), fill))
                check(same, f"{name} pack sweep: round trip at {w}x{h}")
            rgba = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, w)).astype(np.float32)).to(dev)
            frames = [ramp, rgba, rgba[:3].contiguous()]
            if (w, h) in PLANAR_UNALIGNED:
                buf = torch.empty(rgba.numel() + 1, dtype=torch.float32, device=dev)
                moved = buf[1:].view(rgba.shape)
                moved.copy_(rgba)
                frames.append(moved)
            for x in frames:
                d[pack.__name__] = max(d[pack.__name__], plane_delta(torch, pack(x, name), plain(x, name)))
                cases[pack.__name__] += 1
    sizes = ", ".join(f"{w}x{h}" for w, h in PLANAR_SWEEP)
    for kernel, x in d.items():
        print(f"{kernel} sweep ({cases[kernel]} cases: {sizes}; random RGBA, C 4 and 3, and the decoded ramps, "
              f"round trips bit-exact; the frame one float off its alignment at {PLANAR_UNALIGNED}) max code delta "
              f"vs plain = {x} (<= {TOL_CODES})")
        check(x <= TOL_CODES, f"{kernel} sweep code delta {x}")
        rec[kernel]["max_abs_err"] = max(rec[kernel]["max_abs_err"], float(x))
    torch.cuda.synchronize()


def media_frame(torch, dev, w: int, h: int):
    """The media channel's composited (4, H, W) frame at mix 0.5 (seeded
    inputs, as media_spec_params makes them): what its packs (B11 into
    yuv422p10le, B13 into nv12) read."""
    from phaneron_tpu_torch.graph.pipeline import make_channel_program

    spec, params = media_spec_params(torch, dev, np.random.default_rng(SEED + 5), w, h)
    media_animate(torch, params, dev, 0.5)
    return make_channel_program(spec)(params)["rgba"]


def captured_call(torch, spec, params, kernel: str) -> tuple:
    """The arguments of the first call of ``kernel`` (a field of the
    pipeline's _KERNELS: combine_pack's layers, v210_pack's frame) in one
    frame of the channel program of ``spec``: a kernel's inputs as a
    driven path gives them."""
    from phaneron_tpu_torch.graph import pipeline as P

    seen, kernels = [], P._KERNELS
    real = getattr(kernels, kernel)

    def grab(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    P._KERNELS = kernels._replace(**{kernel: grab})
    try:
        P.make_channel_program(spec)(params)
    finally:
        P._KERNELS = kernels
    return seen[0]


def v210_pack_inputs(torch, dev, sizes=((W, H), (UHD_W, UHD_H))) -> dict:
    """label -> ("k2", (C, H, W) frame) or ("b5", layers): K2's inputs at
    each size, C 3 and 4 (seeded random RGB(A) in [-0.05, 1.05] as
    phase_kernels draws it, the decoded fill_buf ramp) and the one_rotation
    emit_rgba path's composited frame, with the keyed straggler's at
    1920x1080; B5's layers as the entry path (1920x1080, the record), the
    one_rotation and wipe paths (2 RGBA layers at each size) give them,
    and a 4-layer stack mixing RGBA frames and (rgb, wy, wx) layers
    (phase_packed_source_kernels' mixed stack)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp_alpha_vectors

    rng = np.random.default_rng(SEED + 14)
    out = {}
    for w, h in sizes:
        rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, w)).astype(np.float32)).to(dev)
        ramp = K.v210_unpack([to_tensor(v210.fill_buf(w, h)[0], dev)], w, h)[0]
        for c in (3, 4):
            out[f"C {c}, {w}x{h}, random"] = ("k2", rand[:c].contiguous())
            out[f"C {c}, {w}x{h}, the decoded fill_buf ramp"] = ("k2", ramp[:c].contiguous())
        for variant in ("one_rotation", "wipe"):
            spec, params = straggler_spec_params(torch, dev, w, h, variant)
            straggler_animate(torch, params, dev, w, h, variant, 0.5)
            out[f"2 RGBA layers, {w}x{h}, {variant} path"] = ("b5", captured_call(torch, spec, params, "combine_pack")[0])
        spec, params = straggler_spec_params(torch, dev, w, h, "one_rotation", emit_rgba=True)
        straggler_animate(torch, params, dev, w, h, "one_rotation", 0.5)
        out[f"C 4, {w}x{h}, one_rotation emit_rgba path"] = ("k2", captured_call(torch, spec, params, "v210_pack")[0])
    spec, params = keyed_straggler_spec_params(torch, dev, rng, W, H)
    keyed_straggler_animate(torch, params, dev, 0.5)
    out[f"C 4, {W}x{H}, keyed_straggler path"] = ("k2", captured_call(torch, spec, params, "v210_pack")[0])
    spec, params = entry_spec_params(rng, dev)
    animate(torch, params, dev, 0.5)
    entry = captured_call(torch, spec, params, "combine_pack")[0]
    out[f"2 RGBA layers, {W}x{H}, entry path"] = ("b5", entry)
    fa, fb = K.v210_unpack([to_tensor(random_words(rng, W, H), dev) for _ in range(2)], W, H)
    m = to_tensor(transform_matrix(W, H, scale_x=0.9, offset_x=0.05), dev)
    mb = to_tensor(transform_matrix(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05), dev)
    out[f"4 layers, RGBA and (rgb, wy, wx), {W}x{H}"] = ("b5", [
        fa, (fb[:3].contiguous(), *warp_alpha_vectors(H, W, m)), entry[0],
        (fa[:3].contiguous(), *warp_alpha_vectors(H, W, mb))])
    return out


def v210_pack_bytes_ops(torch, kind: str, x) -> tuple[float, float]:
    """Least bytes and operations of a K2 or B5 call: every layer's
    planes read once (layer 0's R, G and B; then RGBA, or RGB with wx and
    wy), the words written once; the 'over' of each layer above the first
    and the encode per pixel."""
    from phaneron_tpu_torch.ops.formats.v210 import pitch_bytes

    layers = [x] if kind == "k2" else list(x)
    first = layers[0][0] if isinstance(layers[0], tuple) else layers[0]
    _, h, w = first.shape
    nbytes, ops = 12.0 * h * w + h * pitch_bytes(w), OPS_ENCODE_PX * h * w
    for f in layers[1:]:
        nbytes += 12.0 * h * w + 4 * (h + w) if isinstance(f, tuple) else 16.0 * h * w
        ops += h * w * (1 + 3 * OPS_OVER + (1 if isinstance(f, tuple) else 0))
    return nbytes, ops


# the v210_pack_inputs labels that timed_shapes times (the 1920x1080
# records K2 (3, H, W) and (4, H, W) and B5's entry layers are timed apart)
V210_TIMED = ("C 3, 3840x2160, random", "C 4, 3840x2160, random", "C 4, 1920x1080, one_rotation emit_rgba path",
              "C 4, 1920x1080, keyed_straggler path", "4 layers, RGBA and (rgb, wy, wx), 1920x1080",
              "2 RGBA layers, 1920x1080, one_rotation path", "2 RGBA layers, 3840x2160, one_rotation path",
              "2 RGBA layers, 1920x1080, wipe path", "2 RGBA layers, 3840x2160, wipe path")


# (form, content) at 1920x1080 that a kernel record or a media-path mode
# already times: K3's and B12's records, the media channel's sources
PLANAR_TIMED_1080 = {("yuv422p8", "the fill_buf ramp"), ("yuv420p", "the fill_buf ramp"),
                     ("yuv422p10le", "random planes"), ("nv12", "random planes")}
# the packs' records: (form, content) at 1920x1080
PACK_TIMED_1080 = {("yuv422p10le", "the media frame"), ("nv12", "the media frame")}


def timed_shapes(torch, dev) -> dict:
    """label -> (kernel call, plain call, bytes, operations): the timed
    shapes that need no state of main(), printed beside the records.  Now
    the planar unpacks in every form at 1920x1080 (but PLANAR_TIMED_1080)
    and 3840x2160, on seeded random planes and the fill_buf ramps; the
    planar packs in every form at both sizes (but PACK_TIMED_1080), C 4,
    on seeded random RGBA, the decoded fill_buf ramp and the media
    channel's frame (media_frame); and K2 and B5 at the V210_TIMED
    inputs of v210_pack_inputs.  tools/compare_parent.py times on a
    parent's kernels the labels that its own timed_shapes lacks."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import get_format

    rng = np.random.default_rng(SEED + 12)
    shapes = {}
    for w, h in ((W, H), (UHD_W, UHD_H)):
        for name, kernel in (("yuv422p8", "planar422_unpack"), ("yuv422p10le", "planar422_unpack"),
                             ("yuv420p", "planar420_unpack"), ("nv12", "planar420_unpack")):
            fmt = get_format(name)
            sample_bytes = 2 if fmt.INFO.num_bits > 8 else 1
            samples = (2.0 if name.startswith("yuv422") else 1.5) * h * fmt.pitch(w) * sample_bytes
            for content, planes in (("random planes", format_planes(rng, name, w, h)),
                                    ("the fill_buf ramp", fmt.fill_buf(w, h))):
                if (w, h) == (W, H) and (name, content) in PLANAR_TIMED_1080:
                    continue
                args = ([to_tensor(x, dev) for x in planes], w, h, "709", "709", name)
                fn, plain = getattr(K, kernel), getattr(K, kernel + "_plain")
                shapes[f"{kernel} ({name}, {w}x{h}, {content})"] = (
                    lambda fn=fn, args=args: fn(*args), lambda plain=plain, args=args: plain(*args),
                    samples + 16 * w * h, OPS_DECODE_PX * w * h)
        media = media_frame(torch, dev, w, h)
        for name, kind in (("yuv422p8", "planar422"), ("yuv422p10le", "planar422"), ("yuv420p", "planar420"),
                           ("nv12", "planar420")):
            fmt = get_format(name)
            sample_bytes = 2 if fmt.INFO.num_bits > 8 else 1
            c_rows = h if kind == "planar422" else (h + 1) // 2
            samples = (h + c_rows) * fmt.pitch(w) * sample_bytes
            ops = (OPS_ENCODE_PX if kind == "planar422" else OPS_ENCODE_420_PX) * w * h
            unpack = getattr(K, kind + "_unpack")
            ramp = unpack([to_tensor(x, dev) for x in fmt.fill_buf(w, h)], w, h, "709", "709", name)
            rgba = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, w)).astype(np.float32)).to(dev)
            for content, frame in (("random RGBA", rgba), ("the decoded fill_buf ramp", ramp),
                                   ("the media frame", media)):
                if (w, h) == (W, H) and (name, content) in PACK_TIMED_1080:
                    continue
                fn, plain = getattr(K, kind + "_pack"), getattr(K, kind + "_pack_plain")
                shapes[f"{kind}_pack ({name}, {w}x{h}, {content})"] = (
                    lambda fn=fn, x=frame, name=name: fn(x, name), lambda plain=plain, x=frame, name=name: plain(x, name),
                    12 * w * h + samples, ops)
    inputs = v210_pack_inputs(torch, dev)
    for label in V210_TIMED:
        kind, x = inputs[label]
        fn, plain = (K.v210_pack, K.v210_pack_plain) if kind == "k2" else (K.combine_pack, K.combine_pack_plain)
        shapes[f"{'v210_pack' if kind == 'k2' else 'combine_pack'} ({label})"] = (
            lambda fn=fn, x=x: fn(x), lambda plain=plain, x=x: plain(x), *v210_pack_bytes_ops(torch, kind, x))
    return shapes


def phase_stage_program_checks(torch, dev, rng) -> None:
    """The stage programs of every format against their plain versions at
    1920x1080: make_unpack_program at channels 3 and 4 (max |delta| 0),
    make_pack_program, make_interlaced_pack_program("yuv420p") and
    make_interlaced_word_pack_program("yuv422p10le") against the
    interleave-then-pack it replaces (<= 1 code)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.graph.pipeline import (
        make_interlaced_pack_program,
        make_interlaced_word_pack_program,
        make_pack_program,
        make_unpack_program,
    )

    e, d = 0.0, 0
    rgba = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, H, W)).astype(np.float32)).to(dev)
    for fmt in FORMAT_NAMES:
        planes = [to_tensor(p, dev) for p in format_planes(rng, fmt, W, H)]
        for ch in (3, 4):
            got = make_unpack_program(fmt, W, H, "709", "709", channels=ch)(planes)
            want = make_unpack_program(fmt, W, H, "709", "709", channels=ch, plain=True)(planes)
            check(tuple(got.shape) == (ch, H, W), f"unpack program {fmt}: {tuple(got.shape)}")
            e = max(e, float((got - want).abs().max()))
        got = make_pack_program(fmt, W, H, "709")(rgba)
        d = max(d, packed_delta(torch, fmt, got, make_pack_program(fmt, W, H, "709", plain=True)(rgba), W, H))
    top, bottom = rgba, torch.from_numpy(rng.uniform(0.0, 1.0, (4, H, W)).astype(np.float32)).to(dev)
    d = max(d, plane_delta(torch, make_interlaced_pack_program("yuv420p", W, H, "709")(top, bottom),
                           make_interlaced_pack_program("yuv420p", W, H, "709", plain=True)(top, bottom)))
    pack = make_pack_program("yuv422p10le", W, H, "709")
    word = make_interlaced_word_pack_program("yuv422p10le")(pack(top), pack(bottom))
    d = max(d, plane_delta(torch, word, make_interlaced_pack_program(
        "yuv422p10le", W, H, "709", plain=True)(top, bottom)))
    print(f"stage programs of {', '.join(FORMAT_NAMES)}: unpack (C 3 and 4) max |kernel - plain| = {e:.3e} "
          f"(<= {TOL_UNPACK}); pack, interlaced yuv420p pack and yuv422p10le word pack max code delta "
          f"vs plain = {d} (<= {TOL_CODES})")
    check(e <= TOL_UNPACK, f"unpack stage programs error {e}")
    check(d <= TOL_CODES, f"pack stage programs code delta {d}")
    torch.cuda.synchronize()


def check_planes(torch, fmt: str, planes, w: int, h: int, what: str) -> None:
    """The output planes have the format's shapes and sample types."""
    from phaneron_tpu_torch.ops.formats import get_format
    from phaneron_tpu_torch.ops.formats.v210 import pitch_bytes

    if fmt == "v210":
        want = [((h, pitch_bytes(w) // 4), "int32")]
    else:
        want = [(tuple(s), str(np.dtype(dt))) for s, dt in get_format(fmt).plane_shapes(w, h)]
    got = [(tuple(p.shape), str(p.dtype).removeprefix("torch.")) for p in planes]
    check(got == want, f"{what}: {fmt} planes {got}, expected {want}")


def graphic_rgba8(w: int, h: int) -> np.ndarray:
    """A keyed image-sequence lower third, (H, W, 4) rgba8, premultiplied:
    alpha 255 in a band of rows, 128 on the rows at its edges, 0
    elsewhere; red ramps across the frame."""
    alpha = np.zeros(h, np.float64)
    top, bottom = int(0.7 * h), int(0.85 * h)
    alpha[top:bottom] = 255.0
    alpha[[top - 1, bottom]] = 128.0
    colour = np.stack(np.broadcast_arrays(np.linspace(20, 235, w)[None, :], 160.0, 60.0), -1)
    px = np.zeros((h, w, 4), np.uint8)
    px[..., :3] = np.round(colour * alpha[:, None, None] / 255.0)
    px[..., 3] = alpha[:, None]
    return px


def media_spec_params(torch, dev, rng, w: int, h: int):
    """The file-media channel at w x h: L0 a yuv422p10le clip (seeded
    random 10-bit planes; the FFmpeg producer's ProRes / DNxHR format) as
    a cut; L1 the yuv420p ramp (H.264 / HEVC) under a picture-in-picture
    DVE (scale 0.5, offset (0.2, -0.15)) dissolving to seeded random nv12
    planes (hardware decode) under the same matrix; L2 the rgba8 lower
    third (image sequence) as a cut.  yuv422p10le out, emit_rgba."""
    from phaneron_tpu_torch.graph.convert import params_from_numpy
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import yuv420p
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    spec = ChannelSpec(w, h, "yuv422p10le", layers=(
        LayerSpec("yuv422p10le"),
        LayerSpec("yuv420p", transition="dissolve", has_transform=True, axis_aligned=True,
                  src_b_format="nv12"),
        LayerSpec("rgba8"),
    ), emit_rgba=True)
    params = params_from_numpy({"layers": [
        {"src": format_planes(rng, "yuv422p10le", w, h)},
        {"src": yuv420p.fill_buf(w, h), "src_b": format_planes(rng, "nv12", w, h),
         "matrix": transform_matrix(w, h, **MEDIA_DVE), "mix": np.float32(0.0)},
        {"src": [graphic_rgba8(w, h)]},
    ]}, dev)
    return spec, params


def media_animate(torch, params, dev, t: float) -> None:
    params["layers"][1]["mix"] = torch.tensor(t, dtype=torch.float32, device=dev)


class MediaChannel:
    """One frame of the media channel's device work: the channel program,
    then its rgba frame through the preview consumer's stage program
    (rgba8, sRGB) and a file consumer's (nv12, 709).  ``plain=True`` runs
    every stage's plain version on the card."""

    def __init__(self, spec, plain: bool):
        from phaneron_tpu_torch.graph.pipeline import make_channel_program, make_pack_program

        self.program = make_channel_program(spec, plain=plain)
        self.preview = make_pack_program("rgba8", spec.width, spec.height, "sRGB", plain=plain)
        self.file = make_pack_program("nv12", spec.width, spec.height, "709", plain=plain)

    def __call__(self, params) -> tuple:
        out = self.program(params)
        return out, self.preview(out["rgba"]), self.file(out["rgba"])


def drive_media(torch, media, plain_media, params, dev, frames: int, w: int, h: int, what: str) -> int:
    """``frames`` frames of the media channel, the mix animating 0 -> 1,
    each checked against the plain path on the card: the packed
    yuv422p10le, preview and file planes (shapes, types, <= 1 code) and
    the rgba frame (finite, within TOL_RGBA, alpha the graphic's)."""
    from phaneron_tpu_torch.graph.pipeline import make_unpack_program

    top = make_unpack_program("rgba8", w, h, "709", "709", plain=True)(params["layers"][2]["src"])[3]
    worst = 0
    for f in range(frames):
        media_animate(torch, params, dev, f / max(frames - 1, 1))
        (out, preview, filed), (ref, ref_preview, ref_file) = media(params), plain_media(params)
        for fmt, planes in (("yuv422p10le", out["packed"]), ("rgba8", preview), ("nv12", filed)):
            check_planes(torch, fmt, planes, w, h, f"{what} frame {f}")
        d = max(plane_delta(torch, out["packed"], ref["packed"]), plane_delta(torch, preview, ref_preview),
                plane_delta(torch, filed, ref_file))
        worst = max(worst, d)
        check(d <= TOL_CODES, f"{what} frame {f}: kernel path {d} codes from the plain path")
        rgba = out["rgba"]
        check(tuple(rgba.shape) == (4, h, w) and bool(torch.isfinite(rgba).all()),
              f"{what} frame {f}: rgba {tuple(rgba.shape)}")
        e = float((rgba - ref["rgba"]).abs().max())
        check(e <= TOL_RGBA, f"{what} frame {f}: rgba {e} from the plain path")
        ea = float((rgba[3] - top).abs().max())
        check(ea <= TOL_WARP, f"{what} frame {f}: emitted alpha {ea} from the graphic's")
    return worst


def straggler_spec_params(torch, dev, w: int, h: int, variant: str, emit_rgba: bool = False):
    """bench.py composite_variant_step at w x h: 3 v210 DVE + dissolve
    layers (scale 0.9, offset_x 0.02 + 0.003 i, mix 0.4 + 0.05 i) under one
    straggler: 'one_rotation' a v210 cut rotated 100 degrees at scale 0.9,
    'wipe' a v210 wipe with DVE (scale 0.9, offset_x 0.05; src, src_b and
    mask v210), 'rotated_pair' a v210 dissolve rotated under two distinct
    matrices (100 and 95 degrees).  Every slot its own source: the v210
    ramp rolled by 17 k + 3 words (7, 9 and 8 sources)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    base = v210.fill_buf(w, h)[0]
    k = iter(range(16))
    src = lambda: [to_tensor(np.roll(base, 17 * (next(k) + 1) + 3, axis=1), dev)]
    diss = LayerSpec("v210", transition="dissolve", has_transform=True, axis_aligned=True,
                     src_b_format="v210")
    layers = [
        {"src": src(), "src_b": src(),
         "matrix": to_tensor(transform_matrix(w, h, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev),
         "mix": torch.tensor(0.4 + 0.05 * i, device=dev)}
        for i in range(3)
    ]
    if variant == "one_rotation":
        top = LayerSpec("v210", has_transform=True, axis_aligned=False)
        layers.append({"src": src(), "matrix": to_tensor(rotation_matrix(w, h, 100), dev)})
    elif variant == "wipe":
        top = LayerSpec("v210", transition="wipe", has_transform=True, axis_aligned=True,
                        mask_format="v210", src_b_format="v210")
        layers.append({"src": src(), "src_b": src(), "mask": src(),
                       "matrix": to_tensor(transform_matrix(w, h, scale_x=0.9, scale_y=0.9, offset_x=0.05), dev)})
    else:
        top = LayerSpec("v210", transition="dissolve", has_transform=True, axis_aligned=False,
                        src_b_format="v210", warp_same_mat=False)
        layers.append({"src": src(), "src_b": src(), "matrix": to_tensor(rotation_matrix(w, h, 100), dev),
                       "matrix_b": to_tensor(rotation_matrix(w, h, 95, 0.85), dev),
                       "mix": torch.tensor(0.6, device=dev)})
    return ChannelSpec(w, h, "v210", layers=(diss,) * 3 + (top,), emit_rgba=emit_rgba), {"layers": layers}


def straggler_animate(torch, params, dev, w: int, h: int, variant: str, t: float) -> None:
    """The run's mixes move, and the rotated layers turn (100 -> 120
    degrees); the wipe's mask is a source and stays."""
    lps = params["layers"]
    for i, lp in enumerate(lps[:3]):
        lp["mix"] = torch.tensor(0.4 + 0.05 * i + 0.2 * t, dtype=torch.float32, device=dev)
    if variant != "wipe":
        lps[3]["matrix"] = torch.from_numpy(rotation_matrix(w, h, 100 + 20 * t)).to(dev)
    if variant == "rotated_pair":
        lps[3]["matrix_b"] = torch.from_numpy(rotation_matrix(w, h, 95 - 20 * t, 0.85)).to(dev)
        lps[3]["mix"] = torch.tensor(0.6 - 0.3 * t, dtype=torch.float32, device=dev)


def top_alpha(torch, spec, params):
    """The emitted alpha a channel owes: its top layer's, the separable
    wy x wx of an axis-aligned warp or the rotated plane of ones, from the
    plain versions."""
    from phaneron_tpu_torch.ops.rotate import rotate_plain
    from phaneron_tpu_torch.ops.warp import warp_alpha_vectors

    mat = params["layers"][-1]["matrix"]
    if spec.layers[-1].axis_aligned:
        wy, wx = warp_alpha_vectors(spec.height, spec.width, mat)
        return wy[:, None] * wx[None, :]
    ones = torch.ones((1, spec.height, spec.width), dtype=torch.float32, device=mat.device)
    return rotate_plain(ones, mat)[0]


def entry_spec_params(rng, dev):
    """The entry() structure at 1080p: a v210 dissolve with an
    axis-aligned DVE under a plain yuv422p8 layer."""
    from phaneron_tpu_torch.graph.convert import params_from_numpy
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import v210, yuv422p8
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    spec = ChannelSpec(
        W, H, "v210",
        layers=(
            LayerSpec("v210", transition="dissolve", has_transform=True,
                      axis_aligned=True, src_b_format="v210"),
            LayerSpec("yuv422p8"),
        ),
    )
    params = params_from_numpy(
        {
            "layers": [
                {
                    "src": v210.fill_buf(W, H),
                    "src_b": [random_words(rng, W, H)],
                    "matrix": transform_matrix(W, H, scale_x=0.9, offset_x=0.05),
                    "mix": np.float32(0.5),
                },
                {"src": yuv422p8.fill_buf(W, H)},
            ]
        },
        dev,
    )
    return spec, params


def animate(torch, params, dev, t: float) -> None:
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    s = 0.90 + 0.10 * t
    layer = params["layers"][0]
    layer["matrix"] = torch.from_numpy(
        transform_matrix(W, H, scale_x=s, scale_y=s, offset_x=0.05 * (1.0 - t))
    ).to(dev)
    layer["mix"] = torch.tensor(t, dtype=torch.float32, device=dev)


def progressive_spec_params(torch, dev, rng, w: int, h: int):
    """bench.py composite_step at w x h: 4 DVE + dissolve layers, each its
    own axis-aligned matrix, over 8 distinct v210 sources (4 fill_buf
    ramps rolled by whole groups, 4 seeded random word frames; each
    dissolve goes from a ramp to random words), v210 out."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    base = v210.fill_buf(w, h)[0]
    ramps = [to_tensor(np.roll(base, 4 * 11 * (k + 1), axis=1), dev) for k in range(4)]
    noise = [to_tensor(random_words(rng, w, h), dev) for _ in range(4)]
    layer = LayerSpec("v210", transition="dissolve", has_transform=True, axis_aligned=True,
                      src_b_format="v210")
    spec = ChannelSpec(w, h, "v210", layers=(layer,) * 4)
    params = {"layers": [
        {"src": [ramps[i]], "src_b": [noise[i]],
         "matrix": to_tensor(transform_matrix(w, h, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev),
         "mix": torch.tensor(0.4 + 0.05 * i, device=dev)}
        for i in range(4)
    ]}
    return spec, params


def progressive_animate(torch, params, dev, t: float) -> None:
    for i, lp in enumerate(params["layers"]):
        lp["mix"] = torch.tensor(0.4 + 0.05 * i + 0.2 * t, dtype=torch.float32, device=dev)


def playout_spec_params(torch, dev, rng, w: int, h: int, dissolve: bool):
    """PLAY 1-10 clip (a v210 cut) or PLAY 1-10 clip2 MIX (a dissolve from
    the fill_buf ramp to seeded random words), no DVE, v210 out."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import v210

    clip = to_tensor(random_words(rng, w, h), dev)
    if not dissolve:
        return ChannelSpec(w, h, "v210", layers=(LayerSpec("v210"),)), {"layers": [{"src": [clip]}]}
    spec = ChannelSpec(w, h, "v210", layers=(LayerSpec("v210", transition="dissolve", src_b_format="v210"),))
    ramp = to_tensor(v210.fill_buf(w, h)[0], dev)
    return spec, {"layers": [{"src": [ramp], "src_b": [clip], "mix": torch.tensor(0.0, device=dev)}]}


def playout_animate(torch, params, dev, t: float) -> None:
    if "mix" in params["layers"][0]:
        params["layers"][0]["mix"] = torch.tensor(t, dtype=torch.float32, device=dev)


def drive_frames(torch, program, plain_program, params, animate, frames: int, w: int, h: int,
                 what: str, alpha=None, fmt: str = "v210") -> int:
    """``frames`` animated frames of a channel program into ``fmt``, each
    checked against the plain program on the card (planes of the
    format's shapes and types, <= 1 code); returns the worst code delta.
    ``alpha`` (params -> (H, W) plane): an emit_rgba channel, whose frame
    must be finite, within TOL_RGBA of the plain path's and carry that
    alpha, the top layer's."""
    worst = 0
    for f in range(frames):
        animate(f / max(frames - 1, 1))
        out = program(params)
        ref = plain_program(params)
        if alpha is not None:
            rgba, ref_rgba = out["rgba"], ref["rgba"]
            check(tuple(rgba.shape) == (4, h, w) and rgba.dtype == torch.float32
                  and bool(torch.isfinite(rgba).all()), f"{what} frame {f}: rgba {tuple(rgba.shape)}")
            e = float((rgba - ref_rgba).abs().max())
            check(e <= TOL_RGBA, f"{what} frame {f}: rgba {e} from the plain path")
            ea = float((rgba[3] - alpha(params)).abs().max())
            check(ea <= TOL_WARP, f"{what} frame {f}: emitted alpha {ea} from the top layer's")
            out, ref = out["packed"], ref["packed"]
        check_planes(torch, fmt, out, w, h, f"{what} frame {f}")
        d = packed_delta(torch, fmt, out, ref, w, h)
        worst = max(worst, d)
        check(d <= TOL_CODES, f"{what} frame {f}: kernel path {d} codes from the plain path")
    return worst


def time_frame(torch, card: str, what: str, program, plain_program, params, extra=None) -> dict:
    """Kernel and plain ms per frame (in turns), the frame latency, and
    ``extra`` (name -> callable) timed beside them."""
    frame_ms, plain_ms = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "plain":
            plain_ms.append(time_ms(torch, lambda: plain_program(params), batches=3, calls=2, warmup=1))
        else:
            frame_ms.append(time_ms(torch, lambda: program(params)))
    out = dict(ms=statistics.median(frame_ms), runs=frame_ms, plain_ms=statistics.median(plain_ms),
               plain_runs=plain_ms, latency_ms=latency_ms(torch, lambda: program(params)))
    line = (f"{what} frame ms on {card}: kernel path {out['ms']:.4f} (runs {frame_ms}), latency "
            f"{out['latency_ms']:.4f}, plain path {out['plain_ms']:.4f} (runs {plain_ms})")
    for name, fn in (extra or {}).items():
        out[name] = time_ms(torch, fn)
        line += f", {name} {out[name]:.4f}"
    print(line)
    return out


def interlaced_spec(deinterlace: bool = False):
    """One 1080i50 channel of the default load: 4 DVE + dissolve layers
    over opaque 3-channel fields (bench.py interlaced_channels_step)."""
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.runtime.frame import RGBA_F32

    layer = LayerSpec(RGBA_F32, transition="dissolve", has_transform=True, axis_aligned=True,
                      src_b_format=RGBA_F32, src_opaque=True, deinterlace=deinterlace)
    return ChannelSpec(W, H, "v210", layers=(layer,) * 4, tff=TFF)


def interlaced_inputs(torch, dev, rng) -> list:
    """Per channel: 8 distinct seeded v210 sources, each PERIODS + 2
    frames on the card (the source moving ROW_STEP rows a period), a
    distinct axis-aligned matrix per layer and the animated mixes."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    chans = []
    for c in range(N_CHANNELS):
        frames = []
        for _ in range(N_SOURCES):
            base = to_tensor(random_words(rng, W, H), dev)
            frames.append([torch.roll(base, ROW_STEP * k, dims=0) for k in range(PERIODS + 2)])
        mats = [
            to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9,
                                       offset_x=0.02 + 0.003 * i + 0.0007 * c), dev)
            for i in range(4)
        ]
        mixes = [
            [[torch.tensor(0.1 + 0.05 * i + 0.6 * (2 * p + t) / (2 * PERIODS - 1),
                           dtype=torch.float32, device=dev) for i in range(4)] for t in (0, 1)]
            for p in range(PERIODS)
        ]
        chans.append(dict(frames=frames, mats=mats, mixes=mixes))
    return chans


class InterlacedLoad:
    """The default load's device work, one frame period per call, as
    bench.py interlaced_channels_step: per channel and period, 8 unpacks
    to 3 channels, 8 ring advances, 8 pair deinterlaces, 2 channel-program
    ticks, 1 packed-domain field interleave.  ``plain=True`` runs every
    stage's plain version on the card.  ``stage(name)`` is entered around
    each stage (a profiler range in tools/port_profile.py; nothing by
    default)."""

    def __init__(self, chans: list, plain: bool):
        from phaneron_tpu_torch.graph.pipeline import (
            make_channel_program,
            make_interlaced_word_pack_program,
            make_unpack_program,
            make_yadif_pair_field_program,
        )

        self.chans = chans
        self.unpack = make_unpack_program("v210", W, H, "709", "709", channels=3, plain=plain)
        self.pair = make_yadif_pair_field_program(H, W, TFF, channels=3, plain=plain)
        self.program = make_channel_program(interlaced_spec(), plain=plain)
        self.word_pack = make_interlaced_word_pack_program("v210")
        # two aged frames per ring before the first period
        self.rings = [[[self.unpack([f[k]]) for k in range(2)] for f in ch["frames"]] for ch in chans]
        self.period_index = 0
        self.stage = lambda name: contextlib.nullcontext()

    def tick_params(self, ch: dict, fields: list, p: int, t: int) -> dict:
        return {"layers": [
            {"src": fields[2 * i][t], "src_b": fields[2 * i + 1][t], "matrix": ch["mats"][i],
             "mix": ch["mixes"][p][t][i]}
            for i in range(4)
        ]}

    def __call__(self) -> list:
        p = self.period_index % PERIODS
        self.period_index += 1
        outs = []
        for ch, rings in zip(self.chans, self.rings):
            fields = []
            for frames, ring in zip(ch["frames"], rings):
                with self.stage("unpack"):
                    ring.append(self.unpack([frames[p + 2]]))
                del ring[:-3]
                with self.stage("yadif_pair"):
                    fields.append(self.pair(*ring))
            ticks = []
            for t in (0, 1):
                with self.stage("tick"):
                    ticks.append(self.program(self.tick_params(ch, fields, p, t)))
            with self.stage("word_pack"):
                outs.append(self.word_pack(*ticks)[0])
        return outs


def recording_consumer():
    """A Consumer (consumer/consumer.py) that counts the frames delivered
    to it, keeps the last one and, on an interlaced channel, pairs the
    field ticks into interlaced frames (``_init_field_pairing``) and keeps
    the last pair."""
    from phaneron_tpu_torch.consumer.consumer import Consumer

    class Recording(Consumer):
        async def initialise(self, fmt):
            await super().initialise(fmt)
            if fmt.interlaced:
                self._init_field_pairing(fmt)
            self.delivered, self.frame, self.paired, self.pair = 0, None, 0, None

        async def deliver(self, frame):
            self.delivered += 1
            self.frame = frame
            if self._word_pair is not None:
                out = self._pair_field(frame, frame.timestamp)
                if out is not None:
                    self.paired += 1
                    self.pair = out[0][0]

    return Recording()


async def runtime_channel(dev, chan_id: int, fmt, plain: bool):
    """A port Channel on the card (kernels, or ``plain`` for the reference
    set) with its own test-pattern registry and a recording consumer."""
    from phaneron_tpu_torch.producer.producer import ProducerRegistry
    from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
    from phaneron_tpu_torch.runtime.channel import Channel

    ch = Channel(chan_id, fmt, ProducerRegistry([create_test_pattern_producer]), device=dev, plain=plain)
    consumer = recording_consumer()
    await ch.add_consumer(consumer)
    return ch, consumer


async def runtime_dissolve(ch, num: int, url_a: str, url_b: str, fill=None) -> None:
    """LOAD ``url_a`` on layer ``num`` and PLAY it, then a long MIX to
    ``url_b`` (RUNTIME_DISSOLVE_TICKS, so every measured tick is
    mid-dissolve), each source under MIXER FILL ``fill`` where given:
    Layer.set_fill sets the playing source's mixer, and the incoming
    source's own mixer gets the same box."""
    from phaneron_tpu_torch.producer.producer import LoadParams
    from phaneron_tpu_torch.runtime.types import TransitionSpec

    check(await ch.load_source(num, LoadParams(url_a)), f"runtime: LOAD {url_a}")
    check(ch.play(num), f"runtime: PLAY {num}")
    if fill is not None:
        check(ch.layer(num).set_fill(*fill), f"runtime: MIXER {num} FILL")
    check(await ch.load_source(num, LoadParams(url_b), transition=TransitionSpec("dissolve", RUNTIME_DISSOLVE_TICKS)),
          f"runtime: LOAD {url_b} MIX")
    if fill is not None:
        ch.layer(num).next.mixer.set_fill(*fill)
    check(ch.play(num), f"runtime: PLAY {num} MIX")


async def runtime_tick(chans) -> list:
    """One tick of each channel through render_frame, delivered to its
    consumer; render_frame raises where Channel.run would log and go on."""
    frames = []
    for ch, consumer in chans:
        frame = await ch.render_frame()
        await consumer.deliver(frame)
        frames.append(frame)
    return frames


async def runtime_structure_change(torch, dev) -> dict:
    """A structure's capture runs off the event loop: kernel channel A,
    warm on entry()'s structure (a replay a tick), ticks on the loop while
    channel B's first frame of a new structure (entry()'s with a yuv420p
    top) prepares, runs and captures on B's worker thread.  A must tick on
    all the while, each frame within TOL_CODES of its plain twin's (ticked
    after), and B's structure must be captured once."""
    import asyncio

    from phaneron_tpu_torch.config import get_video_format
    from phaneron_tpu_torch.graph.replay import graphs
    from phaneron_tpu_torch.producer.producer import LoadParams
    from phaneron_tpu_torch.utils.metrics import tracer

    fmt, box = get_video_format("1080p5000"), (0.05, 0.0, 0.9, 1.0)
    chans = []
    for cid, plain, top in ((40, False, "BARS@yuv422p8"), (41, True, "BARS@yuv422p8"), (42, False, "BARS@yuv420p")):
        ch, consumer = await runtime_channel(dev, cid, fmt, plain)
        await runtime_dissolve(ch, 1, "BARS", "RAMP", box)
        check(await ch.load_source(2, LoadParams(top)) and ch.play(2), f"runtime: LOAD {top}")
        await ch.wait_prewarmed()
        chans.append((ch, consumer))
    a, a_plain, (b_ch, _) = chans
    for _ in range(2):  # A's structure's first (prepared, captured) tick, then one warm
        await runtime_tick([a, a_plain])
    captures = tracer.counters().get("program.graph_captures", 0)

    async def cold():
        t0 = time.perf_counter()
        await runtime_tick(chans[2:])
        return time.perf_counter() - t0

    task = asyncio.ensure_future(cold())
    stamps, frames = [time.perf_counter()], []
    while not task.done():
        frames += await runtime_tick([a])
        stamps.append(time.perf_counter())
    cold_s = await task
    gaps = [y - x for x, y in zip(stamps, stamps[1:])]
    b_spec = b_ch._spec(tuple(b_ch._last_layer_specs[n] for n in sorted(b_ch._last_layer_specs)))
    check(graphs.holds(b_spec, b_ch.device) and graphs.refusals.get(b_spec) is None,
          f"runtime structure change: B's structure not captured ({graphs.refusals.get(b_spec)})")
    check(tracer.counters().get("program.graph_captures", 0) == captures + 1,
          "runtime structure change: B's first frame did not capture once")
    check(len(gaps) >= 5 and max(gaps) < 0.5 * cold_s,
          f"runtime structure change: A ticked {len(gaps)} times in B's {1e3 * cold_s:.1f} ms first frame, "
          f"its longest gap {1e3 * max(gaps, default=0):.1f} ms")
    worst = 0
    for t, frame in enumerate(frames):
        worst = max(worst, runtime_compare(torch, [frame], await runtime_tick([a_plain]), W, H,
                                           f"runtime structure change tick {t}"))
    for ch, _ in chans:
        await ch.shutdown()
    return dict(cold_ms=1e3 * cold_s, a_ticks=len(gaps), a_max_gap_ms=1e3 * max(gaps), worst_codes=worst)


async def runtime_interlaced_set(dev, plain: bool) -> list:
    """The default load through the runtime (configs/quad_1080i_1chip.json):
    per channel four layers, each a dissolve from BARS to RAMP (v210
    patterns) under bench.py's interlaced box; kernel channels, or plain
    ones; prewarmed."""
    from pathlib import Path

    from phaneron_tpu_torch.config import ServerConfig, get_video_format

    cfg = ServerConfig.load(Path(__file__).resolve().parent / "configs" / "quad_1080i_1chip.json")
    chans = []
    for c, cc in enumerate(cfg.channels):
        ch, consumer = await runtime_channel(dev, c + 1, get_video_format(cc.format), plain)
        for i in range(4):
            await runtime_dissolve(ch, i + 1, "BARS", "RAMP", (0.02 + 0.003 * i + 0.0007 * c, 0.0, 0.9, 0.9))
        await ch.wait_prewarmed()
        chans.append((ch, consumer))
    return chans


def runtime_compare(torch, kernel_frames, plain_frames, w: int, h: int, what: str) -> int:
    """Each kernel channel's frame against its plain twin's (<= 1 code);
    returns the worst code delta."""
    from phaneron_tpu_torch.ops.formats.v210 import pitch_bytes

    worst = 0
    for c, (a, b) in enumerate(zip(kernel_frames, plain_frames)):
        words, ref = a.packed[0], b.packed[0]
        check(tuple(words.shape) == (h, pitch_bytes(w) // 4) and words.dtype == torch.int32,
              f"{what} channel {c}: output {tuple(words.shape)} {words.dtype}")
        d = code_delta(torch, words, ref, w, h)
        check(d <= TOL_CODES, f"{what} channel {c}: kernel channel {d} codes from the plain channel")
        worst = max(worst, d)
    return worst


@contextlib.contextmanager
def sync_errors(torch):
    """Any host wait for the card raises inside (torch's sync debug mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def multibox_matrices(w: int, h: int) -> list:
    """The multi-box stack's DVE matrices, bottom to top: three boxes at
    scale 0.5 (top left, top right, bottom left), then the graphic at
    title-safe scale 0.95, centred."""
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    boxes = [transform_matrix(w, h, scale_x=0.5, scale_y=0.5, offset_x=ox, offset_y=oy)
             for ox, oy in QUADRANTS.values()]
    return boxes + [transform_matrix(w, h, scale_x=0.95, scale_y=0.95)]


def check_quadrants(torch, dev, w: int, h: int) -> None:
    """Each box's warped alpha is 1 inside its own quadrant and 0 inside
    the other three (each less a one-pixel feather band)."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops.warp import warp_alpha_vectors

    halves = {"top": slice(1, h // 2 - 1), "bottom": slice(h // 2 + 1, h - 1),
              "left": slice(1, w // 2 - 1), "right": slice(w // 2 + 1, w - 1)}
    for name, mat in zip(QUADRANTS, multibox_matrices(w, h)):
        wy, wx = warp_alpha_vectors(h, w, to_tensor(mat, dev))
        a = wy[:, None] * wx[None, :]
        for q in ("top_left", "top_right", "bottom_left", "bottom_right"):
            inner = a[tuple(halves[p] for p in q.split("_"))]
            ok = bool((inner == 1.0).all()) if q == name else bool((inner == 0.0).all())
            check(ok, f"multibox {w}x{h}: the {name} box's alpha in the {q} quadrant")


def multibox_spec_params(torch, dev, rng, w: int, h: int, out_format: str = "v210", emit_rgba: bool = True):
    """The file-media multi-box channel at w x h (MIXER 1-n FILL over file
    clips, one box per layer): L0 a yuv422p10le clip (seeded random 10-bit
    planes; ProRes / DNxHR) in the top-left quadrant; L1 a 1280x720 yuv420p
    clip (the ramp; H.264, src_size) dissolving to a 1280x720 nv12 clip
    (seeded) under the same matrix, top right; L2 an nv12 clip at channel
    size (seeded; hardware decode), bottom left; L3 the keyed rgba8 lower
    third under a title-safe DVE (scale 0.95, centred)."""
    from phaneron_tpu_torch.graph.convert import params_from_numpy
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import yuv420p

    dve = dict(has_transform=True, axis_aligned=True)
    spec = ChannelSpec(w, h, out_format, layers=(
        LayerSpec("yuv422p10le", **dve),
        LayerSpec("yuv420p", transition="dissolve", src_b_format="nv12", src_size=MULTIBOX_CLIP, **dve),
        LayerSpec("nv12", **dve),
        LayerSpec("rgba8", **dve),
    ), emit_rgba=emit_rgba)
    mats = multibox_matrices(w, h)
    params = params_from_numpy({"layers": [
        {"src": format_planes(rng, "yuv422p10le", w, h), "matrix": mats[0]},
        {"src": yuv420p.fill_buf(*MULTIBOX_CLIP), "src_b": format_planes(rng, "nv12", *MULTIBOX_CLIP),
         "matrix": mats[1], "mix": np.float32(0.0)},
        {"src": format_planes(rng, "nv12", w, h), "matrix": mats[2]},
        {"src": [graphic_rgba8(w, h)], "matrix": mats[3]},
    ]}, dev)
    return spec, params


def multibox_top_alpha(torch, spec, params):
    """The emitted alpha the multi-box channel owes: the graphic's alpha
    warped by its DVE (plain versions)."""
    from phaneron_tpu_torch.graph.pipeline import make_unpack_program
    from phaneron_tpu_torch.ops.warp import warp_plain

    top = params["layers"][-1]
    graphic = make_unpack_program("rgba8", spec.width, spec.height, "709", "709", plain=True)(top["src"])
    return warp_plain(graphic, top["matrix"])[3]


def keyed_straggler_spec_params(torch, dev, rng, w: int, h: int):
    """The keyed graphic over a stack with a straggler, v210 out under
    emit_rgba: L0 the v210 ramp rotated 100 degrees at scale 0.9; L1 and L2
    yuv422p8 clips (seeded) dissolving to nv12 clips (seeded) under one
    matrix each, boxes in the top-left and top-right quadrants; L3 the
    keyed rgba8 lower third under the title-safe DVE.  L1-L2 are one
    rgba-kind run (coverage alpha); the graphic on top stays staged, so
    the frame carries its own warped alpha."""
    from phaneron_tpu_torch.graph.convert import params_from_numpy
    from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
    from phaneron_tpu_torch.ops.formats import v210

    dve = dict(has_transform=True, axis_aligned=True)
    box = LayerSpec("yuv422p8", transition="dissolve", src_b_format="nv12", **dve)
    spec = ChannelSpec(w, h, "v210", layers=(
        LayerSpec("v210", has_transform=True, axis_aligned=False), box, box, LayerSpec("rgba8", **dve),
    ), emit_rgba=True)
    mats = multibox_matrices(w, h)
    params = params_from_numpy({"layers": [
        {"src": v210.fill_buf(w, h), "matrix": rotation_matrix(w, h, 100)},
        *({"src": format_planes(rng, "yuv422p8", w, h), "src_b": format_planes(rng, "nv12", w, h),
           "matrix": mats[i], "mix": np.float32(0.0)} for i in range(2)),
        {"src": [graphic_rgba8(w, h)], "matrix": mats[3]},
    ]}, dev)
    return spec, params


def keyed_straggler_animate(torch, params, dev, t: float) -> None:
    for lp in params["layers"][1:3]:
        lp["mix"] = torch.tensor(t, dtype=torch.float32, device=dev)


def premultiplied_frames(torch, dev, rng, n: int, w: int, h: int) -> list:
    """Seeded premultiplied RGBA (4, H, W) float32 frames: alpha in
    [0, 1], rgb <= alpha."""
    out = []
    for _ in range(n):
        a = rng.random((1, h, w), dtype=np.float32)
        out.append(torch.from_numpy(np.concatenate([rng.random((3, h, w), dtype=np.float32) * a, a])).to(dev))
    return out


def phase_composite_modes(torch, dev, rng, rec: dict) -> None:
    """packed_composite's whole-stack and RGBA modes against their plain
    versions at 1920x1080: the rgba kind (B16's counterpart) over seeded
    premultiplied RGBA frames under the multi-box matrices (a cut, a
    dissolve, two cuts) with coverage and top alpha, emits rgba, both and
    packed; the packed kind with top alpha (B15's) over seeded full-range
    v210 words (4 dissolve layers), emits rgba and both.  A 'both' launch
    equals the 'packed' and 'rgba' launches it fuses."""
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    err = lambda a, b: float((a - b).abs().max())
    cases = {
        "rgba": ((premultiplied_frames(torch, dev, rng, 5, W, H), (1, 2, 1, 1),
                  [to_tensor(m, dev) for m in multibox_matrices(W, H)],
                  [None, torch.tensor(0.35, device=dev), None, None]), dict(src_kind="rgba")),
        "packed": (([to_tensor(random_words(rng, W, H), dev) for _ in range(8)], (2, 2, 2, 2),
                    [to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev)
                     for i in range(4)],
                    [torch.tensor(0.4 + 0.05 * i, device=dev) for i in range(4)]),
                   dict(src_kind="packed", size=(W, H))),
    }
    errs = {}  # (src_kind, emit, alpha) -> max |kernel - plain| (codes for words)
    for kind, (args, kw) in cases.items():
        for alpha in ("coverage", "top") if kind == "rgba" else ("top",):
            words = PW.packed_composite(*args, alpha=alpha, **kw)
            frame = PW.packed_composite(*args, emit="rgba", alpha=alpha, **kw)
            both = PW.packed_composite(*args, emit="both", alpha=alpha, **kw)
            check(torch.equal(both[0], words) and torch.equal(both[1], frame),
                  f"packed_composite {kind} {alpha}: 'both' differs from 'packed' and 'rgba'")
            check(tuple(frame.shape) == (4, H, W) and bool(torch.isfinite(frame).all()),
                  f"packed_composite {kind} {alpha}: frame {tuple(frame.shape)}")
            d = float(code_delta(torch, words, PW.packed_composite_plain(*args, alpha=alpha, **kw), W, H))
            e = err(frame, PW.packed_composite_plain(*args, emit="rgba", alpha=alpha, **kw))
            errs[(kind, "rgba", alpha)] = e
            errs[(kind, "both", alpha)] = max(e, d)
            if kind == "rgba":
                errs[(kind, "packed", alpha)] = d
            print(f"packed_composite ({kind} kind, alpha {alpha}) max |frame - plain| = {e:.3e} "
                  f"(<= {TOL_RGBA}), words vs plain {d:.0f} codes (<= {TOL_CODES})")
            check(e <= TOL_RGBA, f"packed_composite {kind} {alpha} frame error {e}")
            check(d <= TOL_CODES, f"packed_composite {kind} {alpha} code delta {d}")
    rec["composite_modes"] = errs
    torch.cuda.synchronize()


GRAPH_TICKS = 8  # ticks each structure is checked over: the capture's, then replays
GRAPH_HELD = 3  # outputs held across as many later replays
GRAPH_TRACE_TICKS = 20  # ticks the device trace counts launches over
GRAPH_HOST_TICKS = 40  # ticks whose host time is read, replay and eager in turns


def same_bytes(torch, a, b) -> bool:
    """Two tensors of one shape and type hold the same bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def cycled(params: dict, k: int) -> dict:
    """The params of each source's k-th frame: every source plane rolled k
    along its axis 1, as new tensors (each frame of a clip arrives in its
    own planes); the rest as they are."""
    import torch

    def roll(p):  # CUDA has no uint16 roll: the bits, as int16
        return p.view(torch.int16).roll(k, dims=1).view(p.dtype) if p.dtype == torch.uint16 else p.roll(k, dims=1)

    layers = []
    for lp in params["layers"]:
        d = dict(lp)
        for key in ("src", "src_b", "mask"):
            if isinstance(d.get(key), list):
                d[key] = [roll(p) for p in d[key]]
        layers.append(d)
    return {"layers": layers}


def graph_cases(torch, dev, rng) -> list:
    """(name, spec, params, animate(params, t), what the runner does with
    it) for the cell uhd_rec.media's structure and chip_smoke's staged
    structures: 'replay', 'eager' (a torch op holds a tick's tensor) or
    'bypass' (not the staged route)."""
    cases = []
    for w, h in ((UHD_W, UHD_H), (W, H)):
        spec, params = media_spec_params(torch, dev, rng, w, h)
        manimate = lambda p, t: media_animate(torch, p, dev, t)
        cases.append((f"media_{w}x{h}", spec._replace(emit_rgba=False), params, manimate, "replay"))
        if (w, h) == (W, H):
            cases.append((f"media_emit_rgba_{w}x{h}", spec, params, manimate, "eager"))
    spec, params = entry_spec_params(rng, dev)
    cases.append((f"entry_{W}x{H}", spec, params, lambda p, t: animate(torch, p, dev, t), "replay"))
    for variant in ("one_rotation", "wipe", "rotated_pair"):
        spec, params = straggler_spec_params(torch, dev, W, H, variant)
        cases.append((f"{variant}_{W}x{H}", spec, params,
                      lambda p, t, v=variant: straggler_animate(torch, p, dev, W, H, v, t), "replay"))
    kspec, kparams = keyed_straggler_spec_params(torch, dev, rng, W, H)
    kanimate = lambda p, t: keyed_straggler_animate(torch, p, dev, t)
    cases.append((f"keyed_straggler_{W}x{H}", kspec._replace(emit_rgba=False), kparams, kanimate, "replay"))
    cases.append((f"keyed_straggler_emit_rgba_{W}x{H}", kspec, kparams, kanimate, "eager"))
    bspec, bparams = multibox_spec_params(torch, dev, rng, W, H, "yuv422p10le", False)
    cases.append((f"multibox_yuv422p10le_{W}x{H}", bspec, bparams, lambda p, t: media_animate(torch, p, dev, t),
                  "bypass"))
    return cases


def graph_trace(torch, fn, ticks: int) -> tuple:
    """(device operations a tick, their names) of ``ticks`` calls of fn
    under torch.profiler (the card's kernels, copies and fills)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return len(ops) / ticks, sorted({e["name"] for e in ops})


def phase_graph(torch, dev, card: str, rng, run_path, timing: dict) -> None:
    """A warm channel-tick as one CUDA graph replay (graph/replay.py), on
    the cell uhd_rec.media's structure and each staged chip_smoke
    structure: the first frame eager, then its capture (with the runner's
    own check of a replay against it), then GRAPH_TICKS ticks with each
    source's frames cycled and the MIX weight and matrices moving, each
    replayed tick equal to the eager tick bit for bit; GRAPH_HELD replayed outputs unchanged across as many
    later replays (each output is its consumer's); the runner's counts;
    for the cell's structure at UHD, launches a tick from the device trace
    and host ms a tick, replay against eager."""
    from phaneron_tpu_torch.graph import replay
    from phaneron_tpu_torch.graph.pipeline import make_channel_program
    from phaneron_tpu_torch.utils.metrics import tracer

    runner = replay.GraphRunner()
    flat = lambda out: replay.flatten_out(out)[0]
    names = ("program.graph_captures", "program.graph_replays", "program.graph_eager_ticks.structure",
             "program.graph_eager_ticks.alignment")
    record = {}
    cases = graph_cases(torch, dev, rng)
    for name, spec, params, animate, expected in cases:
        program = make_channel_program(spec)
        program.prepare(dev)
        before = tracer.counters()
        # the structure's first frame, eager, then its capture, as a channel's cold dispatch
        runner.capture(spec, program, params, dev, program(params))

        def ticks():
            for k in range(GRAPH_TICKS):
                p = cycled(params, k)
                animate(p, k / (GRAPH_TICKS - 1))
                got, want = flat(runner.run(spec, program, p, dev)), flat(program(p))
                differ = [(i, int((g.contiguous().view(torch.uint8) != x.contiguous().view(torch.uint8)).sum()))
                          for i, (g, x) in enumerate(zip(got, want)) if not same_bytes(torch, g, x)]
                check(len(got) == len(want) and not differ,
                      f"graph {name} tick {k}: the replayed frame differs from the eager frame (output, bytes): "
                      f"{differ}; counts {tracer.counters()}; refusals {runner.refusals}")

        if name == f"media_{UHD_W}x{UHD_H}":  # each tick one replay and one eager frame
            run_path(f"graph_{name}", {"planar422_unpack": 1, "planar420_unpack": 2, "rgb8_unpack": 1, "warp": 1,
                                       "planar422_pack": 1}, 2 * GRAPH_TICKS, ticks)
        else:
            ticks()
        after = tracer.counters()
        counts = {n: after.get(n, 0) - before.get(n, 0) for n in names}
        status = ("replay" if counts["program.graph_replays"] == GRAPH_TICKS else
                  "eager" if counts["program.graph_eager_ticks.structure"] == GRAPH_TICKS else
                  "bypass" if not any(counts.values()) else f"mixed {counts}")
        check(status == expected, f"graph {name}: {status}, expected {expected} "
                                  f"({runner.refusals.get(spec, 'no refusal')})")
        if status == "replay":
            check(counts["program.graph_captures"] == 1, f"graph {name}: {counts['program.graph_captures']} captures")
            held = []
            for k in range(GRAPH_HELD):
                out = flat(runner.run(spec, program, cycled(params, 20 + k), dev))
                held.append((out, [t.clone() for t in out]))
            for k in range(GRAPH_HELD):
                runner.run(spec, program, cycled(params, 30 + k), dev)
            torch.cuda.synchronize()
            check(all(same_bytes(torch, t, c) for out, copy in held for t, c in zip(out, copy)),
                  f"graph {name}: a later replay wrote into a held output")
        record[name] = dict(status=status, counts=counts, refusal=runner.refusals.get(spec))
        print(f"graph {name}: {status}, {GRAPH_TICKS} ticks equal to eager bit for bit"
              + (f", {GRAPH_HELD} held outputs unchanged across {GRAPH_HELD} replays" if status == "replay" else "")
              + f"; counts {counts}" + (f"; eager because {runner.refusals[spec]}" if spec in runner.refusals else ""))

    # the cell's structure at UHD: launches and host ms a tick, replay and eager
    _, spec, params, _, _ = cases[0]
    program = make_channel_program(spec)
    p = cycled(params, 1)
    media_animate(torch, p, dev, 0.25)
    replayed = graph_trace(torch, lambda: runner.run(spec, program, p, dev), GRAPH_TRACE_TICKS)
    eager = graph_trace(torch, lambda: program(p), GRAPH_TRACE_TICKS)
    # the names must match; the counts are printed (the profiler may drop a
    # few events of a busy slice: one eager trace read 25.95 of 28 a tick)
    check(replayed[1] == eager[1],
          f"graph media: replayed kernels {replayed[1]} against eager {eager[1]}")
    host = {"replay": [], "eager": []}
    for i in range(GRAPH_HOST_TICKS):
        for way, fn in (("replay", lambda: runner.run(spec, program, p, dev)), ("eager", lambda: program(p))):
            t0 = time.perf_counter()
            fn()
            host[way].append(1e3 * (time.perf_counter() - t0))
        if i % 4 == 3:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    record["media_uhd"] = dict(device_ops_per_tick=dict(replay=replayed[0], eager=eager[0]),
                               kernels=replayed[1], host_ms_median={k: statistics.median(v) for k, v in host.items()})
    timing["graph"] = record
    print(f"graph media {UHD_W}x{UHD_H} on {card}: {replayed[0]:g} device ops a tick replayed, {eager[0]:g} eager; "
          f"host ms a tick (median of {GRAPH_HOST_TICKS}) replay {statistics.median(host['replay']):.4f}, eager "
          f"{statistics.median(host['eager']):.4f}; kernels in the trace {replayed[1]}")
    print(json.dumps({"graph": record}, default=str))


def phase_runtime(torch, dev, card: str, run_path, stage_load, timing: dict) -> None:
    """The runtime on the card: port Channels (runtime/channel.py) with
    test-pattern sources, on one event loop.  (a) The default load's four
    1080i50 channels, a kernel set against a plain set through
    render_frame, 3 steady periods with the stage-driven period's launch
    counts (``run_path``), then a warm period under the sync debug mode
    and the runtime period timed in turns with ``stage_load``; (b) a
    1080p50 playout and entry() channel the same way; (c) the four 1080i50
    kernel channels under Channel.run for PACED_SECONDS: every rendered
    tick delivered, each channel's stats recorded in ``timing``."""
    import asyncio

    from phaneron_tpu_torch.config import get_video_format
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.producer.producer import LoadParams

    loop = asyncio.new_event_loop()
    arun = loop.run_until_complete
    t_phase = time.perf_counter()
    kern, ref = arun(runtime_interlaced_set(dev, False)), arun(runtime_interlaced_set(dev, True))
    for _ in range(2 * RUNTIME_FILL_PERIODS):  # the rings fill, then the structure's first (prepared) tick
        arun(runtime_tick(kern))
        arun(runtime_tick(ref))
    live = kern[0][0]._last_layer_specs
    check(len(live) == 4 and all(ls == interlaced_spec().layers[0] for ls in live.values()),
          f"runtime: the channels run {live}, not the stage-driven period's structure")

    def runtime_interlaced_path():
        worst = 0
        for p in range(RUNTIME_PERIODS):
            for t in (0, 1):
                worst = max(worst, runtime_compare(torch, arun(runtime_tick(kern)), arun(runtime_tick(ref)),
                                                   W, H, f"runtime period {p} tick {t}"))
            for c, ((_, a), (_, b)) in enumerate(zip(kern, ref)):
                check(a.paired == b.paired and a.pair is not None, f"runtime period {p} channel {c}: no field pair")
                d = code_delta(torch, a.pair, b.pair, W, H)
                check(d <= TOL_CODES, f"runtime period {p} channel {c}: paired words {d} codes from the plain set")
                worst = max(worst, d)
        print(f"runtime_interlaced: {RUNTIME_PERIODS} steady periods of {N_CHANNELS} Channels {W}x{H} "
              f"(render_frame, 4 BARS -> RAMP dissolves under MIXER FILL, a consumer pairing the fields), "
              f"max code delta vs the plain channels {worst} (frames and paired words)")

    # the stage-driven period's counts: the runtime takes the same route
    run_path("runtime_interlaced", {"v210_unpack": N_CHANNELS * N_SOURCES, "yadif_pair": N_CHANNELS * N_SOURCES,
                                    "packed_composite": N_CHANNELS * 2}, RUNTIME_PERIODS, runtime_interlaced_path,
             modes={("rgb3", "packed", "top"): N_CHANNELS * 2})
    with sync_errors(torch):  # a warm period makes the host wait for nothing
        warm = [arun(runtime_tick(kern)) for _ in (0, 1)]
    for frames in warm:
        runtime_compare(torch, frames, arun(runtime_tick(ref)), W, H, "runtime warm tick")
    print("runtime_interlaced: a warm period of each kernel channel ran under "
          "torch.cuda.set_sync_debug_mode('error')")
    for ch, _ in ref:
        arun(ch.shutdown())
    runtime_ms, stage_ms = [], []
    runtime_period = lambda: [arun(runtime_tick(kern)) for _ in (0, 1)]
    for order in ("stage", "runtime", "runtime", "stage"):
        if order == "stage":
            stage_ms.append(time_ms(torch, stage_load, batches=5, calls=2, warmup=1))
        else:
            runtime_ms.append(time_ms(torch, runtime_period, batches=5, calls=2, warmup=1))
    timing["runtime_interlaced_period"] = dict(ms=statistics.median(runtime_ms), runs=runtime_ms,
                                               stage_ms=statistics.median(stage_ms), stage_runs=stage_ms)
    print(f"runtime_interlaced period ms ({N_CHANNELS} x 1080i50 Channels, render_frame + deliver, eager) on "
          f"{card}: {timing['runtime_interlaced_period']['ms']:.4f} (runs {runtime_ms}); the stage-driven "
          f"period {timing['runtime_interlaced_period']['stage_ms']:.4f} (runs {stage_ms})")

    # 1080p50: playout (a v210 pattern, then a MIX to another, no DVE: one
    # fused_v210 a tick) and entry() (a v210 DVE dissolve under a yuv422p8
    # pattern: one packed_warp, planar422_unpack and combine_pack a tick)
    async def progressive_channels(name: str) -> list:
        out = []
        for plain in (False, True):
            ch, consumer = await runtime_channel(dev, 10 + plain, get_video_format("1080p5000"), plain)
            if name == "playout":
                await runtime_dissolve(ch, 1, "BARS", "RAMP")
            else:
                await runtime_dissolve(ch, 1, "BARS", "RAMP", (0.05, 0.0, 0.9, 1.0))
                check(await ch.load_source(2, LoadParams("BARS@yuv422p8")) and ch.play(2), "runtime: LOAD yuv422p8")
            await ch.wait_prewarmed()
            out.append((ch, consumer))
        return out


    for name, per_tick in (("playout", {"fused_v210": 1}),
                           ("entry", {"packed_warp": 1, "planar422_unpack": 1, "combine_pack": 1})):
        pair = arun(progressive_channels(name))
        for _ in range(2):  # the structure's first (prepared) tick, then one warm
            arun(runtime_tick(pair))
        path = f"runtime_{name}_{W}x{H}"

        def runtime_progressive_path():
            worst = 0
            for t in range(RUNTIME_TICKS):
                a, b = arun(runtime_tick(pair[:1])), arun(runtime_tick(pair[1:]))
                worst = max(worst, runtime_compare(torch, a, b, W, H, f"{path} tick {t}"))
            print(f"{path}: {RUNTIME_TICKS} ticks of a 1080p50 Channel, max code delta vs the plain channel {worst}")

        run_path(path, per_tick, RUNTIME_TICKS, runtime_progressive_path)
        with sync_errors(torch):
            warm = arun(runtime_tick(pair[:1]))
        runtime_compare(torch, warm, arun(runtime_tick(pair[1:])), W, H, f"{path} warm tick")
        print(f"{path}: a warm tick ran under torch.cuda.set_sync_debug_mode('error')")
        for ch, _ in pair:
            arun(ch.shutdown())

    change = timing["runtime_structure_change"] = arun(runtime_structure_change(torch, dev))
    print(f"runtime structure change: channel A ticked {change['a_ticks']} times (longest gap "
          f"{change['a_max_gap_ms']:.2f} ms, max code delta vs its plain twin {change['worst_codes']}) while "
          f"channel B's first frame of a new structure prepared and captured on its worker thread in "
          f"{change['cold_ms']:.1f} ms")

    # the four 1080i50 kernel channels paced by Channel.run on the event loop
    from phaneron_tpu_torch.utils.metrics import tracer

    k5_before = PW.packed_composite.launches
    starts = {}
    tracer.reset()
    tracer.start()  # the channels' render p50 / p99 read their channel.tick spans
    for ch, consumer in kern:
        consumer.delivered = 0
        starts[ch.chan_id] = ch.timestamp

    async def paced():
        for ch, _ in kern:
            await ch.wait_prewarmed()
            ch.start()
        await asyncio.sleep(PACED_SECONDS)
        for ch, _ in kern:
            ch.running = False  # each loop ends after a whole tick
        await asyncio.wait_for(asyncio.gather(*(ch._task for ch, _ in kern)), 30)

    arun(paced())
    stats = []
    for ch, consumer in kern:
        s = ch.stats()
        rendered = ch.timestamp - starts[ch.chan_id]
        check(rendered > 0 and consumer.delivered == rendered == ch.clock.total_frames,
              f"runtime paced channel {ch.chan_id}: {ch.clock.total_frames} ticks, {rendered} rendered, "
              f"{consumer.delivered} delivered")
        stats.append(dict(channel=ch.chan_id, frames=rendered, late_frames=s["late_frames"],
                          render_p50_host_ms=s["render_p50_ms"], render_p99_host_ms=s["render_p99_ms"]))
        print(f"runtime paced run on {card}: channel {ch.chan_id} {rendered} ticks in {PACED_SECONDS} s, "
              f"late_frames {s['late_frames']}, render p50 {s['render_p50_ms']:.4f} host ms, "
              f"p99 {s['render_p99_ms']:.4f} host ms, every tick delivered")
    tracer.stop()
    k5_paced = PW.packed_composite.launches - k5_before
    check(k5_paced == sum(s["frames"] for s in stats),
          f"runtime paced run: {k5_paced} packed_composite launches for {sum(s['frames'] for s in stats)} ticks")
    timing["runtime_paced"] = stats
    for ch, _ in kern:
        arun(ch.shutdown())

    async def drain():  # the streams' pumps end with their producers
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for task in pending:
            task.cancel()
        await asyncio.gather(*pending, return_exceptions=True)

    arun(drain())
    loop.close()
    print(f"runtime phase: {time.perf_counter() - t_phase:.2f} s")



SERVER_PACED_SECONDS = 4.0  # the server's channels under Channel.run with every consumer attached
SERVER_DISSOLVE_TICKS = 50  # LOADBG 1-1 RAMP MIX 50
SERVER_PERIODS = 3  # steady server periods counted
SERVER_PLAYBACK_SECONDS = 1.0  # the second session's raw-file playback
SERVER_PROBE_S = 0.1  # an INFO every 100 ms while the server runs paced
SERVER_TWO_CHIP_SECONDS = 1.0  # configs/quad_1080i_2chip.json's channels paced on the one card


def server_boxes(n_channels: int) -> dict:
    """(channel, layer) -> MIXER FILL box: bench.py's interlaced boxes."""
    return {(c, i): (0.02 + 0.003 * i + 0.0007 * c, 0.0, 0.9, 0.9)
            for c in range(1, n_channels + 1) for i in range(1, 5)}


class AmcpClient:
    """An AMCP connection that sends a command, reads its response lines
    and records the round trip (send to the final response line)."""

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer
        self.rtt_ms = []

    async def call(self, cmd: str, expect) -> list:
        """Send ``cmd``; ``expect`` is the list of response lines (a line
        ending in '...' matches by prefix).  Fails unless they match."""
        import asyncio

        t0 = time.perf_counter()
        self.writer.write(f"{cmd}\r\n".encode())
        await self.writer.drain()
        lines = [(await asyncio.wait_for(self.reader.readline(), 30)).decode().rstrip("\r\n") for _ in expect]
        self.rtt_ms.append((time.perf_counter() - t0) * 1e3)
        for got, want in zip(lines, expect):
            ok = got.startswith(want[:-3]) if want.endswith("...") else got == want
            check(ok, f"server: {cmd!r} answered {lines}, expected {expect}")
        return lines

    async def close(self) -> None:
        self.writer.close()
        await self.writer.wait_closed()


def server_config(out_dir, playback: bool = False, config: str = "quad_1080i_1chip.json"):
    """configs/<config> (the default load's) through the port's
    ServerConfig.load, changed in memory only: the file consumers write
    under ``out_dir`` (``*_playback.v210`` in the second session,
    ``*_<config stem>.v210`` for another config), the HTTP consumers, AMCP
    and OSC take ports the OS chooses."""
    from pathlib import Path

    from phaneron_tpu_torch.config import ServerConfig

    cfg = ServerConfig.load(Path(__file__).resolve().parent / "configs" / config)
    tag = ("_playback" if playback else "") + ("" if config == "quad_1080i_1chip.json" else f"_{Path(config).stem}")
    for cc in cfg.channels:
        dev = dict(cc.device)
        if dev["name"] == "file":
            stem = Path(dev["path"]).stem + tag
            dev["path"] = str(Path(out_dir) / f"{stem}.v210")
        else:
            dev["port"] = 0
        cc.device = dev
    cfg.amcp_port = cfg.osc_listen_port = 0
    return cfg


def count_deliveries(server) -> None:
    """Before ``start``: every consumer the server's registry makes counts
    the frames handed to it in ``smoke_delivered``."""
    registry = server.consumer_registry
    for name, factory in list(registry.factories.items()):
        def create(params, factory=factory):
            consumer = factory(params)
            consumer.smoke_delivered = 0
            deliver = consumer.deliver

            async def counted(frame):
                consumer.smoke_delivered += 1
                return await deliver(frame)

            consumer.deliver = counted
            return consumer

        registry.register(name, create)


async def stop_paced(server) -> None:
    """End every channel's Channel.run after a whole tick."""
    import asyncio

    for ch in server.channels.values():
        ch.running = False
    await asyncio.wait_for(asyncio.gather(*(ch._task for ch in server.channels.values())), 30)


async def server_tick(ch):
    """One tick as Channel.run makes it, unpaced: render, deliver to every
    consumer (errors raise here); returns the frame."""
    frame = await ch.render_frame()
    for r in await ch.deliver(frame):
        if isinstance(r, Exception):
            raise r
    return frame


def source_position(slot) -> int:
    """The index of a slot's last frame in its source: a test pattern's
    frame timestamps start at its SEEK, a raw file's count the frames it
    played from its SEEK (no LOOP wrap or CALL SEEK here)."""
    from phaneron_tpu_torch.producer.raw_file import RawFileProducer

    if isinstance(slot.producer, RawFileProducer):
        return slot.producer.params.seek + slot.last.timestamp
    return slot.last.timestamp


async def plain_twin(dev, ch, emit_rgba: bool):
    """A plain=True Channel in the state the server channel ``ch`` ends in
    after its last tick, given the same commands through the port's
    control plane: each playing test-pattern or raw-file source is PLAYed
    with SEEK so that its last frame is the server source's last frame,
    at the same field parity, under the same MIXER FILL, and ticked until
    its deinterlace ring is full.  Returns the twin's last two frames."""
    from phaneron_tpu_torch.producer.producer import ProducerRegistry
    from phaneron_tpu_torch.producer.raw_file import create_raw_file_producer
    from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
    from phaneron_tpu_torch.runtime.channel import Channel

    twin = Channel(ch.chan_id, ch.fmt, ProducerRegistry([create_test_pattern_producer, create_raw_file_producer]),
                   device=dev, plain=True)
    if emit_rgba:
        await twin.add_consumer(rgba_sink())
    cmds = control_plane({ch.chan_id: twin})
    starts = {}
    for num, lay in sorted(ch.layers.items()):
        slot = lay.cur
        check(slot is not None and lay.next is None and lay.transition is None,
              f"server channel {ch.chan_id} layer {num}: not a steady source")
        ticks = 8 + slot.ticks % 2  # >= 3 pulls, the server slot's field parity
        seek = source_position(slot) - (ticks + 1) // 2 + 1  # the twin pulls (ticks + 1) // 2 frames
        check(seek >= 0, f"server channel {ch.chan_id} layer {num}: seek {seek}")
        cmd = [f'PLAY {ch.chan_id}-{num} "{slot.producer.params.url}" SEEK {seek}']
        if not slot.mixer.is_identity:
            cmd.append(f"MIXER {ch.chan_id}-{num} FILL " + " ".join(repr(v) for v in slot.mixer.fill))
        starts.setdefault(9 - ticks, []).append(cmd)
    frames = []
    for t in range(9):
        for cmd in starts.get(t, []):
            for line in cmd:
                tokens = [tok.strip('"') for tok in line.split(" ")]
                check(await cmds.process(tokens), f"plain twin {ch.chan_id}: {line}")
        frames.append(await twin.render_frame())
    for num, lay in ch.layers.items():
        got, want = twin.layers[num].cur, lay.cur
        check((got.ticks % 2, source_position(got)) == (want.ticks % 2, source_position(want)),
              f"plain twin {ch.chan_id} layer {num}: ticks {got.ticks}, frame {source_position(got)}; server "
              f"{want.ticks}, {source_position(want)}")
        check(got.mixer.fill == want.mixer.fill, f"plain twin {ch.chan_id} layer {num}: fill {got.mixer.fill}")
    await twin.shutdown()
    return frames[-2:]


def last_written(torch, dev, cons, height: int):
    """The last frame a released FileConsumer wrote, as v210 words on ``dev``."""
    data = np.fromfile(cons.path, dtype=np.uint32)
    words = data[-data.size // cons.written:].view(np.int32).reshape(height, -1)
    return torch.from_numpy(words.copy()).to(dev)


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) if xs else float("nan")


async def mjpeg_reader(port: int, parts: list) -> None:
    """Read the MJPEG stream, keeping each part's header and JPEG bytes."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET / HTTP/1.1\r\n\r\n")
    await writer.drain()
    parts.append(await reader.readuntil(b"\r\n\r\n"))
    try:
        while True:
            head = await reader.readuntil(b"\r\n\r\n")
            n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
            parts.append((head, await reader.readexactly(n)))
            await reader.readexactly(2)
    finally:
        writer.close()


async def http_get(port: int, path: str, n: int) -> tuple:
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    body = await asyncio.wait_for(reader.readexactly(n), 30)
    writer.close()
    return head, body


def phase_server(torch, dev, card: str, run_path, timing: dict, server_device=None) -> None:
    """The server (server.py) on configs/quad_1080i_1chip.json, as a user
    starts it: PhaneronServer over ServerConfig.load (file paths and ports
    changed in memory), on the card; AMCP over TCP builds the load (four
    BARS boxes a channel, a MIX on 1-1), the channels run paced with the
    file, preview and MJPEG consumers attached; then 3 steady periods
    counted, a warm period under the sync debug mode, the last written
    frames and the preview against plain twins, and a second session
    playing channel 1's recording back through the raw-file producer."""
    import asyncio
    import tempfile
    from pathlib import Path

    from phaneron_tpu_torch.graph.pipeline import make_interlaced_word_pack_program, make_pack_program
    from phaneron_tpu_torch.server import PhaneronServer
    from phaneron_tpu_torch.utils.metrics import tracer

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    out_dir = Path(tempfile.mkdtemp(prefix="phaneron_server_"))
    loop = asyncio.new_event_loop()
    arun = loop.run_until_complete
    t_phase = time.perf_counter()
    record = {}

    async def session1():
        server = PhaneronServer(server_config(out_dir), device=server_device)
        count_deliveries(server)
        await server.start()
        chans = server.channels
        fmt = chans[1].fmt
        w, h = fmt.width, fmt.height
        amcp = AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
        boxes = server_boxes(len(chans))
        for (c, i), box in boxes.items():
            await amcp.call(f"PLAY {c}-{i} BARS", ["202 PLAY OK"])
            await amcp.call(f"MIXER {c}-{i} FILL " + " ".join(map(str, box)), ["202 MIXER OK"])
        await amcp.call(f"LOADBG 1-1 RAMP MIX {SERVER_DISSOLVE_TICKS}", ["202 LOADBG OK"])
        await amcp.call("PLAY 1-1", ["202 PLAY OK"])
        while chans[1].layers[1].transition is not None or chans[1].layers[1].next is not None:
            await amcp.call("REQ chip0 PING", ["PONG chip0"])
            await asyncio.sleep(0.05)
        # the RAMP that the dissolve brought in takes the box too (MIXER
        # FILL reaches the playing source's mixer only)
        await amcp.call("MIXER 1-1 FILL " + " ".join(map(str, boxes[(1, 1)])), ["202 MIXER OK"])
        info = ["200 INFO OK", *(f"{n} {fmt.name} PLAYING" for n in chans), ""]
        await amcp.call("INFO", info)
        await amcp.call("INFO 1", ["201 INFO OK", f"1 {fmt.name} PLAYING frames=..."])
        await amcp.call("REQ chip1 MIXER 2-1 FILL", ["RES chip1 202 MIXER OK"])
        await amcp.call("REQ chip2 PING", ["PONG chip2"])
        await amcp.call("VERSION", ["201 VERSION OK", "2.1.8..."])
        await amcp.call("ADD 2 DECKLINK", ["400 ERROR", "ADD 2 DECKLINK NOT IMPLEMENTED"])
        script_rtt = list(amcp.rtt_ms)

        parts = []
        mjpeg_task = asyncio.create_task(mjpeg_reader(chans[4].consumers[0].port, parts))
        for ch in chans.values():  # the paced window starts on warm structures
            await ch.wait_prewarmed()
        def snapshot():
            return {n: dict(ticks=ch.timestamp, late=ch.clock.late_frames,
                            written=[getattr(c, "written", 0) for c in ch.consumers],
                            bytes=[getattr(c, "bytes_written", 0) for c in ch.consumers]) for n, ch in chans.items()}

        before = snapshot()
        tracer.reset()  # the server started it: render p50 / p99 of the window's ticks
        amcp.rtt_ms.clear()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SERVER_PACED_SECONDS:
            await amcp.call("INFO", info)
            await asyncio.sleep(SERVER_PROBE_S)
        seconds = time.perf_counter() - t0
        probe_rtt = list(amcp.rtt_ms)
        stats = {n: ch.stats() for n, ch in chans.items()}
        after = snapshot()
        await stop_paced(server)
        per_channel = []
        for n, ch in chans.items():
            rendered = ch.timestamp
            counts = [c.smoke_delivered for c in ch.consumers]
            check(rendered == ch.clock.total_frames and counts == [rendered], f"server channel {n}: "
                  f"{ch.clock.total_frames} clock ticks, {rendered} rendered, delivered {counts}")
            b, a = before[n], after[n]
            row = dict(channel=n, consumer=server.config.channels[n - 1].device["name"],
                       ticks_rendered=rendered, ticks_delivered=counts[0],
                       window_ticks=a["ticks"] - b["ticks"],
                       late_frames=a["late"] - b["late"], late_frames_whole_run=ch.clock.late_frames,
                       render_p50_host_ms=stats[n]["render_p50_ms"], render_p99_host_ms=stats[n]["render_p99_ms"])
            if row["consumer"] == "file":
                row["frames_written"] = a["written"][0] - b["written"][0]
                row["mb_per_s_written"] = (a["bytes"][0] - b["bytes"][0]) / 1e6 / seconds
            per_channel.append(row)
            print(f"server paced run on {card}: channel {n} ({row['consumer']}) {rendered} ticks rendered and "
                  f"{counts[0]} delivered since start; in the {seconds:.3f} s window {row['window_ticks']} "
                  f"ticks, late_frames {row['late_frames']} ({ch.clock.late_frames} over the run), render p50 "
                  f"{row['render_p50_host_ms']:.4f} p99 {row['render_p99_host_ms']:.4f} host ms"
                  + (f", {row['frames_written']} frames written, {row['mb_per_s_written']:.2f} MB/s"
                     if "frames_written" in row else ""))
        rtt = dict(script_p50_ms=percentile(script_rtt, 50), script_p99_ms=percentile(script_rtt, 99),
                   script_n=len(script_rtt), probe_p50_ms=percentile(probe_rtt, 50),
                   probe_p99_ms=percentile(probe_rtt, 99), probe_n=len(probe_rtt))
        print(f"server AMCP round trip on {card} (send to the final response line, channels running): the "
              f"script's {rtt['script_n']} commands p50 {rtt['script_p50_ms']:.4f} ms p99 "
              f"{rtt['script_p99_ms']:.4f} ms; INFO every {SERVER_PROBE_S} s in the paced window, "
              f"{rtt['probe_n']} calls, p50 {rtt['probe_p50_ms']:.4f} ms p99 {rtt['probe_p99_ms']:.4f} ms")

        live = chans[1]._last_layer_specs
        check(len(live) == 4 and all(ls.has_transform and ls.axis_aligned for ls in live.values()),
              f"server channel 1 runs {live}, not four boxes")
        await amcp.close()
        record.update(per_channel=per_channel, rtt=rtt, seconds=seconds, server=server, w=w, h=h, fmt=fmt,
                      parts=parts, mjpeg_task=mjpeg_task)

    arun(session1())
    server, w, h, fmt, chans = record["server"], record["w"], record["h"], record["fmt"], record["server"].channels
    n_ch = len(chans)
    n_src = sum(len(ch.layers) for ch in chans.values())

    def server_periods():  # the paced loops have stopped: ticks one at a time, as Channel.run makes them
        for _ in range(SERVER_PERIODS):
            for _ in (0, 1):
                for ch in chans.values():
                    arun(server_tick(ch))
        print(f"server: {SERVER_PERIODS} steady periods of {n_ch} channels {w}x{h} "
              f"({n_src} BARS / RAMP boxes; file, file, preview, mjpeg consumers)")

    run_path("server", {"v210_unpack": n_src, "yadif_pair": n_src, "packed_composite": 2 * n_ch},
             SERVER_PERIODS, server_periods,
             modes={("rgb3", "packed", "top"): 4, ("rgb3", "both", "top"): 4})
    with sync_errors(torch):  # a warm server period waits on nothing, consumers included
        for _ in (0, 1):
            for ch in chans.values():
                arun(server_tick(ch))
        arun(asyncio.sleep(0.05))  # the preview and MJPEG drains run their step
    print("server: a warm period of every channel, its consumers attached, ran under "
          "torch.cuda.set_sync_debug_mode('error')")

    async def finish1():
        for ch in chans.values():  # end on a whole frame period: the files' last pair is the last two ticks
            if ch.timestamp % 2:
                await server_tick(ch)
        preview = chans[3].consumers[0]
        if preview._task is not None:
            await preview._task
        check(preview.last_timestamp == chans[3].timestamp - 1,
              f"server preview: last frame {preview.last_timestamp}, channel at {chans[3].timestamp}")
        head, body = await http_get(preview.port, "/", w * h * 4)
        check(b"200 OK" in head and f"X-Width: {w}".encode() in head, f"server preview: {head!r}")
        files = {}
        for n in (1, 2):
            cons = chans[n].consumers[0]
            cons.release()
            check(cons.leaked_threads == 0 and cons.written == chans[n].timestamp // 2,
                  f"server channel {n}: {cons.written} frames written for {chans[n].timestamp} ticks")
            files[n] = cons
        twins = {n: await plain_twin(dev, chans[n], emit_rgba=(n == 3)) for n in (1, 2, 3)}
        worst = 0
        for n in (1, 2):
            last = last_written(torch, dev, files[n], h)
            (ref,) = make_interlaced_word_pack_program("v210")([twins[n][0].packed[0]], [twins[n][1].packed[0]])
            d = code_delta(torch, last, ref, w, h)
            check(d == 0, f"server channel {n}: the last written frame {d} codes from the plain twin's")
            worst = max(worst, d)
        rgba8 = make_pack_program("rgba8", w, h, "sRGB", plain=True)(twins[3][1].rgba)[0]
        got = torch.frombuffer(bytearray(body), dtype=torch.uint8).reshape(h, w, 4).to(dev)
        pd = int((got.to(torch.int32) - rgba8.to(torch.int32)).abs().max())
        check(pd <= TOL_CODES, f"server preview: {pd} codes from the plain twin's rgba8 pack")
        print(f"server: the last written interlaced frames of channels 1 and 2 (after the MIX) {worst} codes "
              f"from plain twins; the preview body {pd} codes from the plain twin's rgba8 (sRGB) pack")
        parts, task = record["parts"], record["mjpeg_task"]
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        check(parts and b"multipart/x-mixed-replace; boundary=phaneronframe" in parts[0],
              f"server mjpeg: {parts[:1]}")
        if have_pil:
            from PIL import Image
            import io

            check(len(parts) > 1, "server mjpeg: no part streamed")
            for head, jpeg in parts[1:]:
                check(head.startswith(b"--phaneronframe\r\nContent-Type: image/jpeg\r\nContent-Length: ")
                      and jpeg[:2] == b"\xff\xd8", f"server mjpeg part: {head!r}")
            check(Image.open(io.BytesIO(parts[-1][1])).size == (w, h), "server mjpeg: JPEG size")
            print(f"server mjpeg: {len(parts) - 1} JPEG parts, headers checked, last {len(parts[-1][1])} bytes")
        else:
            print("server mjpeg: PIL does not import here; the stream's parts were not checked (skipped)")
        await server.shutdown()
        return files[1].path, pd, worst

    clip, preview_delta, worst = arun(finish1())

    async def session2():
        """Play channel 1's recording back on channel 1 of a new session."""
        server = PhaneronServer(server_config(out_dir, playback=True), device=server_device)
        await server.start()
        chans2 = server.channels
        amcp = AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
        await amcp.call(f'PLAY 1-1 "{clip}"', ["202 PLAY OK"])
        await amcp.close()
        await asyncio.sleep(SERVER_PLAYBACK_SECONDS)
        await stop_paced(server)
        ch = chans2[1]
        if ch.timestamp % 2:
            await server_tick(ch)
        cons = ch.consumers[0]
        cons.release()
        check(cons.written == ch.timestamp // 2 and cons.written > 0,
              f"server playback: {cons.written} frames written for {ch.timestamp} ticks")
        twin = await plain_twin(dev, ch, emit_rgba=False)
        last = last_written(torch, dev, cons, h)
        (ref,) = make_interlaced_word_pack_program("v210")([twin[0].packed[0]], [twin[1].packed[0]])
        d = code_delta(torch, last, ref, w, h)
        check(d == 0, f"server playback: the last written frame {d} codes from the plain channel playing the file")
        print(f"server playback: channel 1's recording played back over {ch.timestamp} ticks (raw-file "
              f"producer), the last written frame {d} codes from the plain channel playing it")
        await server.shutdown()
        return d

    playback_delta = arun(session2())

    async def session_two_chips():
        """configs/quad_1080i_2chip.json as a user starts it on a host with
        fewer cards than it names: its chip 0 and chip 1 channels wrap onto
        the device count, as the JAX server places them, and tick."""
        server = PhaneronServer(server_config(out_dir, config="quad_1080i_2chip.json"), device=server_device)
        count_deliveries(server)
        await server.start()
        chans3 = server.channels
        chips = [cc.chip for cc in server.config.channels]
        placed = {n: ch.device for n, ch in chans3.items()}
        want = {n: torch.device(server_device) if server_device
                else torch.device("cuda", (chip or 0) % torch.cuda.device_count())
                for n, chip in zip(chans3, chips)}
        check(placed == want, f"server quad_1080i_2chip.json: channels on {placed}, expected {want}")
        amcp = AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
        for n in chans3:
            await amcp.call(f"PLAY {n}-1 BARS", ["202 PLAY OK"])
        await amcp.close()
        await asyncio.sleep(SERVER_TWO_CHIP_SECONDS)
        await stop_paced(server)
        ticks = {n: ch.timestamp for n, ch in chans3.items()}
        for n, ch in chans3.items():
            counts = [c.smoke_delivered for c in ch.consumers]
            check(ticks[n] > 0 and counts == [ticks[n]], f"server quad_1080i_2chip.json channel {n}: "
                  f"{ticks[n]} ticks rendered, delivered {counts}")
        print(f"server on configs/quad_1080i_2chip.json (chips {chips}, {torch.cuda.device_count()} CUDA "
              f"device(s)): channels placed on {sorted({str(d) for d in placed.values()})}, ticks rendered and "
              f"delivered in {SERVER_TWO_CHIP_SECONDS} s paced: {ticks}")
        await server.shutdown()

    arun(session_two_chips())

    async def drain():
        pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for task in pending:
            task.cancel()
        await asyncio.gather(*pending, return_exceptions=True)

    arun(drain())
    loop.close()
    timing["server_paced"] = dict(channels=record["per_channel"], amcp_rtt=record["rtt"],
                                  seconds=record["seconds"], last_frame_codes=worst,
                                  preview_codes=preview_delta, playback_codes=playback_delta)
    print(f"server phase: {time.perf_counter() - t_phase:.2f} s")


MEDIA_IO_WARM_TICKS = 4  # ticks before a counted window: the first frames pulled, each structure prepared
MEDIA_IO_PERIODS = 3  # frame periods (two ticks) counted and compared with the plain twins
MEDIA_IO_CLIP_FRAMES = 8  # frames of each file fixture: more than the ticks pull (25 fps on 50 Hz)
MEDIA_IO_STUB_FRAMES = 16  # frames of the ffmpeg stubs' sources (50 fps on 50 Hz)
MEDIA_IO_LAG_SECONDS = 2.0  # the paced window with the MJPEG producer playing
SDI_CLIP_FRAMES = 6  # utils/fixtures' interlaced clip, served by the fake capture card in a loop
MEDIA_IO_BOX = (0.25, 0.25, 0.5, 0.5)  # MIXER FILL of the ffmpeg channel's yuv420p layer
# launches a counted period (two ticks) or tick (no packed_composite on
# these paths): the SDI channel a period: K1 and yadif_pair once a
# captured frame, the single deinterlaced layer through combine_pack each
# tick
SDI_PATH_LAUNCHES = {"v210_unpack": 1, "yadif_pair": 1, "combine_pack": 2}
# the four file channels a period: 1 the v210 AVI cut (fused_v210 a tick);
# 2 the MJPG AVI (rgb8_unpack and v210_pack a tick); 3 BARS (K1 and
# yadif_pair a frame) under the keyed PNG (rgb8_unpack a tick),
# combine_pack a tick; 4 the WAV's black (K1 and v210_pack a tick,
# emitting the MJPEG stream's rgba).  Without Pillow channel 2 is empty
# (its transparent frame through v210_pack a tick) and channel 3's BARS
# alone through combine_pack: the same launches but rgb8_unpack's.
MEDIA_FILES_LAUNCHES = {"v210_unpack": 3, "yadif_pair": 1, "fused_v210": 2, "v210_pack": 4, "combine_pack": 2,
                        "rgb8_unpack": 4}
# the ffmpeg channel a tick: K3 10-bit (full frame), B12 (the box's
# source) and K4 (its DVE), the torch combine and v210_pack (the channel
# emits rgba for the consumer), the consumer's planar422_pack
FFMPEG_PATH_LAUNCHES = {"planar422_unpack": 1, "planar420_unpack": 1, "warp": 1, "v210_pack": 1,
                        "planar422_pack": 1}


class FakeCapture:
    """A capture card's backend (producer/sdi_capture.py protocol): serves
    ``frames`` in a loop, each with its two fields' audio as s32."""

    def __init__(self, frames: list, audio_s32: list):
        self.frames, self.audio_s32 = frames, audio_s32
        self.served = 0
        self.opened = None
        self.closed = False

    async def open(self, device_index, fmt):
        self.opened = (device_index, fmt.name)

    async def capture_frame(self):
        k = self.served % len(self.frames)
        self.served += 1
        return self.frames[k].tobytes(), self.audio_s32[k], float(self.served)

    def close(self):
        self.closed = True


class VirtualPlayout:
    """A playout card's backend (consumer/sdi_consumer.py protocol) on a
    virtual clock: ``wait_until`` moves the clock to a frame's slot at
    once, so the genlock's accounting does not depend on host load; the
    displayed frames are kept."""

    def __init__(self):
        self.t = 0.0
        self.frames = []  # (wire planes, audio_s32, timestamp)
        self.closed = False

    def hardware_time(self) -> float:
        return self.t

    async def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)

    async def open(self, device_index, fmt, keyer=False):
        pass

    async def display_frame(self, planes, audio_s32, ts):
        self.frames.append((planes, audio_s32, ts))

    def close(self):
        self.closed = True


class LoaderTimes:
    """While installed: the host seconds and bytes of each producer's
    loader step (a worker thread's read or decode into a pinned buffer and
    its upload, enqueued) and of the codec process's decodes, by producer
    class and format; each object's first call (a process's start, first
    touches of its buffers) is kept apart from the steady calls."""

    def __init__(self):
        self.calls = {}  # name -> {"first": [seconds], "steady": [seconds], "bytes": last call's bytes}
        self._seen = set()
        self._undo = []

    def wrap(self, cls, attr: str, name_of, bytes_of) -> None:
        orig = getattr(cls, attr)

        def call(obj, *args, **kw):
            t0 = time.perf_counter()
            out = orig(obj, *args, **kw)
            rec = self.calls.setdefault(name_of(obj), {"first": [], "steady": [], "bytes": 0})
            rec["steady" if id(obj) in self._seen else "first"].append(time.perf_counter() - t0)
            rec["bytes"] = bytes_of(out, args)
            self._seen.add(id(obj))
            return out

        setattr(cls, attr, call)
        self._undo.append((cls, attr, orig))

    def install(self) -> None:
        from phaneron_tpu_torch.producer.ffmpeg import FFmpegProducer
        from phaneron_tpu_torch.producer.mjpeg import MJPEGProducer
        from phaneron_tpu_torch.producer.raw_file import RawFileProducer
        from phaneron_tpu_torch.producer.sdi_capture import SDICaptureProducer
        from phaneron_tpu_torch.utils.jpeg import JpegProcess

        def planes_bytes(planes) -> int:
            return sum(p.numel() * p.element_size() for p in planes)

        self.wrap(RawFileProducer, "_load_frame", lambda p: f"{type(p).__name__} {p.pix_format}",
                  lambda out, args: planes_bytes(out[0]))
        self.wrap(MJPEGProducer, "_decode_upload", lambda p: "MJPEGProducer rgba8",
                  lambda out, args: planes_bytes(out[0]))
        self.wrap(SDICaptureProducer, "_upload", lambda p: "SDICaptureProducer v210",
                  lambda out, args: planes_bytes(out))
        self.wrap(FFmpegProducer, "_to_planes", lambda p: f"FFmpegProducer {p.pix_format}",
                  lambda out, args: planes_bytes(out))
        self.wrap(JpegProcess, "decode", lambda c: "image decode to rgba8 (codec process)",
                  lambda out, args: args[4].nbytes)

    def restore(self) -> None:
        for cls, attr, orig in reversed(self._undo):
            setattr(cls, attr, orig)
        self._undo.clear()

    def report(self) -> dict:
        out = {}
        for name, rec in sorted(self.calls.items()):
            steady = rec["steady"] or rec["first"]
            ms = statistics.median(steady) * 1e3
            out[name] = dict(steady_calls=len(rec["steady"]), median_ms=ms, max_ms=max(steady) * 1e3,
                             first_ms=max(rec["first"], default=float("nan")) * 1e3,
                             mb_a_call=rec["bytes"] / 1e6, mb_per_s=rec["bytes"] / 1e3 / ms)
        return out


def rgba_sink():
    """A consumer that makes its channel emit the rgba frame (as the
    preview, MJPEG and ffmpeg consumers do) and keeps nothing."""
    from phaneron_tpu_torch.consumer.consumer import Consumer

    class RgbaSink(Consumer):
        pix_format = None

        async def deliver(self, frame):
            pass

    return RgbaSink()


def control_plane(channels: dict):
    """The port's AMCP command set over ``channels`` (what the server's
    AMCP connection dispatches to)."""
    from phaneron_tpu_torch.control.basic_cmds import BasicCmds
    from phaneron_tpu_torch.control.commands import Commands
    from phaneron_tpu_torch.control.mixer_cmds import MixerCmds

    cmds = Commands()
    cmds.add(BasicCmds(channels, None).list())
    cmds.add(MixerCmds(channels).list())
    return cmds


async def command(cmds, line: str) -> None:
    import shlex

    check(await cmds.process(shlex.split(line)), f"command {line!r} failed")


def words_of(torch, planes, dev):
    """Host v210 wire words (uint32) -> an int32 tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(planes[0]).view(np.int32)).to(dev)


def media_io_sdi(torch, dev, card: str, run_path, arun, out_dir, record: dict) -> None:
    """PLAY 1-1 DECKLINK DEVICE 1 on a 1080i50 channel whose capture card
    is a fake serving utils/fixtures' interlaced clip with its PCM, into an
    SDIConsumer over a virtual-clock playout card, against a plain twin."""
    from phaneron_tpu_torch.audio.engine import QUANTUM
    from phaneron_tpu_torch.config import get_video_format
    from phaneron_tpu_torch.consumer.sdi_consumer import SDIConsumer
    from phaneron_tpu_torch.producer import sdi_capture
    from phaneron_tpu_torch.producer.producer import ProducerRegistry
    from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
    from phaneron_tpu_torch.runtime.channel import Channel
    from phaneron_tpu_torch.utils.fixtures import write_interlaced_v210

    fmt = get_video_format("1080i5000")
    w, h, n_ch = fmt.width, fmt.height, fmt.audio_channels
    sdi_dir = out_dir / "sdi"
    sdi_dir.mkdir()
    _, frames = write_interlaced_v210(sdi_dir, w, h, SDI_CLIP_FRAMES, audio_channels=n_ch)
    blocks = np.fromfile(sdi_dir / "clip.pcm", np.float32).reshape(-1, n_ch, QUANTUM)
    pcm = blocks.transpose(1, 0, 2).reshape(n_ch, -1)  # (channels, samples)
    spf = 2 * fmt.samples_per_frame  # a wire frame carries two fields
    audio = [(pcm[:, k * spf:(k + 1) * spf].T.reshape(-1).astype(np.float64) * 2**31).astype(np.int32)
             for k in range(SDI_CLIP_FRAMES)]
    captures = []

    def backend(device, f):
        captures.append(FakeCapture(frames, audio))
        return captures[-1]

    async def channel(plain: bool):
        ch = Channel(1, fmt, ProducerRegistry([sdi_capture.create_sdi_capture_producer, create_test_pattern_producer]),
                     device=dev, plain=plain)
        playout = VirtualPlayout()
        cons = SDIConsumer({"backend": playout, "device": 1})
        await ch.add_consumer(cons)
        await command(control_plane({1: ch}), "PLAY 1-1 DECKLINK DEVICE 1")
        check(type(ch.layers[1].cur.producer).__name__ == "SDICaptureProducer",
              f"sdi: DECKLINK played {type(ch.layers[1].cur.producer).__name__}")
        return ch, cons, playout

    sdi_capture.set_capture_backend(backend)
    try:
        (ch, cons, play), (twin, tcons, tplay) = arun(channel(False)), arun(channel(True))
    finally:
        sdi_capture.set_capture_backend(None)
    check([c.opened for c in captures] == [(1, fmt.name)] * 2, f"sdi: capture cards opened {captures}")
    for _ in range(MEDIA_IO_WARM_TICKS + 2):  # the deinterlace ring fills over the first three frames
        arun(server_tick(ch))

    def sdi_path():
        for _ in range(2 * MEDIA_IO_PERIODS):
            arun(server_tick(ch))

    run_path("media_io_sdi", SDI_PATH_LAUNCHES, MEDIA_IO_PERIODS, sdi_path)
    for _ in range(MEDIA_IO_WARM_TICKS + 2 + 2 * MEDIA_IO_PERIODS):
        arun(server_tick(twin))
    check(len(play.frames) == len(tplay.frames) == (MEDIA_IO_WARM_TICKS + 2) // 2 + MEDIA_IO_PERIODS,
          f"sdi: {len(play.frames)} frames displayed, the twin {len(tplay.frames)}")
    worst = max(code_delta(torch, words_of(torch, a[0], dev), words_of(torch, b[0], dev), w, h)
                for a, b in zip(play.frames, tplay.frames))
    check(worst == 0, f"sdi: a displayed frame {worst} codes from the plain twin's")
    flat = [f.reshape(-1) for f in frames]
    match = [next((k for k, s in enumerate(flat) if np.array_equal(p[0].reshape(-1), s)), -1)
             for p, _, _ in play.frames]
    first = next((j for j, k in enumerate(match) if k >= 0), None)
    check(first is not None, f"sdi: no displayed frame is a captured frame ({match})")
    chained = 0
    for j in range(first, len(match)):
        k = (match[first] + j - first) % SDI_CLIP_FRAMES
        check(match[j] == k, f"sdi: displayed frame {j} is captured frame {match[j]}, expected {k}")
        check(np.array_equal(play.frames[j][1], audio[k]), f"sdi: displayed frame {j}'s audio is not the captured s32")
        chained += 1
    y = words_of(torch, play.frames[first][0], dev)
    from phaneron_tpu_torch.ops.formats import v210

    yy, cb, cr = v210.unpack_codes([y], w, h)
    k = match[first]
    check(bool((yy[0::2] == 120 + 16 * k).all()) and bool((yy[1::2] == 560 + 16 * k).all())
          and bool((cb == 512).all()) and bool((cr == 512).all()), "sdi: the field markers did not survive")
    check(cons.late_frames == tcons.late_frames == 0, f"sdi: late_frames {cons.late_frames} on the virtual clock")
    cons.release()
    tcons.release()
    arun(ch.shutdown())
    arun(twin.shutdown())
    check(all(c.closed for c in captures) and play.closed, "sdi: a card was not closed")
    print(f"media_io sdi on {card}: PLAY 1-1 DECKLINK DEVICE 1 at {w}x{h} 1080i50, {len(play.frames)} frames "
          f"displayed, {worst} codes from the plain twin; from displayed frame {first} {chained} frames are the "
          f"captured frames in order (field markers intact), each with the captured s32 audio; late_frames 0 on "
          f"the virtual clock")
    record["sdi"] = dict(displayed=len(play.frames), twin_codes=worst, chained=chained, late_frames=cons.late_frames)


def media_fixtures(out_dir, w: int, h: int, have_pil: bool) -> dict:
    """The file sources at the channel's size: a v210 AVI of rolled
    fill_buf ramps, a stereo 16-bit WAV of seeded noise (2 s), and with
    Pillow an MJPG AVI (a moving gradient) and a PNG sequence of the keyed
    lower third (utils: graphic_rgba8), sliding a few pixels a frame."""
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.utils.avi import write_avi

    out = {}
    base = v210.fill_buf(w, h)[0]
    out["v210_avi"] = out_dir / "clip_v210.avi"
    write_avi(out["v210_avi"], [np.roll(base, 7 * k, axis=0).tobytes() for k in range(MEDIA_IO_CLIP_FRAMES)],
              "v210", w, h, 25.0)
    rng = np.random.default_rng(SEED + 17)
    out["wav"] = out_dir / "bed.wav"
    out["wav_samples"] = (rng.random((2, 2 * 48000)) * 0.4 - 0.2).astype(np.float32)
    import wave

    with wave.open(str(out["wav"]), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(48000)
        pcm16 = np.round(out["wav_samples"] * 32767).astype("<i2")
        wf.writeframes(pcm16.T.tobytes())
    out["wav_samples"] = pcm16.astype(np.float32) / 32768.0  # what the file decodes to
    if not have_pil:
        return out
    import io

    from PIL import Image

    chunks = []
    ramp = np.linspace(0, 255, w, dtype=np.float32)
    for k in range(MEDIA_IO_CLIP_FRAMES):
        rgb = np.empty((h, w, 3), np.uint8)
        rgb[..., 0] = np.roll(ramp, 24 * k)[None, :].astype(np.uint8)
        rgb[..., 1] = np.linspace(0, 255, h, dtype=np.float32)[:, None].astype(np.uint8)
        rgb[..., 2] = 96 + 16 * k
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=90)
        chunks.append(buf.getvalue())
    out["mjpg_avi"] = out_dir / "clip_mjpg.avi"
    write_avi(out["mjpg_avi"], chunks, "MJPG", w, h, 25.0)
    seq = out_dir / "key"
    seq.mkdir()
    graphic = graphic_rgba8(w, h)
    for k in range(MEDIA_IO_CLIP_FRAMES):
        Image.fromarray(np.roll(graphic, 4 * k, axis=1), "RGBA").save(seq / f"f{k:04d}.png", compress_level=1)
    out["png"] = seq / "f%04d.png"
    return out


def media_io_files(torch, dev, card: str, run_path, arun, out_dir, record: dict, have_pil: bool,
                   server_device) -> None:
    """The server on the default config with its consumers, loaded over
    AMCP so that the registry order picks each producer: a v210 AVI on
    channel 1, an MJPG AVI on 2, a keyed PNG sequence over BARS on 3 and a
    WAV bed on 4; the channels ticked one at a time beside plain twins
    given the same commands.  Then channel 4 plays BARS into its MJPEG
    stream, which channel 2 ingests over HTTP (PLAY 2-1 http://...), paced,
    the event loop's lag probed."""
    import asyncio
    import shlex

    from phaneron_tpu_torch.producer.avi_file import create_avi_producer
    from phaneron_tpu_torch.producer.image_seq import create_image_seq_producer
    from phaneron_tpu_torch.producer.mjpeg import MJPEGProducer
    from phaneron_tpu_torch.producer.producer import ProducerRegistry
    from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
    from phaneron_tpu_torch.producer.wav_file import create_wav_producer
    from phaneron_tpu_torch.runtime.channel import Channel
    from phaneron_tpu_torch.server import PhaneronServer
    from phaneron_tpu_torch.utils.jpeg import FIT_RGB, decode_rgba

    async def session():
        server = PhaneronServer(server_config(out_dir), device=server_device)
        await server.start()
        await stop_paced(server)  # ticked one at a time below, beside the twins
        chans = server.channels
        fmt = chans[1].fmt
        w, h = fmt.width, fmt.height
        media = media_fixtures(out_dir, w, h, have_pil)
        registry = ProducerRegistry([create_test_pattern_producer, create_avi_producer, create_wav_producer,
                                     create_image_seq_producer])
        twins = {}
        for n, ch in chans.items():
            twins[n] = Channel(n, ch.fmt, registry, device=ch.device, plain=True)
            if ch._needs_rgba():
                await twins[n].add_consumer(rgba_sink())
        cmds = control_plane(twins)
        script = [f'PLAY 1-1 "{media["v210_avi"]}"', f'PLAY 4-1 "{media["wav"]}"', "PLAY 3-1 BARS"]
        if have_pil:
            script += [f'PLAY 2-1 "{media["mjpg_avi"]}"', f'PLAY 3-2 "{media["png"]}"']
        amcp = AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
        for line in script:
            await amcp.call(line, ["202 PLAY OK"])
            await command(cmds, line)
        want = {(1, 1): "AviProducer v210", (4, 1): "WavProducer v210", (3, 1): "TestPatternProducer v210",
                (2, 1): "AviProducer rgba8", (3, 2): "ImageSeqProducer rgba8"}
        for (c, i), name in want.items():
            lay = chans[c].layers.get(i)
            if lay is None:
                check(not have_pil and c in (2, 3), f"media_io: channel {c} layer {i} has no source")
                continue
            got = f"{type(lay.cur.producer).__name__} {lay.cur.producer.pix_format}"
            check(got == name, f"media_io: {c}-{i} played by {got}, expected {name}")
        frames = {n: [] for n in chans}
        tframes = {n: [] for n in chans}
        for _ in range(MEDIA_IO_WARM_TICKS):
            for n, ch in chans.items():
                frames[n].append(await server_tick(ch))
        return server, amcp, chans, twins, media, frames, tframes

    server, amcp, chans, twins, media, frames, tframes = arun(session())
    fmt = chans[1].fmt
    w, h = fmt.width, fmt.height

    def files_path():
        for _ in range(2 * MEDIA_IO_PERIODS):
            for n, ch in chans.items():
                frames[n].append(arun(server_tick(ch)))

    launches = MEDIA_FILES_LAUNCHES if have_pil else dict(MEDIA_FILES_LAUNCHES, rgb8_unpack=0)
    run_path("media_io_files", launches, MEDIA_IO_PERIODS, files_path)
    for _ in range(MEDIA_IO_WARM_TICKS + 2 * MEDIA_IO_PERIODS):
        for n, twin in twins.items():
            tframes[n].append(arun(twin.render_frame()))
    worst = {}
    for n in chans:
        worst[n] = max(code_delta(torch, a.packed[0], b.packed[0], w, h) for a, b in zip(frames[n], tframes[n]))
        check(worst[n] == 0, f"media_io: channel {n}'s frames {worst[n]} codes from the plain twin's")
    # the WAV bed: channel 4's audio over the counted ticks is the file's
    # samples, up-mapped 2 -> 8 by repetition, in order
    got = np.concatenate([f.audio for f in frames[4][MEDIA_IO_WARM_TICKS:]], axis=1)
    ref = np.tile(media["wav_samples"], (fmt.audio_channels // 2, 1))
    starts = [s for s in range(ref.shape[1] - got.shape[1] + 1)
              if np.array_equal(ref[:, s:s + 8], got[:, :8])]
    check(len(starts) == 1 and np.array_equal(ref[:, starts[0]:starts[0] + got.shape[1]], got),
          f"media_io: channel 4's audio is not the WAV's samples (offsets {starts[:4]})")
    print(f"media_io files on {card}: channels 1-4 ({w}x{h} 1080i50, the default config's consumers) over "
          f"{len(frames[1])} ticks: v210 AVI, " + ("MJPG AVI, keyed PNG sequence over BARS, " if have_pil else
          "(no Pillow here: the MJPG AVI and the PNG sequence skipped), BARS, ")
          + f"WAV bed; codes from the plain twins {worst}; the WAV's {got.shape[1]} samples a channel from offset "
          f"{starts[0]} equal the file's")
    record["files"] = dict(twin_codes=worst, ticks=len(frames[1]), wav_samples=int(got.shape[1]))
    for twin in twins.values():
        arun(twin.shutdown())
    del frames, tframes

    async def cluster():
        """Channel 4's MJPEG stream (BARS) ingested by channel 2, paced."""
        seen = []
        next_jpeg, decode = MJPEGProducer._next_jpeg, MJPEGProducer._decode_upload

        async def recorded(self):
            jpeg = await next_jpeg(self)
            if jpeg is not None:
                seen.append([jpeg])
            return jpeg

        def decode_recorded(self, jpeg, w, h):
            planes, stamp = decode(self, jpeg, w, h)
            if len(seen) <= 4 and seen and len(seen[-1]) == 1:
                seen[-1].append(planes[0].clone())
            return planes, stamp

        MJPEGProducer._next_jpeg, MJPEGProducer._decode_upload = recorded, decode_recorded
        lags = []
        try:
            await amcp.call("PLAY 4-1 BARS", ["202 PLAY OK"])
            for ch in chans.values():
                ch.start()
            port = chans[4].consumers[0].port
            await amcp.call(f"PLAY 2-1 http://127.0.0.1:{port}/", ["202 PLAY OK"])
            check(isinstance(chans[2].layers[1].cur.producer, MJPEGProducer), "media_io cluster: not the MJPEG producer")
            await asyncio.sleep(0.5)  # the stream's first parts, structures prepared

            async def probe():
                while True:
                    a = time.perf_counter()
                    await asyncio.sleep(0.005)
                    lags.append((time.perf_counter() - a - 0.005) * 1e3)

            before = {n: (ch.timestamp, ch.clock.late_frames) for n, ch in chans.items()}
            ingested = chans[2].layers[1].cur.frames_seen
            task = asyncio.create_task(probe())
            await asyncio.sleep(MEDIA_IO_LAG_SECONDS)
            task.cancel()
            ingested = chans[2].layers[1].cur.frames_seen - ingested
            window = {n: dict(ticks=ch.timestamp - before[n][0], late=ch.clock.late_frames - before[n][1])
                      for n, ch in chans.items()}
            # channel 2's tick waits for its next part: its loop ends while
            # channel 4 still streams, then the others
            chans[2].running = False
            await asyncio.wait_for(chans[2]._task, 30)
            await stop_paced(server)
        finally:
            MJPEGProducer._next_jpeg, MJPEGProducer._decode_upload = next_jpeg, decode
        return seen, lags, window, ingested

    if have_pil:
        seen, lags, window, ingested = arun(cluster())
        pairs = [s for s in seen if len(s) == 2]
        check(len(pairs) >= 2 and ingested > 0, f"media_io cluster: {len(pairs)} parts decoded, {ingested} ingested")
        for jpeg, payload in pairs:
            ref = torch.frombuffer(bytearray(decode_rgba(jpeg, w, h, FIT_RGB)), dtype=torch.uint8)
            ref = ref.reshape(h, w, 4).to(payload.device)
            check(torch.equal(payload, ref), "media_io cluster: an ingested frame is not the plain decode of its JPEG")
        lag = dict(p50_ms=percentile(lags, 50), p99_ms=percentile(lags, 99), max_ms=max(lags, default=float("nan")),
                   probes=len(lags))
        print(f"media_io cluster on {card}: channel 4's MJPEG stream (BARS) played by channel 2 (PLAY 2-1 "
              f"http://...): {ingested} frames ingested in {MEDIA_IO_LAG_SECONDS} s paced, {len(pairs)} checked "
              f"equal to the plain decode of their JPEG; the event loop's lag (a 5 ms sleep's overshoot) p50 "
              f"{lag['p50_ms']:.4f} p99 {lag['p99_ms']:.4f} max {lag['max_ms']:.4f} ms ({lag['probes']} probes), "
              f"per channel ticks and late_frames {window}")
        record["cluster"] = dict(ingested=ingested, checked=len(pairs), loop_lag=lag, window=window)
    else:
        print("media_io cluster: PIL does not import here; the MJPEG ingest was not run (skipped)")

    async def close():
        await amcp.close()
        await server.shutdown()

    arun(close())


def media_io_ffmpeg(torch, dev, card: str, run_path, arun, out_dir, record: dict) -> None:
    """The ffmpeg pair over stub binaries on a 1080p50 channel: a
    yuv422p10le source full frame and a yuv420p source in a box, each
    loaded with its stubs at the front of PATH, recorded by the ffmpeg
    consumer (yuv422p10le rawvideo into an encoder stub that writes its
    input unchanged), against a plain twin."""
    import os

    from phaneron_tpu_torch.config import get_video_format
    from phaneron_tpu_torch.consumer.ffmpeg_consumer import FFmpegConsumer
    from phaneron_tpu_torch.graph.pipeline import make_pack_program
    from phaneron_tpu_torch.producer.ffmpeg import create_ffmpeg_producer
    from phaneron_tpu_torch.producer.producer import ProducerRegistry
    from phaneron_tpu_torch.runtime.channel import Channel
    from phaneron_tpu_torch.utils.fixtures import write_ffmpeg_stubs

    fmt = get_video_format("1080p5000")
    w, h = fmt.width, fmt.height
    bins = {pix: write_ffmpeg_stubs(out_dir / f"bin_{pix}", w, h, pix, MEDIA_IO_STUB_FRAMES, fps=50)
            for pix in ("yuv422p10le", "yuv420p")}
    path0 = os.environ["PATH"]
    rec_path = out_dir / "rec.nut"

    async def setup():
        ch = Channel(1, fmt, ProducerRegistry([create_ffmpeg_producer]), device=dev)
        twin = Channel(1, fmt, ProducerRegistry([create_ffmpeg_producer]), device=dev, plain=True)
        await twin.add_consumer(rgba_sink())
        chans = {"kernel": (ch, control_plane({1: ch})), "twin": (twin, control_plane({1: twin}))}
        try:
            os.environ["PATH"] = f"{bins['yuv422p10le']}{os.pathsep}{path0}"
            cons = FFmpegConsumer({"path": str(rec_path)})
            await ch.add_consumer(cons)
            for c, cmds in chans.values():
                await command(cmds, "PLAY 1-1 full.mxf")
            os.environ["PATH"] = f"{bins['yuv420p']}{os.pathsep}{path0}"
            for c, cmds in chans.values():
                await command(cmds, "PLAY 1-2 box.mxf")
                await command(cmds, "MIXER 1-2 FILL " + " ".join(map(str, MEDIA_IO_BOX)))
        finally:
            os.environ["PATH"] = path0
        names = [f"{type(ch.layers[i].cur.producer).__name__} {ch.layers[i].cur.producer.pix_format}" for i in (1, 2)]
        check(names == ["FFmpegProducer yuv422p10le", "FFmpegProducer yuv420p"], f"media_io ffmpeg: played by {names}")
        return ch, twin, cons

    ch, twin, cons = arun(setup())
    frames, tframes = [], []
    for _ in range(MEDIA_IO_WARM_TICKS):
        frames.append(arun(server_tick(ch)))

    def ffmpeg_path():
        for _ in range(2 * MEDIA_IO_PERIODS):
            frames.append(arun(server_tick(ch)))

    run_path("media_io_ffmpeg", FFMPEG_PATH_LAUNCHES, 2 * MEDIA_IO_PERIODS, ffmpeg_path)

    async def finish(consumer):
        consumer.release()
        await consumer._finish_task  # the drain wrote the last frame, the encoder has exited

    arun(finish(cons))
    for _ in range(len(frames)):
        tframes.append(arun(twin.render_frame()))
    worst = max(code_delta(torch, a.packed[0], b.packed[0], w, h) for a, b in zip(frames, tframes))
    check(worst == 0, f"media_io ffmpeg: the channel's frames {worst} codes from the plain twin's")
    pack = make_pack_program("yuv422p10le", w, h, "709", plain=True)
    want = b"".join(np.ascontiguousarray(p.cpu().numpy()[:, :cols]).tobytes()
                    for f in tframes for p, cols in zip(pack(f.rgba), (w, (w + 1) // 2, (w + 1) // 2)))
    got = rec_path.read_bytes()
    check(len(got) == len(want) == len(frames) * 2 * h * (w + 2 * ((w + 1) // 2)),
          f"media_io ffmpeg: the encoder got {len(got)} bytes, the twin's packs make {len(want)}")
    check(got == want, "media_io ffmpeg: the consumer's rawvideo is not the twin's yuv422p10le pack, cropped")

    async def burst():
        """The channel's frames again, back to back, into a new consumer:
        its egress alone (the ticks waited for the stub decoders)."""
        try:
            os.environ["PATH"] = f"{bins['yuv422p10le']}{os.pathsep}{path0}"
            burst = FFmpegConsumer({"path": str(out_dir / "burst.nut")})
            burst.device = dev
            await burst.initialise(fmt)  # starts the encoder stub
        finally:
            os.environ["PATH"] = path0
        t0 = time.perf_counter()
        for f in frames:
            await burst.deliver(f)
        burst.release()
        await burst._task  # the drain has written the last frame into the encoder's stdin
        seconds = time.perf_counter() - t0
        await burst._finish_task
        return burst, seconds

    burst, seconds = arun(burst())
    check((out_dir / "burst.nut").read_bytes() == got, "media_io ffmpeg: the burst's rawvideo differs")
    mb_s = burst.bytes_written / 1e6 / seconds
    print(f"media_io ffmpeg on {card}: stub ffmpeg / ffprobe at {w}x{h} 50p (yuv422p10le full frame, yuv420p "
          f"box), {len(frames)} ticks 0 codes from the plain twin; the ffmpeg consumer's {len(frames)} rawvideo "
          f"frames ({cons.bytes_written} bytes) equal the twin's yuv422p10le packs, cropped; the same frames "
          f"delivered back to back: {mb_s:.2f} MB/s into the encoder stub ({seconds:.3f} s from the first "
          f"deliver until the drain wrote the last frame; real time at 50p is "
          f"{burst.bytes_written / len(frames) * 50 / 1e6:.2f} MB/s)")
    record["ffmpeg"] = dict(ticks=len(frames), twin_codes=worst, bytes=cons.bytes_written, mb_per_s=mb_s)
    arun(ch.shutdown())
    arun(twin.shutdown())


def phase_media_io(torch, dev, card: str, run_path, timing: dict, server_device=None) -> None:
    """The producers and consumers of ROADMAP A8b at 1920x1080 on the
    card, each against a plain twin: the SDI loop, the file media through
    the server's AMCP (AVI, MJPG AVI, keyed PNG sequence, WAV), the
    cluster's MJPEG ingest and the ffmpeg pair over stub binaries; the
    loaders' host ms and MB/s."""
    import asyncio
    import tempfile
    from pathlib import Path

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    out_dir = Path(tempfile.mkdtemp(prefix="phaneron_media_io_"))
    loop = asyncio.new_event_loop()
    arun = loop.run_until_complete
    t_phase = time.perf_counter()
    record = {}
    loader = LoaderTimes()
    loader.install()
    try:
        media_io_sdi(torch, dev, card, run_path, arun, out_dir, record)
        media_io_files(torch, dev, card, run_path, arun, out_dir, record, have_pil, server_device)
        media_io_ffmpeg(torch, dev, card, run_path, arun, out_dir, record)
    finally:
        loader.restore()

        async def drain():
            await asyncio.sleep(0.2)  # the killed ffmpeg stubs' exits reach their transports
            pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for task in pending:
                task.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

        arun(drain())
        loop.close()
    record["loaders"] = loader.report()
    for name, r in record["loaders"].items():
        print(f"media_io loader on {card}: {name}: {r['mb_a_call']:.3f} MB a frame, median "
              f"{r['median_ms']:.4f} host ms a frame over {r['steady_calls']} steady calls (max "
              f"{r['max_ms']:.4f}; each producer's first call at most {r['first_ms']:.4f}), "
              f"{r['mb_per_s']:.2f} MB/s at the median")
    timing["media_io"] = record
    print(f"media_io phase: {time.perf_counter() - t_phase:.2f} s")


# ------------------------------------------------ phase 7i: row-sharded (sp) channels (A10)

SP_COUNTS = (2, 3, 4, 8)  # bands a frame in the band-form checks (1080 at sp=8: 135-row bands, odd starts)
SP_MATS = {  # the UHD dry run's DVE, a flip, a minifying box (B6's and K5's direct branch), a box past the edge
    "dry run": dict(scale_x=1.2, scale_y=1.3, offset_y=0.05),
    "flip": dict(flip_h=True, flip_v=True, scale_x=0.9, scale_y=0.95),
    "box 0.25": dict(scale_x=0.25, scale_y=0.25, offset_x=0.1, offset_y=-0.2),
    "past the edge": dict(offset_x=0.3, offset_y=1.3),
}
SP_UHD = (UHD_W, UHD_H)  # the UHD dry run's frame
SP_CHANNEL_FRAMES = 2  # frames (the interlaced channel: frame periods) of each sp channel path
SP_SERVER_SECONDS = 2.0  # configs/uhd_sp_sharded.json paced
SP_SERVER_FILE_FRAMES = 40  # the UHD file consumer's frames on disk (0.8 s of 2160p50)
SP_SERVER_TICKS = 2  # unpaced ticks counted after the paced window
SP_MULTIHOST_TIMEOUT = 120.0
BAND_FORMS = ("warp", "packed_warp", "packed_composite", "yadif_ring", "rotate")
SP_ROTATIONS = {  # B14's band sweep: at and near 0, 45, 90, 100 and 180 degrees; taps just past the frame
    "0 deg x0.9": dict(rotate=0.0, scale_x=0.9, scale_y=0.9),
    "0.3 deg x2": dict(rotate=0.3 / 360.0, scale_x=2.0, scale_y=2.0),
    "44.7 deg x0.9": dict(rotate=44.7 / 360.0, scale_x=0.9, scale_y=0.9),
    "45 deg x0.25 past the bottom": dict(rotate=45 / 360.0, scale_x=0.25, scale_y=0.25, offset_y=1.2),
    "89.9 deg x0.9": dict(rotate=89.9 / 360.0, scale_x=0.9, scale_y=0.9),
    "90 deg just past the bottom": dict(rotate=0.25, offset_y=1.01),
    "100 deg x0.9": dict(rotate=100 / 360.0, scale_x=0.9, scale_y=0.9),
    "100 deg x0.3 at the corner": dict(rotate=100 / 360.0, scale_x=0.3, scale_y=0.3, offset_x=0.5, offset_y=0.52),
    "180 deg x2": dict(rotate=0.5, scale_x=2.0, scale_y=2.0),
    "-179.6 deg x0.9": dict(rotate=-179.6 / 360.0, scale_x=0.9, scale_y=0.9),
}


def sp_band_checks(torch, dev, rng, sizes=((W, H), (UHD_W, UHD_H)), sps=SP_COUNTS) -> dict:
    """Each band form on the card against its kernel's full-frame launch on
    the same inputs, band by band, max |delta| 0: K4 (single, dissolve
    under one matrix or two, wipe; C 3 and 4), B6 (single, shared and
    distinct-matrix pairs; each launch's window/direct counts equal to
    ``warp_window_counts`` of its band), K5 (packed, rgb3 and rgba kinds,
    emits packed, both and rgba; each source its own window) and B9 (C 3
    and 4, opaque, tff and bff, both parities, with and without
    skip_spatial), at every size and sp, under the SP_MATS matrices; B14
    (single, dissolve under one matrix or two, wipe under one matrix or
    two; C 3 and 4) under the SP_ROTATIONS matrices and a matrix of scale
    0 (every texel coordinate non-finite: NaN out, one window row),
    bit for bit, each launch's window/direct counts equal to
    ``window_counts`` of its band and its output equal to the band plain
    version's (max |delta| 0, a NaN equal to a NaN).
    Returns {kernel: {"bands": launches compared, "max_abs_err": 0.0}}."""
    from phaneron_tpu_torch.graph.pipeline import _warp_rows
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops import rotate as R
    from phaneron_tpu_torch.ops import warp as warp_mod
    from phaneron_tpu_torch.ops import yadif as Y
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.kernels import Rows
    from phaneron_tpu_torch.parallel.mesh import band_bounds

    out = {k: {"bands": 0, "max_abs_err": 0.0} for k in BAND_FORMS}
    out["rotate"]["plain_max_abs_err"] = 0.0

    def held(name: str, full, got, what: str) -> None:
        same = full.shape == got.shape and torch.equal(full, got)
        diff = 0.0 if same else float("inf") if full.shape != got.shape else float(
            (full.double() - got.double()).abs().max())
        check(same, f"sp band form {name} ({what}): max |delta| {diff} from the full-frame launch")
        out[name]["bands"] += 1

    t0 = time.perf_counter()
    rot_branches = [0, 0]
    for w, h in sizes:
        mats = {n: torch.from_numpy(transform_matrix(w, h, **kw)).to(dev) for n, kw in SP_MATS.items()}
        host = {n: m.cpu().numpy() for n, m in mats.items()}
        frames = {c: [torch.from_numpy(rng.random((c, h, w), dtype=np.float32)).to(dev) for _ in range(3)]
                  for c in (3, 4)}
        mask = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        words = [torch.from_numpy(random_words(rng, w, h).view(np.int32)).to(dev) for _ in range(5)]
        mix, mix2 = torch.tensor(0.37, device=dev), torch.tensor(0.8, device=dev)
        rot_host = {n: transform_matrix(w, h, **kw) for n, kw in SP_ROTATIONS.items()}
        inf = np.float32(np.inf)
        rot_host["scale 0"] = np.array([[inf, -inf, 0.0], [inf, inf, 0.0], [0.0, 0.0, 1.0]], np.float32)
        rot_mats = {n: torch.from_numpy(m).to(dev) for n, m in rot_host.items()}
        for sp in sps:
            bands = [(r0, r1) for r0, r1 in band_bounds(h, sp) if r1 > r0]  # a frame of fewer rows than bands
            win = lambda names, r0, r1: _warp_rows([host[n] for n in names], [(r0, r1)], w, h)[0]
            for c in (3, 4):  # K4
                a, b = frames[c][0], frames[c][1]
                for name in SP_MATS:
                    m, mb = mats[name], mats["dry run"]
                    cases = {"single": ((a, m), False, [name]), "dissolve": ((a, m, b, mix), False, [name]),
                             "dissolve, two matrices": ((a, m, b, mix, mb), False, [name, "dry run"]),
                             "wipe": ((a, m, b), True, [name])}
                    for case, (args, wipe, names) in cases.items():
                        full = warp_mod.warp(*args, **(dict(mask=mask) if wipe else {}))
                        for r0, r1 in bands:
                            lo, hi = win(names, r0, r1)
                            bargs = (args[0][:, lo:hi], args[1]) + (
                                (args[2][:, lo:hi],) + args[3:] if len(args) > 2 else ())
                            got = warp_mod.warp(*bargs, **(dict(mask=mask[r0:r1]) if wipe else {}),
                                                rows=Rows(r0, r1, h, lo))
                            held("warp", full[:, r0:r1], got, f"{w}x{h} sp={sp} C {c} {case} {name} rows {r0}-{r1}")
            for c in (3, 4):  # B14
                a, b = frames[c][0], frames[c][1]
                for name, m in rot_mats.items():
                    other = "-179.6 deg x0.9" if name == "100 deg x0.9" else "100 deg x0.9"
                    mb = rot_mats[other]
                    cases = {"single": ((a, m), {}, [name], False),
                             "dissolve": ((a, m, b, mix), {}, [name], True),
                             "dissolve, two matrices": ((a, m, b, mix, mb), {}, [name, other], True),
                             "wipe": ((a, m, b), dict(mask=mask), [name], True),
                             "wipe, two matrices": ((a, m, b), dict(mat_b=mb, mask=mask), [name, other], True)}
                    for case, (args, kw, names, pair) in cases.items():
                        full = R.rotate(*args, **kw)
                        used = [rot_host[n] for n in names]
                        wins = _warp_rows(used, bands, w, h, rotated=True)
                        for (r0, r1), (lo, hi) in zip(bands, wins):
                            rows = Rows(r0, r1, h, lo)
                            bargs = (args[0][:, lo:hi], args[1]) + (
                                (args[2][:, lo:hi],) + args[3:] if len(args) > 2 else ())
                            bkw = dict(kw, mask=mask[r0:r1]) if "mask" in kw else dict(kw)
                            counts = torch.zeros(2, dtype=torch.int64, device=dev)
                            got = R.rotate(*bargs, **bkw, branches=counts, rows=rows)
                            what = f"{w}x{h} sp={sp} C {c} {case} {name} rows {r0}-{r1} window {lo}-{hi}"
                            ref = full[:, r0:r1]
                            same = ref.shape == got.shape and torch.equal(ref.view(torch.int32), got.view(torch.int32))
                            check(same, f"sp band form rotate ({what}): differs from the full-frame launch bit for bit")
                            out["rotate"]["bands"] += 1
                            plain = R.rotate_plain(*bargs, **bkw, rows=rows)
                            check(torch.allclose(plain, got, rtol=0.0, atol=0.0, equal_nan=True),
                                  f"sp band form rotate ({what}): differs from the band plain version")
                            n_src = hi - lo
                            if len(used) == 2:
                                want = [x + y for x, y in zip(*(R.window_counts(um, w, h, True, rows, n_src)
                                                                for um in used))]
                            else:
                                want = [(2 if pair else 1) * x
                                        for x in R.window_counts(used[0], w, h, pair, rows, n_src)]
                            check(counts.tolist() == want, f"rotate band {what}: window/direct {counts.tolist()}, "
                                                           f"window_counts gives {want}")
                            for i in (0, 1):
                                rot_branches[i] += want[i]
            for name in SP_MATS:  # B6
                m, mb = mats[name], mats["flip"]
                for args, names in (((words[0], m, w, h), [name]), ((words[0], m, w, h, words[1], mix), [name]),
                                    ((words[0], m, w, h, words[1], mix, mb), [name, "flip"])):
                    full = PW.packed_warp(*args)
                    pair_mats = [m] + ([mb if len(args) > 6 else m] if len(args) > 4 else [])
                    for r0, r1 in bands:
                        lo, hi = win(names, r0, r1)
                        rows = Rows(r0, r1, h, lo)
                        bargs = (args[0][lo:hi],) + args[1:4] + ((args[4][lo:hi],) + args[5:] if len(args) > 4 else ())
                        counts = torch.zeros(2, dtype=torch.int64, device=dev)
                        what = f"{w}x{h} sp={sp} {len(pair_mats)} source(s) {name} rows {r0}-{r1}"
                        held("packed_warp", full[:, r0:r1], PW.packed_warp(*bargs, rows=rows, branches=counts), what)
                        want = [sum(x) for x in zip(*(PW.warp_window_counts(pm, w, h, rows) for pm in pair_mats))]
                        check(counts.tolist() == want, f"packed_warp band {what}: window/direct {counts.tolist()}, "
                                                       f"warp_window_counts gives {want}")
            layer_of = (0, 0, 1, 2, 2)  # K5: a dissolve, a cut and a dissolve, a matrix each
            for kind in ("packed", "rgb3", "rgba"):
                srcs = words if kind == "packed" else [frames[3 if kind == "rgb3" else 4][i % 3] for i in range(5)]
                for lm in (("dry run", "box 0.25", "past the edge"), ("flip", "dry run", "box 0.25")):
                    ms, mixes = [mats[n] for n in lm], [mix, None, mix2]
                    for emit, alpha in (("packed", "top"), ("both", "top"), ("rgba", "coverage")):
                        kw = dict(src_kind=kind, size=(w, h), emit=emit, alpha=alpha)
                        full = PW.packed_composite(srcs, (2, 1, 2), ms, mixes, **kw)
                        full = full if isinstance(full, tuple) else (full,)
                        for r0, r1 in bands:
                            wins = [win([lm[li]], r0, r1) for li in layer_of]
                            cut = [s[lo:hi] if kind == "packed" else s[:, lo:hi] for s, (lo, hi) in zip(srcs, wins)]
                            got = PW.packed_composite(cut, (2, 1, 2), ms, mixes, **kw,
                                                      rows=Rows(r0, r1, h, tuple(lo for lo, _ in wins)))
                            got = got if isinstance(got, tuple) else (got,)
                            for f, g in zip(full, got):
                                held("packed_composite", f[r0:r1] if f.dtype == torch.int32 else f[:, r0:r1], g,
                                     f"{w}x{h} sp={sp} {kind} emit {emit} {lm} rows {r0}-{r1}")
            for c, opaque in ((3, False), (4, False), (4, True)):  # B9
                ring = frames[c]
                for tff in (True, False):
                    for parity in (0, 1):
                        par = torch.tensor(parity, dtype=torch.int32, device=dev)
                        for skip in (False, True):
                            full = Y.yadif_ring(*ring, par, tff, skip, opaque)
                            for r0, r1 in bands:
                                lo, hi = Y.ring_window(r0, r1, h)
                                got = Y.yadif_ring(*(f[:, lo:hi] for f in ring), par, tff, skip, opaque,
                                                   rows=Rows(r0, r1, h, lo))
                                held("yadif_ring", full[:, r0:r1], got, f"{w}x{h} sp={sp} C {c} opaque {opaque} "
                                     f"tff {tff} parity {parity} skip {skip} rows {r0}-{r1}")
    torch.cuda.synchronize()
    check(min(rot_branches) > 0, f"rotate bands: window/direct pairs {rot_branches}, both branches expected")
    out["rotate"]["window_direct"] = rot_branches
    print(f"sp band forms on the card vs their full-frame launches at {list(sizes)}, sp {list(sps)}: "
          + ", ".join(f"{k} {v['bands']} band launches max |delta| {v['max_abs_err']}" for k, v in out.items())
          + f"; rotate's bands max |delta| 0 from their plain version too, window/direct (tile, source) pairs "
          f"{rot_branches}, each launch's equal to window_counts' ({time.perf_counter() - t0:.2f} s)")
    return out


async def sp_channel_pair(fmt, reg, dev, sp: int, load, out_format: str = "v210"):
    """A channel row-sharded over [dev] * sp and its twin on dev alone,
    each given ``load`` (an async fn of the channel)."""
    from phaneron_tpu_torch.runtime.channel import Channel

    twin = Channel(1, fmt, reg, out_format=out_format, device=dev)
    banded = Channel(2, fmt, reg, out_format=out_format, sp_devices=[dev] * sp)
    for ch in (twin, banded):
        await load(ch)
    return twin, banded


def sp_channels(torch, dev, card: str, run_path, arun) -> None:
    """Row-sharded Channels on the card against their unsharded twins,
    every packed plane equal, each driven with the launch counts zeroed:
    2160p50 BARS at sp=2 (the fused route, a B3 launch a band), 1080p50
    with a BARS box over a RAMP at sp=4 (B6, K1 and B5 a band), 1080p50 with
    two boxes at sp=4 (K5's packed kind a band), 1080i50 with two boxes
    at sp=4 (each slot's 3-frame ring through B9 a band, K5's rgb3 kind a
    band; its twin takes the slot's pair route), 2160p50 one_rotation at
    sp=4 (K5's packed kind with coverage, K1, B14's band form and B5 a
    band) and 1080p50 into nv12 at sp=8 with a box turned 30 degrees over
    a RAMP (bands of 134 and 136 rows: K1, B14's band form and B13 a
    band)."""
    from phaneron_tpu_torch.config import get_video_format
    from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry
    from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer

    reg = ProducerRegistry([create_test_pattern_producer])

    async def bars(ch):
        await ch.load_source(1, LoadParams("BARS"))
        ch.play(1)

    async def box_over_ramp(ch):  # a top layer without DVE would cover it all (the fused route)
        await ch.load_source(1, LoadParams("RAMP"))
        ch.play(1)
        await ch.load_source(2, LoadParams("BARS"))
        ch.play(2)
        ch.layer(2).set_fill(0.05, 0.1, 0.8, 0.85)

    async def two_boxes(ch):
        await box_over_ramp(ch)
        ch.layer(1).set_fill(0.3, -0.1, 0.6, 0.7)

    async def one_rotation(ch):  # bench.py's one_rotation: a DVE run under a layer turned 100 degrees
        await two_boxes(ch)
        await ch.load_source(3, LoadParams("BARS"))
        ch.play(3)
        ch.layer(3).set_fill(0.05, 0.05, 0.9, 0.9)
        ch.layer(3).set_rotation(100 / 360.0)

    async def rotated_box(ch):
        await box_over_ramp(ch)
        ch.layer(2).set_fill(0.2, 0.2, 0.6, 0.6)
        ch.layer(2).set_rotation(30 / 360.0)

    cases = {  # path -> (format, sp, load, ticks a frame, launches a frame, packed composite modes)
        "sp_2160p_bars": ("2160p5000", 2, bars, 1, {"fused_v210": 2}, None),
        "sp_1080p_dve": ("1080p5000", 4, box_over_ramp, 1,
                         {"packed_warp": 4, "v210_unpack": 4, "combine_pack": 4}, None),
        "sp_1080p_two_boxes": ("1080p5000", 4, two_boxes, 1, {"packed_composite": 4},
                               {("packed", "packed", "top"): 4}),
        "sp_1080i_two_boxes": ("1080i5000", 4, two_boxes, 2,
                               {"v210_unpack": 2, "yadif_ring": 16, "packed_composite": 8},
                               {("rgb3", "packed", "top"): 8}),
        "sp_2160p_one_rotation": ("2160p5000", 4, one_rotation, 1,
                                  {"packed_composite": 4, "v210_unpack": 4, "rotate": 4, "combine_pack": 4},
                                  {("packed", "rgba", "coverage"): 4}),
        "sp_1080p_nv12_rotated_box": ("1080p5000", 8, rotated_box, 1,
                                      {"v210_unpack": 16, "rotate": 8, "planar420_pack": 8}, None),
    }
    out_formats = {"sp_1080p_nv12_rotated_box": "nv12"}
    for path, (fmt_name, sp, load, ticks, per_frame, modes) in cases.items():
        fmt = get_video_format(fmt_name)
        twin, banded = arun(sp_channel_pair(fmt, reg, dev, sp, load, out_formats.get(path, "v210")))
        warm = 8 if fmt.interlaced else 2  # the rings fill (three pulls) and each structure is prepared
        for _ in range(warm):
            arun(twin.render_frame())
            arun(banded.render_frame())
        want = [arun(twin.render_frame()).packed for _ in range(SP_CHANNEL_FRAMES * ticks)]

        def drive():
            for k in range(SP_CHANNEL_FRAMES * ticks):
                got = arun(banded.render_frame()).packed
                check(len(got) == len(want[k]) and all(torch.equal(g, x) for g, x in zip(got, want[k])),
                      f"{path}: tick {k} differs from the unsharded twin's planes")

        run_path(path, per_frame, SP_CHANNEL_FRAMES, drive, modes=modes)
        live = banded._last_layer_specs
        if fmt.interlaced:
            check(all(ls.deinterlace for ls in live.values()), f"{path}: a slot left the ring: {live}")
        bands = banded._sp_programs[next(reversed(banded._sp_programs))].last_bands
        print(f"{path}: {fmt.width}x{fmt.height} at sp={sp} on {card}, {SP_CHANNEL_FRAMES * ticks} ticks equal "
              f"to the unsharded twin's words; bands {[b['rows'] for b in bands]}, launches a band "
              f"{bands[0]['launches']}")
        arun(twin.shutdown())
        arun(banded.shutdown())


def sp_server(torch, dev, card: str, run_path, arun, record: dict, server_device=None) -> None:
    """configs/uhd_sp_sharded.json through the port's server: two 2160p50
    channels, each row-sharded over a group of four (cuda:0 four times on
    one card), a file and an MJPEG consumer; over AMCP PLAY 1-1 BARS,
    MIXER 1-1 ROTATION 30 and PLAY 2-1 route://1 (channel 1's frame
    resharded onto channel 2's group); SP_SERVER_SECONDS paced: ticks,
    deliveries and late_frames a channel; then SP_SERVER_TICKS ticks
    counted (channel 1: K1, B14's band form and K2 a band, under the
    ROUTE's emit_rgba; channel 2: K2 a band); the file's last frame 0
    codes from a plain channel playing BARS from the same frame, turned
    as channel 1's layer was when that frame was made."""
    import asyncio
    import tempfile
    from pathlib import Path

    from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry
    from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
    from phaneron_tpu_torch.runtime.channel import Channel
    from phaneron_tpu_torch.server import PhaneronServer

    out_dir = Path(tempfile.mkdtemp(prefix="phaneron_sp_server_"))
    cfg = server_config(out_dir, config="uhd_sp_sharded.json")
    for cc in cfg.channels:
        if cc.device["name"] == "file":
            cc.device = dict(cc.device, max_frames=SP_SERVER_FILE_FRAMES)

    async def session():
        server = PhaneronServer(cfg, device=server_device)
        count_deliveries(server)
        await server.start()
        chans = server.channels
        groups = {n: [str(d) for d in ch._sp_mesh.flat] for n, ch in chans.items()}
        check(all(len(g) == 4 for g in groups.values()), f"sp server: groups {groups}")
        # the test pattern's frame behind each frame the file consumer gets,
        # by the index of its delivery (the channel ran before this)
        cons, deliver = chans[1].consumers[0], chans[1].consumers[0].deliver

        async def deliver_noted(frame):
            lay = chans[1].layers.get(1)
            slot = None if lay is None else lay.cur
            record["positions"][cons.smoke_delivered] = (None if slot is None or slot.last is None
                                                         else (source_position(slot), slot.mixer.params["rotate"]))
            return await deliver(frame)

        record["positions"] = {}
        cons.deliver = deliver_noted
        amcp = AmcpClient(*await asyncio.open_connection("127.0.0.1", server.amcp.port))
        await amcp.call("PLAY 1-1 BARS", ["202 PLAY OK"])
        await amcp.call("MIXER 1-1 ROTATION 30", ["202 MIXER OK"])
        await amcp.call("PLAY 2-1 route://1", ["202 PLAY OK"])
        for ch in chans.values():
            await ch.wait_prewarmed()
        before = {n: (ch.timestamp, ch.clock.late_frames) for n, ch in chans.items()}
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SP_SERVER_SECONDS:
            await amcp.call("INFO", ["200 INFO OK", *(f"{n} {ch.fmt.name} PLAYING" for n, ch in chans.items()), ""])
            await asyncio.sleep(SERVER_PROBE_S)
        seconds = time.perf_counter() - t0
        stats = {n: ch.stats() for n, ch in chans.items()}
        await stop_paced(server)
        rows = []
        for n, ch in chans.items():
            delivered = [c.smoke_delivered for c in ch.consumers]
            check(delivered == [ch.timestamp], f"sp server channel {n}: {ch.timestamp} ticks, delivered {delivered}")
            rows.append(dict(channel=n, group=groups[n], ticks=ch.timestamp, delivered=delivered[0],
                             window_ticks=ch.timestamp - before[n][0], late_frames=ch.clock.late_frames - before[n][1],
                             render_p50_host_ms=stats[n]["render_p50_ms"], render_p99_host_ms=stats[n]["render_p99_ms"]))
            print(f"sp server paced on {card}: channel {n} ({cfg.channels[n - 1].device['name']}, group {groups[n]}) "
                  f"{ch.timestamp} ticks, {delivered[0]} delivered; in the {seconds:.3f} s window "
                  f"{rows[-1]['window_ticks']} ticks, late_frames {rows[-1]['late_frames']}, render p50 "
                  f"{rows[-1]['render_p50_host_ms']:.4f} p99 {rows[-1]['render_p99_host_ms']:.4f} host ms")
        await amcp.close()
        record.update(server=server, rows=rows, seconds=seconds)

    arun(session())
    server = record["server"]
    chans = server.channels

    def ticks():
        for _ in range(SP_SERVER_TICKS):
            for ch in chans.values():
                arun(server_tick(ch))

    run_path("sp_server", {"v210_unpack": 4, "rotate": 4, "v210_pack": 8}, SP_SERVER_TICKS, ticks)
    routed = chans[2].layers[1].cur.last.payload
    check(hasattr(routed, "mesh"), "sp server: channel 2's routed frame is not channel 1's bands")
    cons = chans[1].consumers[0]
    cons.release()
    fmt = chans[1].fmt
    written = last_written(torch, dev, cons, fmt.height)

    n_file = min(SP_SERVER_FILE_FRAMES, chans[1].consumers[0].smoke_delivered)  # the frames the file takes
    noted = record["positions"].get(n_file - 1)  # the source's frame in the file's last, and its turn
    check(noted is not None, f"sp server: the file's last frame ({n_file}) came before PLAY 1-1")
    seek, turns = noted
    check(turns == 30 / 360.0, f"sp server: the file's last frame was made at rotation {turns * 360} degrees")

    async def plain():  # BARS from the frame the server's source played into the file's last frame
        twin = Channel(1, fmt, ProducerRegistry([create_test_pattern_producer]), device=dev, plain=True)
        await twin.load_source(1, LoadParams("BARS", seek=seek))
        twin.play(1)
        twin.layer(1).set_rotation(turns)
        frame = await twin.render_frame()
        await twin.shutdown()
        return frame.packed[0]

    delta = code_delta(torch, written, arun(plain()), fmt.width, fmt.height)
    check(cons.written == n_file and delta == 0,
          f"sp server: {cons.written} frames written, the last {delta} codes from the plain twin")
    print(f"sp server: channel 1's file holds {cons.written} {fmt.width}x{fmt.height} frames, the last 0 codes "
          f"from a plain channel playing BARS turned 30 degrees; channel 2 plays channel 1's frame as channel 1's "
          f"bands left it")
    arun(server.shutdown())
    record.pop("server")


def sp_band_overhead(torch, dev, card: str) -> dict:
    """Two UHD frames unsharded and row-sharded over [dev] * sp, sp 2 and
    4, in turns: the dry run's frame (the yadif ring, an axis-aligned DVE,
    the v210 pack) and the one_rotation frame (K5's packed run with
    coverage, K1, B14 turned 100 degrees, B5).  Each is timed as ms a
    frame between CUDA events (time_ms: the host's enqueue included, which
    banding multiplies) and device ms a frame (device_ms: the frames
    captured in a CUDA graph and replayed, the card's own cost: the halo
    copies and more, smaller launches).  What splitting a frame into bands
    costs on one card.  Returns {frame: {sp: record}}."""
    from phaneron_tpu_torch.graph.pipeline import make_channel_program
    from phaneron_tpu_torch.parallel.bands import make_sp_channel_program
    from phaneron_tpu_torch.parallel.dryrun import uhd_spec_and_params
    from phaneron_tpu_torch.parallel.mesh import make_sp_mesh

    one_rotation = straggler_spec_params(torch, dev, *SP_UHD, "one_rotation")
    for lp in one_rotation[1]["layers"]:  # the host copy the bands' windows come from, as Mixer.matrix_on leaves it
        lp["matrix"].host = lp["matrix"].cpu().numpy()
    frames = {"dry run (yadif ring + DVE + v210 pack)": uhd_spec_and_params(*SP_UHD, dev),
              "one_rotation (K5 run + K1 + rotate 100 degrees + B5)": one_rotation}
    result = {}
    for label, (spec, params) in frames.items():
        runs = {"sp=1": lambda spec=spec, params=params: make_channel_program(spec)(params)}
        for sp in (2, 4):
            prog = make_sp_channel_program(spec, make_sp_mesh([dev] * sp))
            runs[f"sp={sp}"] = lambda prog=prog, params=params: prog(params)
        ms = {k: [] for k in runs}
        dms = {k: [] for k in runs}
        for order in ("sp=1", "sp=2", "sp=4", "sp=4", "sp=2", "sp=1"):
            ms[order].append(time_ms(torch, runs[order], batches=5, calls=5))
            dms[order].append(device_ms(torch, runs[order], batches=5, calls=5))
        out = {k: dict(ms=statistics.median(v), runs=v, device_ms=statistics.median(dms[k]), device_runs=dms[k])
               for k, v in ms.items()}
        base = out["sp=1"]
        print(f"sp band overhead on one card ({card}), {label} {SP_UHD[0]}x{SP_UHD[1]} in turns, ms a frame "
              f"between CUDA events / device ms a frame: "
              + "; ".join(f"{k} {v['ms']:.4f} (runs {v['runs']}) / {v['device_ms']:.4f} (runs {v['device_runs']}), "
                          f"{v['ms'] / base['ms']:.3f}x / {v['device_ms'] / base['device_ms']:.3f}x"
                          for k, v in out.items()))
        result[label] = out
    return result


def phase_sp(torch, dev, card: str, run_path, timing: dict, server_device=None) -> dict:
    """Row-sharded (sp) channels (ROADMAP A10) on the card: the band forms
    against their full-frame launches (``sp_band_checks``); the three dry
    runs on [dev] * n (UHD at sp=4, ch x sp ROUTE at n=4, multichip at
    n=8, which also runs UHD at sp=8 and the ROUTE at n=8), each banded
    result bit-equal to one band, launch counts zeroed and checked;
    row-sharded Channels against their twins (``sp_channels``); the
    server on configs/uhd_sp_sharded.json (``sp_server``); the two-process
    multihost dry run with both ranks on the card; and the band overhead
    on one card (``sp_band_overhead``).  Returns the band-form records."""
    import asyncio

    from phaneron_tpu_torch.parallel import dryrun
    from phaneron_tpu_torch.parallel.multihost import dryrun_multihost

    t0 = time.perf_counter()
    bands = sp_band_checks(torch, dev, np.random.default_rng(SEED + 21))
    # the dry runs: each program's launches, a band each, and its one-device check
    run_path("sp_dryrun_uhd", {"yadif_ring": 5, "warp": 5, "combine_pack": 5}, 1,
             lambda: dryrun.dryrun_sp_sharded_uhd([dev] * 4, *SP_UHD))
    run_path("sp_dryrun_ch_sp_route", {"v210_unpack": 3, "v210_pack": 3, "warp": 3, "combine_pack": 3}, 1,
             lambda: dryrun.dryrun_ch_sp_route([dev] * 4))
    run_path("sp_dryrun_multichip", {"packed_warp": 9, "planar422_unpack": 9, "yadif_ring": 9, "warp": 14,
                                     "combine_pack": 23, "v210_unpack": 5, "v210_pack": 5}, 1,
             lambda: dryrun.dryrun_multichip(8, [dev] * 8, uhd_size=SP_UHD))
    loop = asyncio.new_event_loop()
    arun = loop.run_until_complete
    try:
        sp_channels(torch, dev, card, run_path, arun)
        server = {}
        sp_server(torch, dev, card, run_path, arun, server, server_device)
    finally:
        loop.close()
    t_mh = time.perf_counter()
    line = dryrun_multihost(timeout=SP_MULTIHOST_TIMEOUT, device=str(dev))
    print(f"sp multihost on {card}: {line} ({time.perf_counter() - t_mh:.2f} s)")
    overhead = sp_band_overhead(torch, dev, card)
    timing["sp"] = dict(band_overhead=overhead, server=server, seconds=time.perf_counter() - t0)
    print(f"sp phase: {time.perf_counter() - t0:.2f} s")
    return bands


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from phaneron_tpu_torch.graph.pipeline import make_channel_program
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops import rotate as R
    from phaneron_tpu_torch.ops import warp as warp_mod
    from phaneron_tpu_torch.ops import yadif as Y
    from phaneron_tpu_torch.ops.formats.v210 import pitch_bytes
    from phaneron_tpu_torch.ops.formats.yuv422p8 import pitch as y422_pitch
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -------- phase 2: build
    _build.library()
    info = _build.build_info()
    print(f"build: {'compiled' if info.compiled else 'loaded'} {info.path.name} in {info.seconds:.2f} s")
    for line in ptxas_lines(info.log):
        print("  ptxas:", line)

    # -------- phase 3: kernels against their plain versions
    rng = np.random.default_rng(SEED)
    rec = phase_kernels(torch, dev, rng)
    phase_interlaced_kernels(torch, dev, rng, rec)
    phase_packed_source_kernels(torch, dev, rng, rec)
    phase_v210_pack_sweep(torch, dev, np.random.default_rng(SEED + 15), rec)
    phase_straggler_kernels(torch, dev, rng, rec)
    phase_window_edges(torch, dev, np.random.default_rng(SEED + 7), rec)
    phase_rotate_edges(torch, dev, np.random.default_rng(SEED + 8), rec)
    phase_axis_warp_edges(torch, dev, np.random.default_rng(SEED + 9), rec)
    media_rng = np.random.default_rng(SEED + 5)  # the earlier paths keep their inputs
    phase_planar_kernels(torch, dev, media_rng, rec)
    phase_planar_unpack_sweep(torch, dev, np.random.default_rng(SEED + 11), rec)
    phase_planar_pack_sweep(torch, dev, np.random.default_rng(SEED + 13), rec)
    phase_rgb8_unpack(torch, dev, np.random.default_rng(SEED + 19), rec)
    phase_stage_program_checks(torch, dev, media_rng)
    multibox_rng = np.random.default_rng(SEED + 6)
    phase_composite_modes(torch, dev, multibox_rng, rec)

    wrappers = {
        "v210_unpack": K.v210_unpack, "warp": warp_mod.warp,
        "planar422_unpack": K.planar422_unpack, "v210_pack": K.v210_pack,
        "yadif_ring": Y.yadif_ring, "yadif_pair": Y.yadif_pair,
        "packed_composite": PW.packed_composite, "fused_v210": K.fused_v210,
        "combine_pack": K.combine_pack, "packed_warp": PW.packed_warp, "rotate": R.rotate,
        "planar422_pack": K.planar422_pack, "planar420_unpack": K.planar420_unpack,
        "planar420_pack": K.planar420_pack, "rgb8_unpack": K.rgb8_unpack,
    }
    launches = {k: {} for k in wrappers}
    mode_launches = {}  # path -> packed_composite launches by (src_kind, emit, alpha)

    # the frame program's torch tail, counted per path: the 'over' of
    # staged layers and the alpha fix-up of a run that holds the top
    from phaneron_tpu_torch.graph import pipeline as pipe_mod

    tail_calls = {"combine": 0, "_top_alpha_fixup": 0}

    def counted(name: str):
        fn = getattr(pipe_mod, name)

        def call(*args, **kw):
            tail_calls[name] += 1
            return fn(*args, **kw)

        return call

    for name in tail_calls:
        setattr(pipe_mod, name, counted(name))

    # the packed composite's launches split by mode: each call of the frame
    # program's that raised the wrapper's one counter, by its (src_kind,
    # emit, alpha)
    by_mode_now = {}

    def packed_composite_by_mode(*args, src_kind, emit, alpha, **kw):
        before = PW.packed_composite.launches
        out = PW.packed_composite(*args, src_kind=src_kind, emit=emit, alpha=alpha, **kw)
        if PW.packed_composite.launches > before:
            mode = (src_kind, emit, alpha)
            by_mode_now[mode] = by_mode_now.get(mode, 0) + PW.packed_composite.launches - before
        return out

    pipe_mod._KERNELS = pipe_mod._KERNELS._replace(packed_composite=packed_composite_by_mode)

    def run_path(path: str, per_frame: dict, frames: int, fn, modes: dict | None = None,
                 tail: dict | None = None) -> None:
        """Drive one main path with every count at 0 just before and read
        just after: each kernel named in ``per_frame`` must have launched
        exactly that many times a frame, every other kernel not at all;
        packed_composite in exactly the ``modes`` given a frame ((src_kind,
        emit, alpha) -> launches), and the torch tail calls named in
        ``tail`` exactly that many times a frame in each of the kernel path
        and the plain path the frames are checked against."""
        for w in wrappers.values():
            w.launches = 0
        by_mode_now.clear()
        for name in tail_calls:
            tail_calls[name] = 0
        tables = K.fused_v210_corrections_on.launches, K.l2g_corrections_on.launches
        fn()
        torch.cuda.synchronize()
        check(K.fused_v210_corrections_on.launches == tables[0],
              f"{path}: a frame built fused_v210's transfer corrections (the program's prepare() builds them)")
        check(K.l2g_corrections_on.launches == tables[1],
              f"{path}: a frame built the l2g corrections (the program's prepare() builds them)")
        for k, w in wrappers.items():
            launches[k][path] = w.launches
        mode_launches[path] = dict(by_mode_now)
        print(f"{path} path launches: { {k: launches[k][path] for k in wrappers} }; packed_composite by "
              f"mode {mode_launches[path]}; torch tail calls {dict(tail_calls)}")
        for k in wrappers:
            want = per_frame.get(k, 0) * frames
            check(launches[k][path] == want, f"{path}: {k} launched {launches[k][path]} times, "
                                             f"expected {want} over {frames} frames")
        check(sum(mode_launches[path].values()) == launches["packed_composite"][path],
              f"{path}: packed_composite launched outside the frame program")
        want_modes = {m: n * frames for m, n in (modes or {}).items()}
        check(mode_launches[path] == want_modes, f"{path}: packed_composite modes {mode_launches[path]}, "
                                                 f"expected {want_modes}")
        for name, n in (tail or {}).items():
            check(tail_calls[name] == 2 * n * frames, f"{path}: {name} called {tail_calls[name]} times, "
                                                      f"expected {n} a frame on each path over {frames} frames")

    timing = {}

    # -------- phase 4a: the entry() path (packed warp pair, planar unpack, combine + pack)
    spec, params = entry_spec_params(rng, dev)
    program = make_channel_program(spec)
    plain_program = make_channel_program(spec, plain=True)
    # the program's prepare() builds the l2g corrections its combine_pack reads, once
    K.l2g_corrections_on.cache_clear()
    built = K.l2g_corrections_on.launches
    program.prepare(dev)
    program.prepare(dev)
    check(K.l2g_corrections_on.launches == built + 1,
          f"entry: prepare() launched the l2g corrections {K.l2g_corrections_on.launches - built} times")

    def entry_path():
        t0 = time.perf_counter()
        worst = drive_frames(torch, program, plain_program, params,
                             lambda t: animate(torch, params, dev, t), FRAMES, W, H, "entry")
        print(f"entry path: {FRAMES} frames {W}x{H} in {time.perf_counter() - t0:.2f} s, "
              f"max code delta vs plain path {worst}")

    run_path("entry", {"packed_warp": 1, "planar422_unpack": 1, "combine_pack": 1}, FRAMES, entry_path)
    animate(torch, params, dev, 0.5)
    timing["entry"] = time_frame(torch, card, f"entry {W}x{H}", program, plain_program, params)
    entry_warp_args = (params["layers"][0]["src"][0], params["layers"][0]["matrix"], W, H,
                       params["layers"][0]["src_b"][0], params["layers"][0]["mix"])
    entry_pack_layers = [PW.packed_warp(*entry_warp_args),
                         K.planar422_unpack(params["layers"][1]["src"], W, H)]

    # -------- phase 4b: the progressive frame (bench.py composite_step), UHD and 1080p
    prog_args = {}
    for w, h in ((UHD_W, UHD_H), (W, H)):
        pspec, pparams = progressive_spec_params(torch, dev, rng, w, h)
        pprog = make_channel_program(pspec)
        pplain = make_channel_program(pspec, plain=True)
        path = f"progressive_{w}x{h}"

        def progressive_path():
            t0 = time.perf_counter()
            worst = drive_frames(torch, pprog, pplain, pparams,
                                 lambda t: progressive_animate(torch, pparams, dev, t), PROG_FRAMES, w, h, path)
            print(f"{path}: {PROG_FRAMES} frames (4 DVE + dissolve layers, 8 v210 sources) in "
                  f"{time.perf_counter() - t0:.2f} s, max code delta vs plain path {worst}")

        run_path(path, {"packed_composite": 1}, PROG_FRAMES, progressive_path,
                 modes={("packed", "packed", "top"): 1})
        progressive_animate(torch, pparams, dev, 0.5)
        lps = pparams["layers"]
        srcs = [s for lp in lps for s in (lp["src"][0], lp["src_b"][0])]
        cfg, mats, mixes = (2, 2, 2, 2), [lp["matrix"] for lp in lps], [lp["mix"] for lp in lps]
        staged = lambda: PW.packed_composite(K.v210_unpack(srcs, w, h, channels=3), cfg, mats, mixes)
        timing[path] = time_frame(torch, card, path, pprog, pplain, pparams,
                                  extra={"staged K1 (3 ch) + K5 (rgb3) ms": staged})
        prog_args[(w, h)] = ((srcs, cfg, mats, mixes), dict(src_kind="packed", size=(w, h)))

    # -------- phase 4c: playout (fused v210: a cut, and a dissolve with the mix animating)
    playout_args = {}
    for w, h in ((W, H), (UHD_W, UHD_H)):
        for dissolve in (False, True):
            sspec, sparams = playout_spec_params(torch, dev, rng, w, h, dissolve)
            sprog = make_channel_program(sspec)
            splain = make_channel_program(sspec, plain=True)
            sprog.prepare(dev)
            path = f"playout_{'dissolve' if dissolve else 'cut'}_{w}x{h}"

            def playout_path():
                worst = drive_frames(torch, sprog, splain, sparams,
                                     lambda t: playout_animate(torch, sparams, dev, t), PLAYOUT_FRAMES, w, h, path)
                print(f"{path}: {PLAYOUT_FRAMES} frames, max code delta vs plain path {worst}")

            run_path(path, {"fused_v210": 1}, PLAYOUT_FRAMES, playout_path)
            playout_animate(torch, sparams, dev, 0.5)
            timing[path] = time_frame(torch, card, path, sprog, splain, sparams)
            lp = sparams["layers"][0]
            playout_args[(w, h, dissolve)] = (
                (lp["src"][0], w, h, lp["src_b"][0], lp["mix"]) if dissolve else (lp["src"][0], w, h))

    # -------- phase 4d: the producer unpack and consumer pack stage programs
    from phaneron_tpu_torch.graph.convert import to_tensor, words_to_numpy
    from phaneron_tpu_torch.graph.pipeline import make_pack_program, make_unpack_program
    from phaneron_tpu_torch.ops.formats import v210 as v210fmt

    fill_np = v210fmt.fill_buf(W, H)[0]
    fill = to_tensor(fill_np, dev)
    unpack_stage = make_unpack_program("v210", W, H, "709", "709")
    pack_stage = make_pack_program("v210", W, H, "709")

    def stage_path():
        for _ in range(4):
            (out,) = pack_stage(unpack_stage([fill]))
            check(np.array_equal(words_to_numpy(out), fill_np), "stage programs: fill_buf round trip")
        print("stage programs: unpack -> pack of fill_buf == fill_buf, 4 frames")

    run_path("stage_programs", {"v210_unpack": 1, "v210_pack": 1}, 4, stage_path)

    # -------- phase 6: the interlaced default load, 4 x 1080i50
    chans = interlaced_inputs(torch, dev, rng)
    load = InterlacedLoad(chans, plain=False)
    plain_load = InterlacedLoad(chans, plain=True)
    v210_words = pitch_bytes(W) // 4

    def interlaced_path():
        worst = 0
        t0 = time.perf_counter()
        for p in range(PERIODS):
            outs = load()
            refs = plain_load()
            for c, (o, r) in enumerate(zip(outs, refs)):
                check(tuple(o.shape) == (H, v210_words) and o.dtype == torch.int32,
                      f"period {p} channel {c}: output {tuple(o.shape)} {o.dtype}")
                d = code_delta(torch, o, r, W, H)
                worst = max(worst, d)
                check(d <= TOL_CODES, f"period {p} channel {c}: kernel path {d} codes from the plain path")
        print(f"interlaced path: {PERIODS} frame periods of {N_CHANNELS} channels {W}x{H} "
              f"({N_SOURCES} v210 sources, 4 DVE + dissolve layers each) in "
              f"{time.perf_counter() - t0:.2f} s, max code delta vs plain path {worst}")

    # per period: each tick one packed composite, no staged warp or pack
    run_path("interlaced", {"v210_unpack": N_CHANNELS * N_SOURCES, "yadif_pair": N_CHANNELS * N_SOURCES,
                            "packed_composite": N_CHANNELS * 2}, PERIODS, interlaced_path,
             modes={("rgb3", "packed", "top"): N_CHANNELS * 2})

    # -------- phase 7: the in-program ring route on channel 0
    ring_program = make_channel_program(interlaced_spec(deinterlace=True))
    ch0, rings0 = chans[0], load.rings[0]
    p_last = (load.period_index - 1) % PERIODS
    parities = [torch.tensor(p, dtype=torch.int32, device=dev) for p in ((0, 1) if TFF else (1, 0))]
    ring_out = []
    ring_params = [{"layers": [
        {"src_ring": tuple(rings0[2 * i]), "src_b_ring": tuple(rings0[2 * i + 1]),
         "parity": parities[t], "matrix": ch0["mats"][i], "mix": ch0["mixes"][p_last][t][i]}
        for i in range(4)
    ]} for t in (0, 1)]

    def ring_route():
        for t in (0, 1):
            ring_out.append(ring_program(ring_params[t])[0])

    run_path("ring_route", {"yadif_ring": N_SOURCES, "packed_composite": 1}, 2, ring_route,
             modes={("rgb3", "packed", "top"): 1})
    fields = [load.pair(*ring) for ring in rings0]
    for t in (0, 1):
        (via_pair,) = load.program(load.tick_params(ch0, fields, p_last, t))
        check(torch.equal(ring_out[t], via_pair), f"ring route tick {t} differs from the pair route")
    print("ring route (deinterlace=True, parity on the card) == pair route, both ticks: True")
    # the route's device time a tick: a tick's launches captured into a CUDA
    # graph and replayed (chip_smoke.device_ms), each tick's parity
    route_ms = [device_ms(torch, lambda t=t: ring_program(ring_params[t]), batches=5, calls=4) for t in (0, 1)]
    timing["ring_route_tick"] = dict(device_ms=statistics.mean(route_ms), ticks=route_ms)
    print(f"ring route on {card}: {timing['ring_route_tick']['device_ms']:.4f} device ms a tick (parity "
          f"{int(parities[0])} {route_ms[0]:.4f}, parity {int(parities[1])} {route_ms[1]:.4f}; "
          f"{N_SOURCES} yadif_ring + 1 packed_composite rgb3 a tick)")

    # -------- phase 7b: the straggler channels (bench.py composite_variant_step)
    # and emit_rgba channels: a packed composite run emitting its frame under
    # a rotated, wiped or rotated-pair top layer
    straggler_args = {}
    straggler_launches = {
        "one_rotation": {"v210_unpack": 1, "packed_composite": 1, "rotate": 1, "combine_pack": 1},
        "wipe": {"v210_unpack": 1, "packed_composite": 1, "warp": 1, "combine_pack": 1},
        "rotated_pair": {"v210_unpack": 1, "packed_composite": 1, "rotate": 1, "combine_pack": 1},
    }
    straggler_cases = [(variant, w, h, False) for variant in ("one_rotation", "wipe")
                       for w, h in ((UHD_W, UHD_H), (W, H))]
    straggler_cases += [("rotated_pair", W, H, False), ("progressive", W, H, True), ("one_rotation", W, H, True)]
    for variant, w, h, emit_rgba in straggler_cases:
        if variant == "progressive":
            vspec, vparams = progressive_spec_params(torch, dev, rng, w, h)
            vspec = vspec._replace(emit_rgba=True)
            vanimate = lambda t, p=vparams: progressive_animate(torch, p, dev, t)
            # one 'both' launch, words and frame with the top layer's alpha
            per_frame, k5_modes = {"packed_composite": 1}, {("packed", "both", "top"): 1}
            tail = {"combine": 0, "_top_alpha_fixup": 0}
        else:
            vspec, vparams = straggler_spec_params(torch, dev, w, h, variant, emit_rgba)
            vanimate = lambda t, p=vparams, v=variant, w=w, h=h: straggler_animate(torch, p, dev, w, h, v, t)
            per_frame = dict(straggler_launches[variant])
            k5_modes = {("packed", "rgba", "coverage"): 1}  # the 3-layer run under the straggler
            tail = {"combine": int(emit_rgba), "_top_alpha_fixup": 0}
            if emit_rgba:  # the staged emit_rgba tail: torch combine, then K2
                del per_frame["combine_pack"]
                per_frame["v210_pack"] = 1
        vprog = make_channel_program(vspec)
        vplain = make_channel_program(vspec, plain=True)
        vprog.prepare(dev)
        path = f"{variant}{'_emit_rgba' if emit_rgba else ''}_{w}x{h}"
        alpha = (lambda p, s=vspec: top_alpha(torch, s, p)) if emit_rgba else None

        def straggler_path():
            t0 = time.perf_counter()
            worst = drive_frames(torch, vprog, vplain, vparams, vanimate, STRAGGLER_FRAMES, w, h, path,
                                 alpha=alpha)
            print(f"{path}: {STRAGGLER_FRAMES} frames in {time.perf_counter() - t0:.2f} s, max code delta "
                  f"vs plain path {worst}" + (", rgba and top-layer alpha checked" if emit_rgba else ""))

        run_path(path, per_frame, STRAGGLER_FRAMES, straggler_path, modes=k5_modes, tail=tail)
        vanimate(0.5)
        timing[path] = time_frame(torch, card, path, vprog, vplain, vparams)
        straggler_args[path] = (vspec, vparams)

    # -------- phase 7c: the file-media channel, 1080p and UHD
    media_args = {}
    for w, h in ((W, H), (UHD_W, UHD_H)):
        mspec, mparams = media_spec_params(torch, dev, media_rng, w, h)
        media, plain_media = MediaChannel(mspec, plain=False), MediaChannel(mspec, plain=True)
        path = f"media_{w}x{h}"
        if (w, h) == (W, H):  # the program's prepare() builds the packs' l2g corrections, once
            K.l2g_corrections_on.cache_clear()
            built = K.l2g_corrections_on.launches
            media.program.prepare(dev)
            media.program.prepare(dev)
            check(K.l2g_corrections_on.launches == built + 1,
                  f"{path}: prepare() launched the l2g corrections {K.l2g_corrections_on.launches - built} times")

        def media_path():
            t0 = time.perf_counter()
            worst = drive_media(torch, media, plain_media, mparams, dev, MEDIA_FRAMES, w, h, path)
            print(f"{path}: {MEDIA_FRAMES} frames (yuv422p10le cut, yuv420p -> nv12 dissolve under a "
                  f"picture-in-picture DVE, rgba8 key; yuv422p10le out, rgba8 preview, nv12 file) in "
                  f"{time.perf_counter() - t0:.2f} s, max code delta vs plain path {worst}, rgba and "
                  "top-layer alpha checked")

        run_path(path, {"planar422_unpack": 1, "planar420_unpack": 2, "rgb8_unpack": 1, "warp": 1,
                        "planar422_pack": 1, "planar420_pack": 1}, MEDIA_FRAMES, media_path)
        media_animate(torch, mparams, dev, 0.5)
        timing[path] = time_frame(torch, card, path, media, plain_media, mparams)
        media_args[(w, h)] = (mparams, media.program(mparams)["rgba"])

    # -------- phase 7d: the file-media multi-box channel, and the progressive
    # frame into yuv422p10le: whole stacks in one packed composite launch
    # with the top layer's alpha
    multibox_args = {}
    no_tail = {"combine": 0, "_top_alpha_fixup": 0}
    unpacks = {"planar422_unpack": 1, "planar420_unpack": 3, "rgb8_unpack": 1}
    for w, h, fmt, emit_rgba in ((W, H, "v210", True), (UHD_W, UHD_H, "v210", True), (W, H, "yuv422p10le", False)):
        check_quadrants(torch, dev, w, h)
        bspec, bparams = multibox_spec_params(torch, dev, multibox_rng, w, h, fmt, emit_rgba)
        bprog = make_channel_program(bspec)
        bplain = make_channel_program(bspec, plain=True)
        path = f"multibox_{fmt}_{w}x{h}"
        alpha = (lambda p, a=multibox_top_alpha(torch, bspec, bparams): a) if emit_rgba else None
        banimate = lambda t, p=bparams: media_animate(torch, p, dev, t)

        def multibox_path():
            t0 = time.perf_counter()
            worst = drive_frames(torch, bprog, bplain, bparams, banimate, MULTIBOX_FRAMES, w, h, path,
                                 alpha=alpha, fmt=fmt)
            print(f"{path}: {MULTIBOX_FRAMES} frames (yuv422p10le, {MULTIBOX_CLIP[0]}x{MULTIBOX_CLIP[1]} yuv420p -> "
                  f"nv12 dissolve and nv12 boxes under the rgba8 key) in {time.perf_counter() - t0:.2f} s, max code "
                  f"delta vs plain "
                  f"path {worst}" + (", rgba and top-layer alpha checked" if emit_rgba else ""))

        emit = "both" if emit_rgba else "rgba"
        per_frame = dict(unpacks, packed_composite=1, **({} if emit_rgba else {"planar422_pack": 1}))
        run_path(path, per_frame, MULTIBOX_FRAMES, multibox_path, modes={("rgba", emit, "top"): 1}, tail=no_tail)
        banimate(0.5)
        timing[path] = time_frame(torch, card, path, bprog, bplain, bparams)
        multibox_args[(w, h, fmt)] = (bspec, bparams)

    pyspec, pyparams = progressive_spec_params(torch, dev, rng, W, H)
    pyspec = pyspec._replace(out_format="yuv422p10le")
    pyprog, pyplain = make_channel_program(pyspec), make_channel_program(pyspec, plain=True)
    path = f"progressive_yuv422p10le_{W}x{H}"
    pyanimate = lambda t: progressive_animate(torch, pyparams, dev, t)

    def progressive_file_path():
        worst = drive_frames(torch, pyprog, pyplain, pyparams, pyanimate, PROG_FRAMES, W, H, path,
                             fmt="yuv422p10le")
        print(f"{path}: {PROG_FRAMES} frames, max code delta vs plain path {worst}")

    run_path(path, {"packed_composite": 1, "planar422_pack": 1}, PROG_FRAMES, progressive_file_path,
             modes={("packed", "rgba", "top"): 1}, tail=no_tail)
    pyanimate(0.5)
    timing[path] = time_frame(torch, card, path, pyprog, pyplain, pyparams)

    # -------- phase 7e: the keyed graphic over a straggler: an rgba-kind run
    # under it (coverage alpha), the graphic staged with its own alpha
    kspec, kparams = keyed_straggler_spec_params(torch, dev, multibox_rng, W, H)
    kprog, kplain = make_channel_program(kspec), make_channel_program(kspec, plain=True)
    kprog.prepare(dev)
    path = f"keyed_straggler_emit_rgba_{W}x{H}"
    kanimate = lambda t: keyed_straggler_animate(torch, kparams, dev, t)
    key_alpha = multibox_top_alpha(torch, kspec, kparams)

    def keyed_path():
        worst = drive_frames(torch, kprog, kplain, kparams, kanimate, STRAGGLER_FRAMES, W, H, path,
                             alpha=lambda p: key_alpha)
        print(f"{path}: {STRAGGLER_FRAMES} frames (rotated v210 clip, two yuv422p8 -> nv12 boxes, the rgba8 "
              f"key on top), max code delta vs plain path {worst}, rgba and the graphic's alpha checked")

    run_path(path, {"v210_unpack": 1, "rotate": 1, "planar422_unpack": 2, "planar420_unpack": 2,
                    "rgb8_unpack": 1, "packed_composite": 1, "warp": 1, "v210_pack": 1}, STRAGGLER_FRAMES, keyed_path,
             modes={("rgba", "rgba", "coverage"): 1}, tail={"combine": 1, "_top_alpha_fixup": 0})
    kanimate(0.5)
    timing[path] = time_frame(torch, card, path, kprog, kplain, kparams)

    # -------- phase 7e2: a warm channel-tick as one CUDA graph replay
    phase_graph(torch, dev, card, np.random.default_rng(SEED + 21), run_path, timing)

    # -------- phase 7f: the runtime (port Channels through render_frame and Channel.run)
    phase_runtime(torch, dev, card, run_path, load, timing)

    # -------- phase 7g: the server (server.py) on the default config, AMCP over TCP
    phase_server(torch, dev, card, run_path, timing)

    # -------- phase 7h: the last producers and consumers (SDI, file media, MJPEG ingest, ffmpeg)
    phase_media_io(torch, dev, card, run_path, timing)

    # -------- phase 7i: row-sharded (sp) channels, the band forms, the dry runs (A10)
    sp_bands = phase_sp(torch, dev, card, run_path, timing)

    # -------- phase 8: timing (records, not targets)
    period_ms, plain_period_ms = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        if order == "plain":
            plain_period_ms.append(time_ms(torch, plain_load, batches=3, calls=2, warmup=1))
        else:
            period_ms.append(time_ms(torch, load, batches=7, calls=5))
    kp, pp = statistics.median(period_ms), statistics.median(plain_period_ms)
    print(f"interlaced frame period ms ({N_CHANNELS} x 1080i50) on {card}: kernel path {kp:.4f} "
          f"(runs {period_ms}), {100 * kp / PERIOD_MS:.1f} % of the {PERIOD_MS:.0f} ms period; "
          f"plain path {pp:.4f} (runs {plain_period_ms})")
    print(f"interlaced frame period latency ms on {card} (synchronised per period): kernel path "
          f"{latency_ms(torch, load, reps=10):.4f}")

    rgb = 3 * 4 * H * W  # one (3, H, W) float32 frame
    rgba = 4 * 4 * H * W
    words_bytes = H * pitch_bytes(W) * 1.0
    y422_bytes = H * 2 * y422_pitch(W)
    px = H * W

    def warp_bytes(args) -> float:
        src, mat, src_b = args[0], args[1], args[2]
        c = src.shape[0]
        return 2 * c * 4 * warp_source_texels(torch, mat, H, W) + c * 4 * px + 36 + 4

    def warp_ops(c: int, n_src: int, pixels: int = px, n_mat: int = 1, per_px: int = OPS_WARP_PX) -> float:
        """Per output pixel: the taps of each matrix, the samples of each
        source and channel, the pair's mix (or wipe blend)."""
        return pixels * (n_mat * per_px + c * (n_src * OPS_WARP_SAMPLE + (OPS_MIX if n_src == 2 else 0)))

    def composite_bytes_ops(cfg, mats, w: int, h: int, kind: str, emit: str = "packed",
                            alpha: str = "coverage") -> tuple[float, float]:
        """Least bytes and operations of a packed composite: each source
        texel (or v210 group) the taps reach read once and decoded once,
        the warps (all four channels of an rgba source), the alphas and
        the 'over' per pixel, then the encode and the words out, and/or
        the (4, H, W) frame with its coverage or top alpha."""
        pixels = w * h
        channels = 4 if kind == "rgba" else 3
        nbytes = 36 * len(cfg) + 4 * sum(n == 2 for n in cfg)
        ops = 0.0
        if emit != "rgba":
            nbytes += h * pitch_bytes(w)
            ops += pixels * OPS_ENCODE_PX
        if emit != "packed":
            nbytes += 16 * pixels
            ops += pixels * OPS_COVER * (len(cfg) - 1) if alpha == "coverage" else 0
        for i, (n, m) in enumerate(zip(cfg, mats)):
            if kind == "packed":
                nbytes += n * 16 * warp_source_groups(torch, m, h, w)
                ops += n * warp_source_texels(torch, m, h, w) * OPS_DECODE_PX
            else:
                nbytes += n * 4 * channels * warp_source_texels(torch, m, h, w)
            ops += warp_ops(channels, n, pixels)
            ops += pixels * ((OPS_K if kind == "rgba" else OPS_ALPHA) + (3 * OPS_OVER if i else 0))
        return nbytes, ops

    def run_args(spec, params, emit: str, alpha: str, start: int = 0, end: int | None = None):
        """The packed composite call of a driven path's run [start, end)
        (default: the whole stack), its rgb3 / rgba sources made by the
        kernels as the path makes them."""
        from phaneron_tpu_torch.graph.pipeline import (
            _KERNELS,
            _Run,
            _composite_kind,
            _packed_composite_args,
            _sources,
        )

        end = len(spec.layers) if end is None else end
        kind = _composite_kind(spec.layers[start], params["layers"][start])
        srcs = {} if kind == "packed" else _sources(spec, params, _KERNELS)
        args = _packed_composite_args(spec, params, srcs, _Run(start, end, emit, kind, alpha))
        return args, dict(src_kind=kind, size=(spec.width, spec.height), emit=emit, alpha=alpha)

    # name -> (kernel call, plain call, bytes, ops, shape) at a main path's shapes
    call = lambda fn, args, kw=None: (lambda: fn(*args, **(kw or {})))
    r_unpack = rec["v210_unpack"]["rgb3_args"]
    r_pack = (rec["yadif_pair"]["args"][1],)
    rgb3_cfg, rgb3_mats = rec["packed_composite"]["args"][1], rec["packed_composite"]["args"][2]
    c_bytes, c_ops = composite_bytes_ops(rgb3_cfg, rgb3_mats, W, H, "rgb3")
    (uhd_args, uhd_kw) = prog_args[(UHD_W, UHD_H)]
    u_bytes, u_ops = composite_bytes_ops(uhd_args[1], uhd_args[2], UHD_W, UHD_H, "packed")
    (hd_args, hd_kw) = prog_args[(W, H)]
    h_bytes, h_ops = composite_bytes_ops(hd_args[1], hd_args[2], W, H, "packed")
    f_args = playout_args[(W, H, True)]
    fu_args = playout_args[(UHD_W, UHD_H, True)]
    pw_mat = entry_warp_args[1]
    pw_bytes = 2 * 16 * warp_source_groups(torch, pw_mat, H, W) + rgba + 36 + 4
    pw_ops = 2 * warp_source_texels(torch, pw_mat, H, W) * OPS_DECODE_PX + warp_ops(4, 2)
    # the one_rotation frame's top layer at UHD, as the path unpacks it
    # the media channel at 1080p: its sources and its rgba frame
    m_params, m_rgba = media_args[(W, H)]
    m_lps = m_params["layers"]
    p10_args = (m_lps[0]["src"], W, H, "709", "709", "yuv422p10le")
    y420_args = (m_lps[1]["src"], W, H, "709", "709", "yuv420p")
    nv12_args = (m_lps[1]["src_b"], W, H, "709", "709", "nv12")
    rgb8_args = (m_lps[2]["src"], W, H, "709", "709", "rgba8")
    uhd_rgb8_args = (media_args[(UHD_W, UHD_H)][0]["layers"][2]["src"], UHD_W, UHD_H, "709", "709", "rgba8")
    planar_px = H * y422_pitch(W)  # samples of a luma plane, pitch included
    top = straggler_args[f"one_rotation_{UHD_W}x{UHD_H}"][1]["layers"][3]
    rot_args = (K.v210_unpack(top["src"], UHD_W, UHD_H)[0], top["matrix"])
    rot_lib = affine_grid_args(torch, [rot_args[0]], rot_args[1])
    shapes = {
        "v210_unpack": (call(K.v210_unpack, r_unpack), call(K.v210_unpack_plain, r_unpack),
                        words_bytes + rgb, OPS_DECODE_PX * px, "1 source, 3 channels (interlaced path)"),
        "v210_pack": (call(K.v210_pack, r_pack), call(K.v210_pack_plain, r_pack), rgb + words_bytes,
                      OPS_ENCODE_PX * px, "(3, H, W) in"),
        "planar422_unpack": (call(K.planar422_unpack, rec["planar422_unpack"]["args"]),
                             call(K.planar422_unpack_plain, rec["planar422_unpack"]["args"]),
                             y422_bytes + rgba, OPS_DECODE_PX * px,
                             "yuv422p8, the fill_buf ramp, 1920x1080 (entry path)"),
        "warp": (call(warp_mod.warp, rec["warp"]["rgb3_args"]), call(warp_mod.warp_plain, rec["warp"]["rgb3_args"]),
                 warp_bytes(rec["warp"]["rgb3_args"]), warp_ops(3, 2), "3-channel dissolve pair"),
        "yadif_ring": (call(Y.yadif_ring, rec["yadif_ring"]["args"]), call(Y.yadif_ring_plain, rec["yadif_ring"]["args"]),
                       3.5 * rgb, OPS_YADIF_SAMPLE * 3 * px / 2, "3 channels, one parity"),
        "yadif_pair": (call(Y.yadif_pair, rec["yadif_pair"]["args"]), call(Y.yadif_pair_plain, rec["yadif_pair"]["args"]),
                       5 * rgb, OPS_YADIF_SAMPLE * 3 * px, "3 channels, both parities"),
        "packed_composite": (call(PW.packed_composite, uhd_args, uhd_kw),
                             call(PW.packed_composite_plain, uhd_args, uhd_kw), u_bytes, u_ops,
                             "v210 words, 4 dissolve layers, 8 sources, 3840x2160 (progressive path)"),
        "fused_v210": (call(K.fused_v210, f_args), call(K.fused_v210_plain, f_args), 3 * words_bytes + 4,
                       px * (2 * OPS_DECODE_PX + 3 * OPS_MIX + OPS_ENCODE_PX),
                       "v210 dissolve, 1920x1080 (playout path)"),
        "combine_pack": (call(K.combine_pack, (entry_pack_layers,)), call(K.combine_pack_plain, (entry_pack_layers,)),
                         rgb + rgba + words_bytes, px * (1 + 3 * OPS_OVER + OPS_ENCODE_PX),
                         "2 RGBA layers, 1920x1080 (entry path)"),
        "packed_warp": (call(PW.packed_warp, entry_warp_args), call(PW.packed_warp_plain, entry_warp_args),
                        pw_bytes, pw_ops, "v210 dissolve pair, shared matrix, 1920x1080 (entry path)"),
        "rotate": (call(R.rotate, rot_args), call(R.rotate_plain, rot_args),
                   16 * affine_source_texels(torch, rot_args[1], UHD_H, UHD_W) + 16 * UHD_W * UHD_H + 36,
                   warp_ops(4, 1, UHD_W * UHD_H, per_px=OPS_AFFINE_PX),
                   "RGBA cut at 100 degrees, 3840x2160 (one_rotation path)"),
        "planar422_pack": (call(K.planar422_pack, (m_rgba, "yuv422p10le")),
                           call(K.planar422_pack_plain, (m_rgba, "yuv422p10le")),
                           rgb + 2 * 2 * planar_px, OPS_ENCODE_PX * px,
                           "yuv422p10le from the media channel's (4, H, W) frame, 1920x1080 (media path)"),
        "planar420_unpack": (call(K.planar420_unpack, y420_args), call(K.planar420_unpack_plain, y420_args),
                             1.5 * planar_px + rgba, OPS_DECODE_PX * px,
                             "yuv420p, the fill_buf ramp, 1920x1080 (media path)"),
        "planar420_pack": (call(K.planar420_pack, (m_rgba, "nv12")), call(K.planar420_pack_plain, (m_rgba, "nv12")),
                           rgb + 1.5 * planar_px, OPS_ENCODE_420_PX * px,
                           "nv12 from the media channel's (4, H, W) frame, 1920x1080 (file consumer)"),
        "rgb8_unpack": (call(K.rgb8_unpack, rgb8_args), call(K.rgb8_unpack_plain, rgb8_args),
                        4 * px + rgba, OPS_RGB8_DECODE_PX * px,
                        "rgba8, the keyed lower third, 1920x1080 (media path)"),
    }
    slow_plain = ("yadif_ring", "yadif_pair", "packed_composite", "packed_warp", "rotate")
    none = "none (no single PyTorch call computes a planar or RGB decode, or an encode)"
    meta = {
        "v210_unpack": ("phaneron_tpu_torch/csrc/v210_unpack.cu", "phaneron_tpu/ops/pallas_kernels.py:341"),
        "v210_pack": ("phaneron_tpu_torch/csrc/combine_pack.cu", "phaneron_tpu/ops/pallas_kernels.py:546"),
        "planar422_unpack": ("phaneron_tpu_torch/csrc/planar422_unpack.cu", "phaneron_tpu/ops/pallas_kernels.py:892"),
        "warp": ("phaneron_tpu_torch/csrc/warp.cu", "phaneron_tpu/ops/pallas_warp.py:532"),
        "yadif_ring": ("phaneron_tpu_torch/csrc/yadif.cu", "phaneron_tpu/ops/pallas_yadif.py:500"),
        "yadif_pair": ("phaneron_tpu_torch/csrc/yadif.cu", "phaneron_tpu/ops/pallas_yadif.py:756"),
        "packed_composite": ("phaneron_tpu_torch/csrc/packed_composite.cu",
                             "phaneron_tpu/ops/pallas_packed_warp.py:1216"),
        "fused_v210": ("phaneron_tpu_torch/csrc/fused_v210.cu", "phaneron_tpu/ops/pallas_kernels.py:1399"),
        "combine_pack": ("phaneron_tpu_torch/csrc/combine_pack.cu", "phaneron_tpu/ops/pallas_kernels.py:733"),
        "packed_warp": ("phaneron_tpu_torch/csrc/packed_warp.cu", "phaneron_tpu/ops/pallas_packed_warp.py:416"),
        "rotate": ("phaneron_tpu_torch/csrc/rotate.cu", "phaneron_tpu/ops/pallas_rotate.py:326"),
        "planar422_pack": ("phaneron_tpu_torch/csrc/planar422_pack.cu", "phaneron_tpu/ops/pallas_kernels.py:970"),
        "planar420_unpack": ("phaneron_tpu_torch/csrc/planar420_unpack.cu",
                             "phaneron_tpu/ops/pallas_kernels.py:1206"),
        "planar420_pack": ("phaneron_tpu_torch/csrc/planar420_pack.cu", "phaneron_tpu/ops/pallas_kernels.py:1296"),
        "rgb8_unpack": ("phaneron_tpu_torch/csrc/rgb8_unpack.cu", "none (XLA in the JAX package: phaneron_tpu/ops/io.py "
                        "to_rgba)"),
    }
    grid_sample = lambda args: (lambda: torch.nn.functional.grid_sample(
        *args, mode="bilinear", padding_mode="zeros", align_corners=False))
    # packed_composite's whole-stack and rgba modes, a record each: name ->
    # ((src_kind, emit, alpha; None: any alpha), the TPU kernel it stands
    # for, the (args, kw) of a main path's launch, its shape)
    mb = multibox_args[(W, H, "v210")]
    mb_shape = "4 layers (5 sources) at the multibox 1920x1080 path's shapes"
    mode_records = {
        "packed_composite_rgba_both_top": (("rgba", "both", "top"), B16, run_args(*mb, "both", "top"),
                                           f"rgba kind, emit both, top alpha, {mb_shape} (multibox v210 path)"),
        "packed_composite_rgba_rgba_top": (("rgba", "rgba", "top"), B16, run_args(*mb, "rgba", "top"),
                                           f"rgba kind, emit rgba, top alpha, {mb_shape} (multibox "
                                           "yuv422p10le path)"),
        "packed_composite_rgba_rgba_coverage": (
            ("rgba", "rgba", "coverage"), B16, run_args(kspec, kparams, "rgba", "coverage", 1, 3),
            "rgba kind, emit rgba, coverage alpha, 2 dissolve layers (4 sources) at 1920x1080 (keyed_straggler "
            "path)"),
        "packed_composite_rgba_packed": (("rgba", "packed", None), B16, run_args(*mb, "packed", "top"),
                                         f"rgba kind, emit packed, {mb_shape} (no main path)"),
        "packed_composite_packed_rgba_top": (("packed", "rgba", "top"), B15, run_args(pyspec, pyparams, "rgba", "top"),
                                             "v210 words, emit rgba, top alpha, 4 dissolve layers, 1920x1080 "
                                             "(progressive_yuv422p10le path)"),
        "packed_composite_packed_both_top": (
            ("packed", "both", "top"), B15, run_args(*straggler_args[f"progressive_emit_rgba_{W}x{H}"], "both", "top"),
            "v210 words, emit both, top alpha, 4 dissolve layers, 1920x1080 (progressive emit_rgba path)"),
    }
    matches = lambda mode, pat: mode[:2] == pat[:2] and pat[2] in (None, mode[2])
    by_mode = lambda pat: {path: sum(n for m, n in ml.items() if matches(m, pat)) for path, ml in mode_launches.items()}
    # the packed composite's own record keeps B7's modes: its launches less
    # those of the modes with a record of their own
    launches["packed_composite"] = {
        path: sum(n for m, n in ml.items() if not any(matches(m, v[0]) for v in mode_records.values()))
        for path, ml in mode_launches.items()}
    records = []
    for name, (kernel_fn, plain_fn, nbytes, ops, shape) in shapes.items():
        kernel_ms, plain_ms = best_of_two(
            torch, kernel_fn, plain_fn, dict(batches=5, calls=4) if name in slow_plain else None,
        )
        bound_ms, bound_by = bound(nbytes, ops)
        library_ms = None
        if name == "warp":
            library_ms = device_ms(torch, grid_sample(rec["warp"]["library_args"]))
        elif name == "rotate":
            library_ms = device_ms(torch, grid_sample(rot_lib))
        print(f"{name} ({shape}) on {card}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GOP; "
              f"{bound_ms / kernel_ms:.1%} of it reached)"
              + (f", grid_sample {library_ms:.4f} ms (the same sources, no mix)" if library_ms else "")
              + (f", library {none}" if name.startswith(("planar", "rgb8")) else ""))
        source, replaces = meta[name]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": rec[name]["max_abs_err"], "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, "shape": shape,
        })
    # other shapes and modes of the same kernels, printed beside the records:
    # label -> (kernel call, plain call, bytes, ops[, (input, grid) of the
    # grid_sample computing the same warps, without the mix])
    g4_args = grid_sample_args(torch, [rec["warp"]["args"][0], rec["warp"]["args"][2]], rec["warp"]["args"][1])
    (wa, wm, wb), wkw = rec["warp"]["wipe_args"]
    da, dm, db, dmix, dmb = rec["warp"]["distinct_args"]
    ra, rm, rb, rmix, rmb = rec["rotate"]["pair_args"]
    (rwa, rwm, rwb), rwkw = rec["rotate"]["wipe_args"]
    both = lambda a, b: tuple(torch.cat(x) for x in zip(a, b))
    o_rgba_args, o_rgba_kw = run_args(*straggler_args[f"one_rotation_{UHD_W}x{UHD_H}"], "rgba", "coverage", 0, 3)
    o_rgba = composite_bytes_ops(o_rgba_args[1], o_rgba_args[2], UHD_W, UHD_H, "packed", emit="rgba")
    r3_args, r3_kw = rec["packed_composite"]["rgb3_emit_args"]
    r3 = composite_bytes_ops(r3_args[1], r3_args[2], W, H, "rgb3", emit="rgba")
    # coherent content beside the random words: the fill_buf ramp rolled
    # by whole groups, one roll per source (the gamma'->linear gathers of
    # neighbouring pixels then hit neighbouring table cells, as on video)
    ramps = lambda w, h, n: [to_tensor(np.roll(v210fmt.fill_buf(w, h)[0], 4 * 11 * (k + 1), axis=1), dev)
                             for k in range(n)]
    k1_ramp, k1_ramps = ([fill], W, H, "709", "709", 3), (ramps(W, H, 2), W, H)
    uhd_ramp_args, hd_ramp_args = (ramps(UHD_W, UHD_H, 8), *uhd_args[1:]), (ramps(W, H, 8), *hd_args[1:])
    fu_ramps = ramps(UHD_W, UHD_H, 2)
    fu_ramp_args = (fu_ramps[0], UHD_W, UHD_H, fu_ramps[1], fu_args[4])
    rot0_args = (rot_args[0], to_tensor(rotation_matrix(UHD_W, UHD_H, 0), dev))
    # K4 at the media channel's picture in picture (its two sources as the
    # path unpacks them) and at the UHD wipe frame's top layer; B6 under
    # two matrices (the entry pair's sources)
    pip_args = (K.planar420_unpack(*y420_args), m_lps[1]["matrix"], K.planar420_unpack(*nv12_args),
                m_lps[1]["mix"])
    w_top = straggler_args[f"wipe_{UHD_W}x{UHD_H}"][1]["layers"][3]
    uwipe_srcs = K.v210_unpack([w_top["src"][0], w_top["src_b"][0], w_top["mask"][0]], UHD_W, UHD_H)
    uwipe_args, uwipe_kw = (uwipe_srcs[0], w_top["matrix"], uwipe_srcs[1]), dict(mask=uwipe_srcs[2][0].contiguous())
    pw_distinct = (*entry_warp_args, to_tensor(transform_matrix(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05), dev))
    other = {
        "v210_unpack (2 sources, 4 channels)": (call(K.v210_unpack, rec["v210_unpack"]["args"]),
                                                call(K.v210_unpack_plain, rec["v210_unpack"]["args"]),
                                                2 * (words_bytes + rgba), 2 * OPS_DECODE_PX * px),
        "v210_unpack (1 source, 3 channels, the fill_buf ramp)": (
            call(K.v210_unpack, k1_ramp), call(K.v210_unpack_plain, k1_ramp), words_bytes + rgb, OPS_DECODE_PX * px),
        "v210_unpack (2 sources, 4 channels, rolled fill_buf ramps)": (
            call(K.v210_unpack, k1_ramps), call(K.v210_unpack_plain, k1_ramps), 2 * (words_bytes + rgba),
            2 * OPS_DECODE_PX * px),
        "v210_pack ((4, H, W) in)": (call(K.v210_pack, rec["v210_pack"]["args"]),
                                     call(K.v210_pack_plain, rec["v210_pack"]["args"]),
                                     rgb + words_bytes, OPS_ENCODE_PX * px),
        "warp (4-channel dissolve pair)": (call(warp_mod.warp, rec["warp"]["args"]),
                                           call(warp_mod.warp_plain, rec["warp"]["args"]),
                                           warp_bytes(rec["warp"]["args"]), warp_ops(4, 2), g4_args),
        "warp (4-channel wipe pair, one matrix, 1920x1080, wipe path)": (
            call(warp_mod.warp, (wa, wm, wb), wkw), call(warp_mod.warp_plain, (wa, wm, wb), wkw),
            warp_bytes((wa, wm, wb)) + 4 * px, warp_ops(4, 2), grid_sample_args(torch, [wa, wb], wm)),
        "warp (4-channel dissolve pair, two matrices, 1920x1080)": (
            call(warp_mod.warp, rec["warp"]["distinct_args"]), call(warp_mod.warp_plain, rec["warp"]["distinct_args"]),
            16 * (warp_source_texels(torch, dm, H, W) + warp_source_texels(torch, dmb, H, W)) + rgba + 72 + 4,
            warp_ops(4, 2, n_mat=2), both(grid_sample_args(torch, [da], dm), grid_sample_args(torch, [db], dmb))),
        "warp (4-channel picture in picture, scale 0.5, dissolve, 1920x1080, media path)": (
            call(warp_mod.warp, pip_args), call(warp_mod.warp_plain, pip_args),
            2 * 16 * warp_source_texels(torch, pip_args[1], H, W) + rgba + 36 + 4, warp_ops(4, 2),
            grid_sample_args(torch, [pip_args[0], pip_args[2]], pip_args[1])),
        "warp (4-channel wipe pair, one matrix, 3840x2160, wipe path)": (
            call(warp_mod.warp, uwipe_args, uwipe_kw), call(warp_mod.warp_plain, uwipe_args, uwipe_kw),
            2 * 16 * warp_source_texels(torch, uwipe_args[1], UHD_H, UHD_W) + 20 * UHD_W * UHD_H + 36,
            warp_ops(4, 2, UHD_W * UHD_H), grid_sample_args(torch, [uwipe_args[0], uwipe_args[2]], uwipe_args[1])),
        "packed_warp (v210 dissolve pair, two matrices, 1920x1080)": (
            call(PW.packed_warp, pw_distinct), call(PW.packed_warp_plain, pw_distinct),
            16 * (warp_source_groups(torch, pw_mat, H, W) + warp_source_groups(torch, pw_distinct[6], H, W)) + rgba
            + 72 + 4, OPS_DECODE_PX * (warp_source_texels(torch, pw_mat, H, W)
                                       + warp_source_texels(torch, pw_distinct[6], H, W)) + warp_ops(4, 2, n_mat=2)),
        "rotate (4-channel dissolve pair, two matrices, 100 and 95 degrees, 1920x1080)": (
            call(R.rotate, rec["rotate"]["pair_args"]), call(R.rotate_plain, rec["rotate"]["pair_args"]),
            16 * (affine_source_texels(torch, rm, H, W) + affine_source_texels(torch, rmb, H, W)) + rgba + 72 + 4,
            warp_ops(4, 2, n_mat=2, per_px=OPS_AFFINE_PX),
            both(affine_grid_args(torch, [ra], rm), affine_grid_args(torch, [rb], rmb))),
        "rotate (4-channel wipe pair, one matrix, 100 degrees, 1920x1080)": (
            call(R.rotate, (rwa, rwm, rwb), rwkw), call(R.rotate_plain, (rwa, rwm, rwb), rwkw),
            2 * 16 * affine_source_texels(torch, rwm, H, W) + rgba + 4 * px + 36,
            warp_ops(4, 2, per_px=OPS_AFFINE_PX), affine_grid_args(torch, [rwa, rwb], rwm)),
        "packed_composite (v210 words, emit rgba, 3 dissolve layers, 3840x2160, one_rotation path)": (
            call(PW.packed_composite, o_rgba_args, o_rgba_kw), call(PW.packed_composite_plain, o_rgba_args, o_rgba_kw),
            *o_rgba),
        "packed_composite (rgb3, emit rgba, 3 dissolve layers, 1920x1080)": (
            call(PW.packed_composite, r3_args, dict(r3_kw, emit="rgba")),
            call(PW.packed_composite_plain, r3_args, dict(r3_kw, emit="rgba")), *r3),
        "packed_composite (rgb3, 4 dissolve layers, 1920x1080, interlaced path)": (
            call(PW.packed_composite, rec["packed_composite"]["args"]),
            call(PW.packed_composite_plain, rec["packed_composite"]["args"]), c_bytes, c_ops),
        "packed_composite (v210 words, 4 dissolve layers, 1920x1080, progressive path)": (
            call(PW.packed_composite, hd_args, hd_kw), call(PW.packed_composite_plain, hd_args, hd_kw),
            h_bytes, h_ops),
        "packed_composite (v210 words, 4 dissolve layers, 3840x2160, rolled fill_buf ramps)": (
            call(PW.packed_composite, uhd_ramp_args, uhd_kw), call(PW.packed_composite_plain, uhd_ramp_args, uhd_kw),
            u_bytes, u_ops),
        "packed_composite (v210 words, 4 dissolve layers, 1920x1080, rolled fill_buf ramps)": (
            call(PW.packed_composite, hd_ramp_args, hd_kw), call(PW.packed_composite_plain, hd_ramp_args, hd_kw),
            h_bytes, h_ops),
        "fused_v210 (v210 dissolve, 3840x2160, playout path)": (
            call(K.fused_v210, fu_args), call(K.fused_v210_plain, fu_args),
            3 * UHD_H * pitch_bytes(UHD_W) + 4,
            UHD_W * UHD_H * (2 * OPS_DECODE_PX + 3 * OPS_MIX + OPS_ENCODE_PX)),
        "fused_v210 (v210 dissolve, 3840x2160, two rolled fill_buf ramps)": (
            call(K.fused_v210, fu_ramp_args), call(K.fused_v210_plain, fu_ramp_args),
            3 * UHD_H * pitch_bytes(UHD_W) + 4,
            UHD_W * UHD_H * (2 * OPS_DECODE_PX + 3 * OPS_MIX + OPS_ENCODE_PX)),
        "rotate (RGBA cut at 0 degrees, 3840x2160)": (
            call(R.rotate, rot0_args), call(R.rotate_plain, rot0_args),
            16 * affine_source_texels(torch, rot0_args[1], UHD_H, UHD_W) + 16 * UHD_W * UHD_H + 36,
            warp_ops(4, 1, UHD_W * UHD_H, per_px=OPS_AFFINE_PX), affine_grid_args(torch, [rot0_args[0]], rot0_args[1])),
        "planar422_unpack (yuv422p10le, 4 channels, 1920x1080, media path)": (
            call(K.planar422_unpack, p10_args), call(K.planar422_unpack_plain, p10_args),
            2 * 2 * planar_px + rgba, OPS_DECODE_PX * px),
        "planar420_unpack (nv12, 1920x1080, media path)": (
            call(K.planar420_unpack, nv12_args), call(K.planar420_unpack_plain, nv12_args),
            1.5 * planar_px + rgba, OPS_DECODE_PX * px),
        "rgb8_unpack (rgba8, the keyed lower third, 3840x2160, media path)": (
            call(K.rgb8_unpack, uhd_rgb8_args), call(K.rgb8_unpack_plain, uhd_rgb8_args),
            20.0 * UHD_W * UHD_H, OPS_RGB8_DECODE_PX * UHD_W * UHD_H),
    }
    other.update(timed_shapes(torch, dev))
    modes = {}  # kernel name -> its other shapes and modes, for the kernels line
    for label, (kernel_fn, plain_fn, nbytes, ops, *library) in other.items():
        kernel_ms, plain_ms = best_of_two(torch, kernel_fn, plain_fn, dict(batches=3, calls=2, warmup=1))
        bound_ms, bound_by = bound(nbytes, ops)
        library_ms = device_ms(torch, grid_sample(library[0])) if library else None
        extra = f", grid_sample {library_ms:.4f} ms (the same sources, no mix)" if library else ""
        if label.startswith(("planar", "rgb8")):
            extra = f", library {none}"
        print(f"{label} on {card}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GOP){extra}")
        modes.setdefault(label.split(" ")[0], []).append(dict(
            shape=label, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
    errs = rec["composite_modes"]
    for name, (pat, replaces, (args, kw), shape) in mode_records.items():
        kernel_ms, plain_ms = best_of_two(torch, call(PW.packed_composite, args, kw),
                                          call(PW.packed_composite_plain, args, kw), dict(batches=5, calls=4))
        nbytes, ops = composite_bytes_ops(args[1], args[2], W, H, kw["src_kind"], kw["emit"], kw["alpha"])
        bound_ms, bound_by = bound(nbytes, ops)
        by_path = by_mode(pat)
        print(f"{name} ({shape}) on {card}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GOP), library none, "
              f"launches {sum(by_path.values())}")
        records.append({
            "name": name, "route": "cuda", "source": "phaneron_tpu_torch/csrc/packed_composite.cu",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(e for m, e in errs.items() if matches(m, pat)), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "shape": shape,
        })
    # K5's tiles by branch at every timed shape of the packed and rgb3
    # kinds: a main path's shape must bring each source window in once (no
    # direct tile)
    k5_shapes = {
        "interlaced tick 1920x1080 (rgb3)": (rec["packed_composite"]["args"], {}),
        "rgb3 3 dissolve layers 1920x1080 (emit rgba)": (r3_args, r3_kw),
        "progressive 3840x2160 (the record)": (uhd_args, uhd_kw),
        "progressive 3840x2160, ramps": (uhd_ramp_args, uhd_kw),
        "progressive 1920x1080": (hd_args, hd_kw),
        "progressive 1920x1080, ramps": (hd_ramp_args, hd_kw),
        "one_rotation run 3840x2160 (emit rgba, coverage)": (o_rgba_args, o_rgba_kw),
        "progressive_yuv422p10le 1920x1080 (emit rgba, top)": mode_records["packed_composite_packed_rgba_top"][2],
        "progressive emit_rgba 1920x1080 (emit both, top)": mode_records["packed_composite_packed_both_top"][2],
    }
    window_direct = {label: k5_branches(torch, dev, *ak) for label, ak in k5_shapes.items()}
    print(f"packed_composite window/direct (tile, source) pairs per timed shape: {window_direct}")
    for label, (_, direct) in window_direct.items():
        check(direct == 0, f"packed_composite at {label}: {direct} (tile, source) pairs off the window branch")
    # rotate's tiles by branch at every timed shape: none may leave the window
    rotate_shapes = {
        "RGBA cut at 100 degrees, 3840x2160 (the record)": (rot_args, {}),
        "RGBA cut at 0 degrees, 3840x2160": (rot0_args, {}),
        "dissolve pair, two matrices, 1920x1080": (rec["rotate"]["pair_args"], {}),
        "wipe pair, one matrix, 1920x1080": rec["rotate"]["wipe_args"],
    }
    rotate_window_direct = {label: rotate_branches(torch, dev, *ak) for label, ak in rotate_shapes.items()}
    print(f"rotate window/direct (tile, source) pairs per timed shape: {rotate_window_direct}")
    for label, (_, direct) in rotate_window_direct.items():
        check(direct == 0, f"rotate at {label}: {direct} (tile, source) pairs off the window branch")
    # B6's tiles by branch at every timed shape: none may leave the window,
    # and each count must equal the plain mirror's
    pw_shapes = {"entry pair 1920x1080 (the record)": entry_warp_args,
                 "dissolve pair, two matrices, 1920x1080": pw_distinct}
    pw_window_direct = {}
    for label, args in pw_shapes.items():
        got = packed_warp_branches(torch, dev, args)
        mats = [args[1], args[6] if len(args) > 6 else args[1]]
        expect = [sum(x) for x in zip(*(PW.warp_window_counts(m, W, H) for m in mats))]
        check(got == expect, f"packed_warp at {label}: window/direct {got}, warp_window_counts gives {expect}")
        pw_window_direct[label] = got
    print(f"packed_warp window/direct (tile, source) pairs per timed shape: {pw_window_direct}")
    for label, (_, direct) in pw_window_direct.items():
        check(direct == 0, f"packed_warp at {label}: {direct} (tile, source) pairs off the window branch")
    for r in records:
        if r["name"] == "packed_composite":
            r["window_direct"] = window_direct
        if r["name"] == "rotate":
            r["window_direct"] = rotate_window_direct
        if r["name"] == "packed_warp":
            r["window_direct"] = pw_window_direct
        r["modes"] = modes.get(r["name"], [])
        band = next((k for k in BAND_FORMS if r["name"] == k or r["name"].startswith(k + "_")), None)
        if band is not None:  # the kernels with band forms (row-sharded channels)
            r["band_form"] = sp_bands[band]
    print(json.dumps({"frames": timing}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
