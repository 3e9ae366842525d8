#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Exits 1 unless CUDA is available; prints the card's name and power
   limit (nvidia-smi) and the torch / CUDA versions.
2. Builds the kernels from phaneron_tpu_torch/csrc (nvcc, sm_90a) and
   prints the build seconds and ptxas's register counts.
3. Compares each kernel with its plain PyTorch version on the card, at
   the 1080p shapes of the main path, on seeded random words over the
   full 10-bit code range and on the formats' fill_buf ramps:
   v210_unpack and planar422_unpack <= 4e-5, v210_pack <= 1 code on
   random inputs and pack(unpack(fill_buf)) == fill_buf bit-exact (also
   at widths with a pitch pad), warp <= 5e-5.
4. Drives the main path, make_channel_program(spec)(params), for the
   entry() structure (v210 dissolve with an axis-aligned DVE under a
   yuv422p8 layer) at 1920x1080 over 100 frames, with the mix ramping
   0 -> 1 and the DVE scale animating 0.90 -> 1.0.  Every frame's codes
   must be <= 1 from the plain path on the card, and each kernel's launch
   counter must show it on every frame.
5. Times, with CUDA events after warm-up, the median ms per frame of the
   kernel path and the plain path (batches of back-to-back frames), the
   frame latency with the card idle before and after, and each kernel
   against its plain version.  The v210_pack record's max_abs_err is its
   largest code delta.

Prints one JSON line of per-kernel records, then, as the last line,
{"ok": true, "device": {...}}.  Any failed phase raises and exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H = 1920, 1080
FRAMES = 100
SEED = 1234

TOL_UNPACK = 4e-5  # one LUT step (powf vs the host pow)
TOL_WARP = 5e-5
TOL_CODES = 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def random_words(rng, width: int, height: int) -> np.ndarray:
    from phaneron_tpu_torch.ops.formats import v210

    return rng.integers(0, 2**32, size=(height, v210.pitch_bytes(width) // 4), dtype=np.uint32)


def code_delta(torch, a, b, width: int, height: int) -> int:
    from phaneron_tpu_torch.ops.formats import v210

    ca = v210.unpack_codes([a], width, height)
    cb = v210.unpack_codes([b], width, height)
    return max(int((x - y).abs().max()) for x, y in zip(ca, cb))


def phase_kernels(torch, dev, rng) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from phaneron_tpu_torch.graph.pipeline import make_channel_program
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import warp as warp_mod
    from phaneron_tpu_torch.ops.formats.v210 import pitch_bytes

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -------- phase 2: build
    _build.library()
    info = _build.build_info()
    print(f"build: {'compiled' if info.compiled else 'loaded'} {info.path.name} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -------- phase 3: kernels against their plain versions
    rng = np.random.default_rng(SEED)
    rec = phase_kernels(torch, dev, rng)

    # -------- phase 4: the main path
    spec, params = entry_spec_params(rng, dev)
    program = make_channel_program(spec)
    plain_program = make_channel_program(spec, plain=True)
    wrappers = {
        "v210_unpack": K.v210_unpack, "warp": warp_mod.warp,
        "planar422_unpack": K.planar422_unpack, "v210_pack": K.v210_pack,
    }
    v210_words = pitch_bytes(W) // 4
    for fn in wrappers.values():
        fn.launches = 0
    worst = 0
    t0 = time.perf_counter()
    for f in range(FRAMES):
        before = {k: fn.launches for k, fn in wrappers.items()}
        animate(torch, params, dev, f / (FRAMES - 1))
        out = program(params)
        after = {k: fn.launches for k, fn in wrappers.items()}
        missing = [k for k in wrappers if after[k] == before[k]]
        check(not missing, f"frame {f}: kernels not launched: {missing}")
        ref = plain_program(params)
        check(len(out) == 1 and tuple(out[0].shape) == (H, v210_words), f"frame {f}: output shape")
        check(out[0].dtype == torch.int32, f"frame {f}: output dtype {out[0].dtype}")
        d = code_delta(torch, out[0], ref[0], W, H)
        worst = max(worst, d)
        check(d <= TOL_CODES, f"frame {f}: kernel path {d} codes from the plain path")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"main path: {FRAMES} frames {W}x{H} in {time.perf_counter() - t0:.2f} s, "
          f"max code delta vs plain path {worst}, launches {launches}")
    for k, n in launches.items():
        check(n >= FRAMES, f"{k} launched {n} times over {FRAMES} frames")

    # -------- phase 5: timing (records, not targets)
    animate(torch, params, dev, 0.5)
    frame_ms, plain_frame_ms = [], []
    for order in ("plain", "kernel", "kernel", "plain"):
        fn = plain_program if order == "plain" else program
        (plain_frame_ms if order == "plain" else frame_ms).append(time_ms(torch, lambda: fn(params)))
    print(f"frame ms on {card}: kernel path {statistics.median(frame_ms):.4f} "
          f"(runs {frame_ms}), plain path {statistics.median(plain_frame_ms):.4f} (runs {plain_frame_ms})")
    print(f"frame latency ms on {card} (synchronised per frame): kernel path "
          f"{latency_ms(torch, lambda: program(params)):.4f}, "
          f"plain path {latency_ms(torch, lambda: plain_program(params)):.4f}")
    plain_fns = {
        "v210_unpack": K.v210_unpack_plain, "warp": warp_mod.warp_plain,
        "planar422_unpack": K.planar422_unpack_plain, "v210_pack": K.v210_pack_plain,
    }
    meta = {
        "v210_unpack": ("phaneron_tpu_torch/csrc/v210_unpack.cu", "phaneron_tpu/ops/pallas_kernels.py:341"),
        "v210_pack": ("phaneron_tpu_torch/csrc/v210_pack.cu", "phaneron_tpu/ops/pallas_kernels.py:546"),
        "planar422_unpack": ("phaneron_tpu_torch/csrc/planar422_unpack.cu", "phaneron_tpu/ops/pallas_kernels.py:892"),
        "warp": ("phaneron_tpu_torch/csrc/warp.cu", "phaneron_tpu/ops/pallas_warp.py:532"),
    }
    records = []
    for name in ("v210_unpack", "warp", "planar422_unpack", "v210_pack"):
        args = rec[name]["args"]
        ms = [time_ms(torch, lambda: wrappers[name](*args))]
        pms = [time_ms(torch, lambda: plain_fns[name](*args))]
        ms.append(time_ms(torch, lambda: wrappers[name](*args)))
        pms.append(time_ms(torch, lambda: plain_fns[name](*args)))
        kernel_ms, plain_ms = min(ms), min(pms)
        print(f"{name} on {card}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
        source, replaces = meta[name]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec[name]["max_abs_err"],
            "ms": kernel_ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
