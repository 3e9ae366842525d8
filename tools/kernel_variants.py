#!/usr/bin/env python3
"""Timed variants of two kernels on one card, to tell what sets their time.

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/kernel_variants.py

- K1 (v210 unpack, 1 source, 3 channels, 1920x1080), on seeded random
  words and on the fill_buf ramp: tools/k1_variants.cu in its two thread
  mappings (one thread per group, as before its redesign; one thread per
  pixel, as csrc/v210_unpack.cu), each whole, with its stores only (a
  constant decode), its decode only (no stores) and without the
  gamma'->linear gather.  The whole variants must equal
  v210_unpack_plain.
- K5 over v210 words (bench.py's progressive 4-layer frame at 3840x2160
  and 1920x1080, chip_smoke.py's sources; and on rolled ramps alone):
  csrc/packed_composite.cu built with other tile rows, window sizes and
  blocks per SM (VARIANTS), each held to packed_composite_plain (0
  codes, max |delta| 0) and timed beside the built source; and, timed
  only (their frames are wrong on purpose), the built source without the
  gamma'->linear gather, without the window's decode (its words stored
  as they are) and with one tap a channel in place of the bilinear
  sample (DIAGNOSTICS).

Times are device ms per call (chip_smoke.device_ms: calls captured into
a CUDA graph and replayed), with the card's name and power limit.
Builds go to build/variants/.  Exits 1 when a variant disagrees.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# K5 variants: name -> (tile rows, window texels, blocks per SM); two
# windows of 3 float32 a texel must stay within the kernel's 44 KB
VARIANTS = {"R5_W1776_B3": (5, 1776, 3), "R4_W1536_B5": (4, 1536, 5), "R3_W1344_B5": (3, 1344, 5)}
# K5 with a part taken out, timed only: name -> (line of phn_common.cuh, its stand-in)
DIAGNOSTICS = {
    "no gather": ("    lin[c] = g2l(d.g2l, gam);", "    lin[c] = gam;"),
    "no decode": ("      decode_v210(d, q, p, rgb);",
                  "      rgb[0] = rgb[1] = rgb[2] = __int_as_float(q.x + p);"),
    "one tap": ("""    out[c] = bilerp(t, v00 ? s[o] : 0.0f, v01 ? s[o + cols] : 0.0f, v10 ? s[o + 1] : 0.0f,
                    v11 ? s[o + cols + 1] : 0.0f);""", "    out[c] = v00 ? s[o] : 0.0f;"),
}
K1_PARTS = ("whole", "stores only", "decode only", "no gather")


def build(out: Path) -> dict:
    """Every variant library, one nvcc each, all at once: name -> path."""
    from phaneron_tpu_torch.ops import _build

    csrc = ROOT / "phaneron_tpu_torch" / "csrc"
    src = (csrc / "packed_composite.cu").read_text()
    common = (csrc / "phn_common.cuh").read_text()
    jobs = {"k1": (ROOT / "tools" / "k1_variants.cu", out / "k1_variants.so")}
    builds = {name: (consts, None) for name, consts in VARIANTS.items()}
    builds.update({name: (None, change) for name, change in DIAGNOSTICS.items()})
    for name, (consts, change) in builds.items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        if change is not None and change[0] not in common:
            raise RuntimeError(f"kernel_variants: phn_common.cuh no longer has the line {name} replaces")
        (d / "phn_common.cuh").write_text(common if change is None else common.replace(*change))
        text = src
        for const, value in zip(("kTileRows", "kWindowTexels", "kBlocksPerSm"), consts or ()):
            head = f"constexpr int {const} = "
            i = text.index(head) + len(head)
            text = text[:i] + str(value) + text[text.index(";", i):]
        (d / "packed_composite.cu").write_text(text)
        jobs[name] = (d / "packed_composite.cu", d / "lib.so")
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (cu, so) in jobs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in cs.ptxas_lines(log):
            print(f"  ptxas {name}: {line}")
    return {name: so for name, (_, so) in jobs.items()}


class K5Lib:
    """A variant library in the shape the packed_composite wrapper calls."""

    def __init__(self, path: Path):
        from phaneron_tpu_torch.ops import _build

        fn = ctypes.CDLL(str(path)).phn_packed_composite
        fn.argtypes = list(_build._SIGNATURES["phn_packed_composite"])
        fn.restype = ctypes.c_int
        self.phn_packed_composite = fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.formats import v210

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    libs = build(ROOT / "build" / "variants")
    rng = np.random.default_rng(cs.SEED)
    W, H, UW, UH = cs.W, cs.H, cs.UHD_W, cs.UHD_H
    bad = []

    # ---- K1: mappings x parts, random words and the ramp
    k1 = ctypes.CDLL(str(libs["k1"]))
    k1.k1_variant.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 3
    coeffs, g2l = K.v210_decode_args("709", "709", dev)
    groups = v210.pitch(W) // 6
    out = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    for content, words in (("random words", to_tensor(cs.random_words(rng, W, H), dev)),
                           ("the fill_buf ramp", to_tensor(v210.fill_buf(W, H)[0], dev))):
        plain = K.v210_unpack_plain([words], W, H, channels=3)[0]
        for mapping, mapping_name in enumerate(("one thread per group", "one thread per pixel")):
            times = []
            for part, part_name in enumerate(K1_PARTS):
                call = lambda: k1.k1_variant(mapping, part, words.data_ptr(), out.data_ptr(), W, H, groups, coeffs,
                                             g2l, torch.cuda.current_stream(dev).cuda_stream)
                if part == 0:
                    out.zero_()
                    call()
                    if not torch.equal(out, plain):
                        bad.append(f"K1 {mapping_name} on {content}")
                times.append(f"{part_name} {cs.device_ms(torch, call, calls=20):.4f}")
            print(f"K1 1920x1080, 3 channels, {content}, {mapping_name} on {card}: ms " + "; ".join(times))

    # ---- K5 over v210 words: the variants beside the built source
    cases = {}
    for w, h in ((UW, UH), (W, H)):
        _, params = cs.progressive_spec_params(torch, dev, rng, w, h)
        lps = params["layers"]
        args = ([s for lp in lps for s in (lp["src"][0], lp["src_b"][0])], (2, 2, 2, 2),
                [lp["matrix"] for lp in lps], [lp["mix"] for lp in lps])
        ramps = [to_tensor(np.roll(v210.fill_buf(w, h)[0], 4 * 11 * (k + 1), axis=1), dev) for k in range(8)]
        cases[f"{w}x{h}, ramps and random words"] = (args, (w, h))
        cases[f"{w}x{h}, ramps"] = ((ramps, *args[1:]), (w, h))
    k5 = {"built": _build.library(), **{name: K5Lib(libs[name]) for name in (*VARIANTS, *DIAGNOSTICS)}}
    try:
        for label, (args, size) in cases.items():
            kw = dict(src_kind="packed", size=size, emit="both", alpha="top")
            want = PW.packed_composite_plain(*args, **kw)
            times = {}
            for name, lib in list(k5.items()) + [("built", k5["built"])]:  # the built source first and last
                PW.library = lambda lib=lib: lib
                got = PW.packed_composite(*args, **kw)
                if name not in DIAGNOSTICS and (cs.code_delta(torch, got[0], want[0], *size)
                                                or not torch.equal(got[1], want[1])):
                    bad.append(f"K5 {name} at {label}")
                ms = cs.device_ms(torch, lambda: PW.packed_composite(*args, src_kind="packed", size=size),
                                  batches=5, calls=5)
                times[name] = min(ms, times.get(name, ms))
            print(f"K5 v210 words, 4 dissolve layers, {label} on {card}: ms "
                  + "; ".join(f"{n} {t:.4f}" for n, t in times.items()))
    finally:
        PW.library = _build.library
    print(f"variants that disagree with the plain version: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
