#!/usr/bin/env python3
"""Timed variants of the hand-written kernels on one card, to tell what
sets their time.

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/kernel_variants.py [--only k1,k5,yadif,rgb3,b3,rotate,b6,k4,planar,packs,v210packs]

- k1: K1 (v210 unpack, 1 source, 3 channels, 1920x1080), on seeded
  random words and on the fill_buf ramp: tools/k1_variants.cu in its two
  thread mappings (one thread per group, as before its redesign; one
  thread per pixel, as csrc/v210_unpack.cu), each whole, with its stores
  only (a constant decode), its decode only (no stores) and without the
  gamma'->linear gather.  The whole variants must equal
  v210_unpack_plain.
- k5: K5 over v210 words (bench.py's progressive 4-layer frame at
  3840x2160 and 1920x1080, chip_smoke.py's sources; and on rolled ramps
  alone): csrc/packed_composite.cu built with other tile rows, window
  sizes and blocks per SM (K5_VARIANTS), each held to
  packed_composite_plain (0 codes, max |delta| 0) and timed beside the
  built source; and, timed only (their frames are wrong on purpose), the
  built source without the gamma'->linear gather, without the window's
  decode (its words stored as they are) and with one tap a channel in
  place of the bilinear sample (K5_DIAGNOSTICS).
- yadif: yadif_pair and yadif_ring (parity 1 in device memory) on
  chip_smoke.py's 3-channel 1920x1080 ring (tff), the default load's and
  the ring route's shape.  Each kernel's old mapping
  (tools/yadif_variants.cu: one thread a pixel, clamped gathers from
  device memory) whole, with its stores only, its loads with trivial
  arithmetic, its full arithmetic on taps made from the pixel's
  position, and its taps read without clamps; each new mapping
  (csrc/yadif.cu, staged tiles) built with other tile shapes
  (YADIF_VARIANTS, YADIF_RING_VARIANTS) and, timed only, without the
  staging copies, without the arithmetic (the taps summed) and with one
  staging buffer (no overlap of the next plane's copy)
  (YADIF_DIAGNOSTICS, YADIF_RING_DIAGNOSTICS).  The whole variants must
  equal yadif_pair_plain / yadif_ring_plain (max |delta| 0), and so at
  bff, with skip_spatial, 4 channels and opaque, and at 1918x1081 (the
  ring also at both parities and at 33x65 and 31x63, off its tiles).
- rgb3: K5 over (3, H, W) frames, chip_smoke.py's interlaced tick (4
  dissolve layers, 8 seeded random sources, scale-0.9 matrices) at
  1920x1080.  The tile kernel (csrc/packed_composite.cu
  frame_tile_kernel) built with other rows a thread, window sizes and
  blocks per SM (RGB3_VARIANTS), and the old
  mapping (frames_kernel, one thread a pixel of one row, every tap
  gathered from device memory), each held to packed_composite_plain (0
  codes; max |delta| 0 on the frame); and, timed only, the old mapping
  with its taps replaced by constants, and the tile kernel without the
  windows' copies, without its all-taps-inside path, without the copies
  and the sampling, without the encode, and with one tap a channel
  (RGB3_DIAGNOSTICS).

- b3: the fused v210 program (chip_smoke.py's playout dissolve: the
  fill_buf ramp into seeded random words, mix 0.5; and two rolled ramps)
  at 3840x2160 and 1920x1080.  tools/b3_variants.cu: the old mapping (one
  thread a 6-pixel group, a loop over its pixels that breaks at the frame
  width, linear->gamma' by powf) whole, with its stores only (no loads,
  decode or encode), without the gamma'->linear gather (the table index
  scaled instead), without the powf (the linear segment for every code)
  and without the width break for full groups; one thread a pixel with
  the block encode; the old mapping with linear->gamma' gathered from a
  float table of its 65536 values; and one thread a pixel with the built
  kernel's corrected transfers, in persistent 192x5 blocks with the
  corrections in shared memory and in 192x2 and 192x4 blocks reading
  them through L1.  csrc/fused_v210.cu (the transfers from MUFU
  approximations and shared-memory corrections) built with other rows a
  tile and with the warp's choice of gather or approximation forced
  either way (B3_VARIANTS), with powf in place of the corrected
  linear->gamma', without the width break and with R''s Cb and B''s Cr
  terms kept (held), and, timed only, without gamma'->linear, without the
  corrections and without the word loads (B3_DIAGNOSTICS).  The old
  mapping whole and without its break, the other designs, and every
  B3_VARIANTS and held build must be <= 1 code from fused_v210_plain.
- rotate: B14 on seeded random RGBA frames, a cut at 0, 45, 100 and 180
  degrees (scale 0.9) at 3840x2160 and chip_smoke.py's two-matrix
  dissolve pair (100 and 95 degrees) at 1920x1080.
  tools/rotate_variants.cu: the old mapping (one thread a pixel, every
  tap gathered from device memory, a warp 32 pixels of a row) whole, with
  its stores only, with each tap's value made from its position in place
  of its load, and whole in 16x16 blocks whose warps cover 8x4 pixels.
  csrc/rotate.cu (shared-memory source windows a tile) built with 4-byte
  copies, other tiles and window sizes (ROTATE_VARIANTS) and without the
  windows (every tile on the direct gather), and, timed only, without the
  windows' copies and with one tap a channel (ROTATE_DIAGNOSTICS); with
  the window/direct (tile, source) counts of the built source.  The old
  mapping whole in both blocks, every ROTATE_VARIANTS build and the
  direct-only build must equal rotate_plain (max |delta| 0).
- b6: the packed warp (B6) at the entry frame's shape (1920x1080, a
  shared-matrix dissolve pair of the fill_buf ramp and seeded random
  words at scale 0.95, mix 0.5), a distinct-matrix pair and a single
  warp.  tools/b6_variants.cu: the old mapping (one thread an output
  pixel, every valid tap decoded where it is used) whole, with its stores
  only, with each tap's RGB made from its position in place of its load
  and decode, and without the gamma'->linear gather.  csrc/packed_warp.cu
  (each tile's windows decoded once into shared memory) built with other
  tile rows, block rows, window sizes and blocks per SM (B6_VARIANTS),
  without the windows (every tile decoded at each tap), without its
  all-taps-inside path, with gamma'->linear from MUFU approximations
  moved by csrc/fused_v210.cu's correction bytes (read through L1) and
  with the table index rounded by one conversion, and, timed only,
  without the gather, without the windows' decode and with one tap a
  channel (B6_DIAGNOSTICS); with the window/direct (tile, source) counts
  of the built source.  The old mapping whole, every B6_VARIANTS build
  and the held diagnostics must equal packed_warp_plain (max |delta| 0).
- k4: the axis-aligned warp (K4) at 1920x1080: the 3-channel dissolve
  pair (scale 0.9, the record), the 4-channel pair, the 4-channel wipe
  pair, a pair under two matrices, a single warp at scale 0.95 (the keyed
  frame's graphic), the media channel's picture in picture
  (a 4-channel dissolve at scale 0.5), and the 4-channel wipe pair at
  3840x2160 (the wipe frame's).  tools/warp_variants.cu: the old mapping
  (one thread a pixel, its own taps, channels and mode at run time) whole,
  with its stores only, and with each tap's value made from its position
  in place of its load.  csrc/warp.cu (the same mapping, channels and
  mode template constants) built with other block shapes (K4_VARIANTS).
  tools/warp_windows.cu, the windowed design (taps once a tile, each
  source's window copied into shared memory with cp.async), whole, with
  its window/direct (tile, source) counts; and torch's grid_sample (matrix
  a, no mix).  The old mapping whole, every K4_VARIANTS build and the
  windowed design must equal warp_plain (max |delta| 0).
- planar: the planar unpacks, K3/B10 (yuv422p8, yuv422p10le) and B12
  (yuv420p, nv12), at 1920x1080 and 3840x2160, on seeded full-range
  random planes and on the fill_buf ramps.  tools/planar_variants.cu: the
  old mapping (one thread a pixel pair of one row) whole, with its stores
  only (a constant decode, no loads), without the gamma'->linear gather
  (the table index scaled instead) and with its loads and trivial
  arithmetic (the samples stored as they are); one thread a pixel (K1's
  mapping), whole.  csrc/planar422_unpack.cu and planar420_unpack.cu (a
  thread a quad, 16-byte plane stores; 4:2:2 with vector loads, 4:2:0
  with one load a sample) built with other block rows and rows a thread
  (PLANAR_VARIANTS), and (PLANAR_DIAGNOSTICS) with one load a sample
  (4:2:2) or vector loads (4:2:0), with one store a pixel, with the L1 carveout set, with 8 blocks an SM,
  with 4:2:0's second row loaded after the first is stored, with
  gamma'->linear from MUFU approximations moved by csrc/fused_v210.cu's
  correction bytes (read through L1) in every warp or only in warps
  most of whose quads are rough (alone, with 16 block rows, with 8 blocks
  an SM), and, timed only, without the gather.  The old mapping and the
  pixel mapping whole, every PLANAR_VARIANTS build and the held
  diagnostics must equal the plain version (max |delta| 0).
- packs: the planar packs, B11 (yuv422p8, yuv422p10le) and B13 (yuv420p,
  nv12), at 1920x1080 and 3840x2160, C 4, on seeded random RGBA in
  [-0.05, 1.05], on the format's decoded fill_buf ramp and on the media
  channel's composited frame (chip_smoke.media_frame, what the records
  pack).  tools/planar_pack_variants.cu: the old mapping (one thread a
  pixel pair of one row, three powf a pixel) whole, with its stores only
  (constant codes, no loads), without the powf (the linear segment for
  every index) and with its loads and trivial arithmetic; and the quad
  mappings that load into registers (a thread a quad, 16-byte loads a
  plane, one store a plane; 4:2:0 a quad of a row pair) with
  linear->gamma' by powf, by two MUFU operations and a correction byte
  from shared memory (persistent blocks) or through L1, by a gather from
  a 65536-float table of l2g's values, and by the gather in warps whose
  indices lie close and the shared corrections elsewhere; 8 pixels a
  thread (with the shared corrections and with powf); 4:2:0 a row a
  thread; one load a pixel; 16 block rows at 2 blocks an SM.
  csrc/planar422_pack.cu and planar420_pack.cu (phn::pack_tiles: the
  frame staged in shared memory with cp.async a tile ahead) built with
  other block rows and stages, with the table indices and codes rounded
  by conversion instructions, and, timed only (PACK_TIMED_ONLY), without
  the MUFU operations, without linear->gamma', without the loads and
  without the stores (PACK_VARIANTS).  Every other variant, the old
  mapping whole included, must equal the built kernel (max |delta| 0),
  checked before it is timed; the largest l2g correction is printed.

- v210packs: K2 (v210_pack) and B5 (combine_pack) on
  chip_smoke.v210_pack_inputs: K2 at 1920x1080 and 3840x2160, C 3 and
  4, on seeded random RGB(A) in [-0.05, 1.05], the decoded fill_buf ramp
  and the one_rotation emit_rgba path's composited frame (and the keyed
  straggler's at 1920x1080); B5 on the entry frame's 2 RGBA layers, the
  one_rotation and wipe paths' 2-layer stacks at both sizes and a mixed
  4-layer stack of RGBA and (rgb, wy, wx) layers.
  tools/v210_pack_variants.cu: the kernels before their redesign,
  verbatim, whole, with their stores only (constant codes, no loads),
  without the powf (the linear segment for every index) and with their
  loads and trivial arithmetic; and the other mappings with the l2g
  correction bytes in shared memory: (a) 192 threads a row segment, a
  thread a pixel, codes exchanged behind a named barrier; a warp a
  segment with its loads in registers (a lane three pixel pairs, codes
  exchanged through shared memory), also with the next segment
  prefetched into L2; and the staged design with every layer in one
  stage.  csrc/combine_pack.cu (phn::v210_segments, a thread a 6-pixel
  group from planes staged with cp.async a stage ahead, one layer a
  stage; K2 is one layer) built with linear->gamma' by powf, one 4-byte
  copy a pixel, 3 stages, at most 16 warps a block, and, timed only
  (V210_TIMED_ONLY), without the MUFU operations, without linear->gamma',
  without the copies into shared memory and without the encode and the
  stores
  (V210_VARIANTS).  Every variant but the timed-only ones, and the built
  wrappers, must equal the old kernel's words exactly, on every shape and
  on an edge sweep (widths 1-13 and 1918 at 3 rows, 1280x16 and 200x7;
  K2 C 3 and 4; B5 with 1, 2, 4 and 8 layers mixing both kinds; the frames
  one float off their 16-byte alignment).

Times are device ms per call (chip_smoke.device_ms: calls captured into
a CUDA graph and replayed), with the card's name and power limit.
Builds go to build/variants/.  Exits 1 when a variant disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "phaneron_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SECTIONS = ("k1", "k5", "yadif", "rgb3", "b3", "rotate", "b6", "k4", "planar", "packs", "v210packs")
# K5 over words: name -> {constant: value}; two windows of 3 float32 a
# texel must stay within the kernel's shared memory
K5_VARIANTS = {
    "R5_W1776_B3": dict(kTileRows=5, kWindowTexels=1776, kBlocksPerSm=3),
    "R4_W1536_B5": dict(kTileRows=4, kWindowTexels=1536, kBlocksPerSm=5),
    "R3_W1344_B5": dict(kTileRows=3, kWindowTexels=1344, kBlocksPerSm=5),
}
# a part taken out, timed only: name -> (line of phn_common.cuh, its stand-in)
ONE_TAP = ("""    out[c] = bilerp(t, v00 ? s[o] : 0.0f, v01 ? s[o + cols] : 0.0f, v10 ? s[o + 1] : 0.0f,
                    v11 ? s[o + cols + 1] : 0.0f);""", "    out[c] = v00 ? s[o] : 0.0f;")
K5_DIAGNOSTICS = {
    "no gather": ("    lin[c] = g2l(d.g2l, gam);", "    lin[c] = gam;"),
    "no decode": ("      decode_v210(d, q, p, rgb);",
                  "      rgb[0] = rgb[1] = rgb[2] = __int_as_float(q.x + p);"),
    "one tap": ONE_TAP,
}
# yadif_pair's staged tiles: name -> {constant: value}
YADIF_VARIANTS = {
    "C64_G4_W8_B3": dict(kPairCols=64, kPairRowGroups=4, kPairWalk=8, kPairBlocksPerSm=3),
    "C128_G2_W8_B3": dict(kPairCols=128, kPairRowGroups=2, kPairWalk=8, kPairBlocksPerSm=3),
    "C32_G8_W4_B4": dict(kPairCols=32, kPairRowGroups=8, kPairWalk=4, kPairBlocksPerSm=4),
    "C64_G4_W4_B4": dict(kPairCols=64, kPairRowGroups=4, kPairWalk=4, kPairBlocksPerSm=4),
    "C64_G2_W16_B3": dict(kPairCols=64, kPairRowGroups=2, kPairWalk=16, kPairBlocksPerSm=3),
    "C128_G4_W4_B2": dict(kPairCols=128, kPairRowGroups=4, kPairWalk=4, kPairBlocksPerSm=2),
}
YADIF_SUM = ("    const float pred = temporal_clamp(", "    const float pred = c[1][0] + c[1][1] + c[1][2] + "
             "c[1][4] + c[1][5] + c[1][6] + c[3][0] + c[3][1] + c[3][2] + c[3][4] + c[3][5] + c[3][6] + "
             "p[0] + p[1] + p[2] + p[3] + p[4] + n[0] + n[1] + n[2] + n[3] + n[4] + spatial;\n"
             "    if (false) temporal_clamp(")
YADIF_DIAGNOSTICS = {  # name -> [(line of csrc/yadif.cu, its stand-in), ...]
    "no staging": [("      phn::cp_async16(dst, row + x);", "      (void)dst;"),
                   ("      for (int e = 0; e < 4; ++e) phn::cp_async4(dst + e, row + col_of(x + e, width));",
                    "      for (int e = 0; e < 0; ++e) {}")],
    "no arithmetic": [("    const float spatial = spatial_from_taps(", "    const float spatial = c[0][3] + c[4][3]; if (false) spatial_from_taps("),
                      YADIF_SUM],
    "one buffer": [("      phn::cp_async_wait<1>();", "      phn::cp_async_wait<0>();")],
}
YADIF_OLD_PARTS = ("whole", "stores only", "loads, trivial arithmetic", "arithmetic, no loads",
                   "taps without clamps")
# yadif_ring's staged tiles: name -> {constant: value} (columns, row groups,
# row pairs a thread walks, blocks an SM); two planes' buffers must fit
YADIF_RING_VARIANTS = {
    "C64_G2_S8_B4": dict(kRingCols=64, kRingRowGroups=2, kRingSteps=8, kRingBlocksPerSm=4),
    "C64_G4_S4_B4": dict(kRingCols=64, kRingRowGroups=4, kRingSteps=4, kRingBlocksPerSm=4),
    "C64_G4_S4_B3": dict(kRingCols=64, kRingRowGroups=4, kRingSteps=4, kRingBlocksPerSm=3),
    "C64_G4_S8_B2": dict(kRingCols=64, kRingRowGroups=4, kRingSteps=8, kRingBlocksPerSm=2),
    "C64_G2_S8_B5": dict(kRingCols=64, kRingRowGroups=2, kRingSteps=8, kRingBlocksPerSm=5),
    "C64_G2_S4_B6": dict(kRingCols=64, kRingRowGroups=2, kRingSteps=4, kRingBlocksPerSm=6),
    "C64_G2_S16_B2": dict(kRingCols=64, kRingRowGroups=2, kRingSteps=16, kRingBlocksPerSm=2),
    "C128_G1_S8_B4": dict(kRingCols=128, kRingRowGroups=1, kRingSteps=8, kRingBlocksPerSm=4),
    "C32_G4_S8_B6": dict(kRingCols=32, kRingRowGroups=4, kRingSteps=8, kRingBlocksPerSm=6),
}
YADIF_RING_SUM = ("        temporal_clamp(p[0], p[1], cde[0], cde[1], cde[2], c[0][3], c[1][3], hij[0], hij[1],",
                  "        c[0][0] + c[0][1] + c[0][2] + c[0][4] + c[0][5] + c[0][6] + c[1][0] + c[1][1] + "
                  "c[1][2] + c[1][4] + c[1][5] + c[1][6] + p[0] + p[1] + n[0] + n[1] + cde[0] + cde[1] + cde[2] + "
                  "hij[0] + hij[1] + hij[2] + spatial;\n"
                  "    if (false) (void)temporal_clamp(p[0], p[1], cde[0], cde[1], cde[2], c[0][3], c[1][3], hij[0], "
                  "hij[1],")
YADIF_RING_DIAGNOSTICS = {  # name -> [(line of csrc/yadif.cu, its stand-in), ...]
    "no staging": [("      phn::cp_async16(d, row + x);", "      (void)d;"),
                   ("      for (int e = 0; e < 4; ++e) phn::cp_async4(d + e, row + col_of(x + e, width));",
                    "      for (int e = 0; e < 0; ++e) {}")],
    "no arithmetic": [("    const float spatial = spatial_from_taps(c[0][0],",
                       "    const float spatial = c[0][3] + c[1][3]; if (false) spatial_from_taps(c[0][0],"),
                      YADIF_RING_SUM],
    "one buffer": [("                       x_lo, b, is_second, f.width, f.height, vec);\n"
                    "      phn::cp_async_commit();\n      phn::cp_async_wait<1>();",
                    "                       x_lo, b, is_second, f.width, f.height, vec);\n"
                    "      phn::cp_async_commit();\n      phn::cp_async_wait<0>();")],
}
# K5 over rgb3 frames: the tile kernel's constants, and the old mapping
RGB3_VARIANTS = {
    "R3_W1792_B2": dict(kFrameRowsPerThread=3, kFrameWindowTexels=1792, kFrameBlocksPerSm=2),
    "R2_W1344_B3": dict(kFrameRowsPerThread=2, kFrameWindowTexels=1344, kFrameBlocksPerSm=3),
    "R4_W2240_B2": dict(kFrameRowsPerThread=4, kFrameWindowTexels=2240, kFrameBlocksPerSm=2),
    "R1_W896_B3": dict(kFrameRowsPerThread=1, kFrameWindowTexels=896, kFrameBlocksPerSm=3),
}
ONE_TAP_INSIDE = ("""  const float c0 = s[0] * (1.0f - fy) + s[cols] * fy;
  const float c1 = s[1] * (1.0f - fy) + s[cols + 1] * fy;
  return c0 * (1.0f - fx) + c1 * fx;""", "  return s[0];")
OLD_RGB3 = ("""    frame_tile_kernel<<<dim3(blocks_x, (height + kFrameTileRows - 1) / kFrameTileRows),
                        dim3(phn::kPixelsPerBlock, kFrameThreadRows), kFrameSmemBytes, st>>>(
        L, w, f, e, width, height, groups, top_alpha, static_cast<unsigned long long*>(branches));""",
            "    frames_kernel<kRgb3><<<dim3(blocks_x, height), block, 0, st>>>(L, w, f, e, width, height, groups, "
            "top_alpha);")
RGB3_DIAGNOSTICS = {  # name -> {file: [(line, its stand-in), ...]}
    "old mapping": {"packed_composite.cu": [OLD_RGB3]},
    "old mapping, no taps": {"packed_composite.cu": [OLD_RGB3, (
        "  for (int c = 0; c < (kKind == kRgba ? 4 : 3); ++c) v[c] = phn::sample(s + c * plane, width, tp);",
        "  for (int c = 0; c < (kKind == kRgba ? 4 : 3); ++c) v[c] = tp.fx * 0.5f + 0.125f * c;")]},
    "no window copy": {"packed_composite.cu": [("phn::cp_async16(d + 128 * k, g + 128 * k);", "(void)d;")]},
    "no all-valid path": {"packed_composite.cu": [("      if (t.inside && t.windowed) {", "      if (false) {")]},
    "no copy, no sampling": {"packed_composite.cu": [
        ("phn::cp_async16(d + 128 * k, g + 128 * k);", "(void)d;"),
        ("  const float c0 = s[0] * (1.0f - fy) + s[cols] * fy;\n  const float c1 = s[1] * (1.0f - fy) + s[cols + 1] * fy;\n"
         "  return c0 * (1.0f - fx) + c1 * fx;", "  return fx + s[0];")]},
    "no encode": {"packed_composite.cu": [
        ("  if (words != nullptr) encode_pack_tile(e, out, x, width, y_lo, r_lo, height, groups, words);",
         "  if (words != nullptr && out[0][0] == -1.0f) words[0].x = 1;")]},
    "one tap": {"phn_common.cuh": [ONE_TAP], "packed_composite.cu": [ONE_TAP_INSIDE]},
}
HELD_RGB3 = ("old mapping",)  # a diagnostic whose output must still equal the plain version
# B3, the fused v210 program: rows a tile (one block an SM), the span of
# indices a warp gathers, and parts changed or taken out
B3_VARIANTS = {"rows 24": dict(kRows=24), "always the approximation": dict(kGatherSpan=-1),
               "always the gather": dict(kGatherSpan=65536)}
B3_DIAGNOSTICS = {  # name -> {file: [(line, its stand-in), ...]}
    "powf": {"fused_v210.cu": [(f"      const float {c}p = l2g_corrected(e.g, l2g_corr, rgb[{i}]);",
                                f"      const float {c}p = phn::l2g(e.g, rgb[{i}]);") for i, c in enumerate("rgb")]},
    "no break": {"fused_v210.cu": [("      if (gi * 6 + p >= width) break;",
                                    "      if (gi * 6 + 6 > width && gi * 6 + p >= width) break;")]},
    "dense decode": {"fused_v210.cu": [("  if (c == 0) return d.col[0] * yf + d.col[2] * vf + d.col[3];\n"
                                        "  if (c == 2) return d.col[8] * yf + d.col[9] * uf + d.col[11];\n", "")]},
    "no g2l": {"fused_v210.cu": [("    lin[c] = kGather ? __ldg(d.g2l + i) : moved(g2l_approx(g, i), corr, i);",
                                  "    lin[c] = static_cast<float>(i);")]},
    "no corrections": {"phn_common.cuh": [("  return __int_as_float(__float_as_int(approx) + corr[i]);",
                                          "  return approx;")]},
    "no word loads": {"fused_v210.cu": [
        ("    const int4 wa = __ldg(a + at);", "    const int4 wa = make_int4(at, gi, row, gi * 977);"),
        ("    const int4 wb = b != nullptr ? __ldg(b + at) : wa;", "    const int4 wb = make_int4(gi * 613, row, gi, at);")]},
}
HELD_B3 = ("powf", "no break", "dense decode")
B3_PARTS = ("old mapping: whole", "old: stores only", "old: no gather", "old: no powf", "old: no break",
            "a thread a pixel", "old, l2g from a float table",
            "a thread a pixel, corrected transfers, 5 rows, corrections in shared memory",
            "a thread a pixel, corrected transfers, 2 rows, corrections through L1",
            "a thread a pixel, corrected transfers, 4 rows, corrections through L1")
B3_PARTS_HELD = (0, 4, 5, 6, 7, 8, 9)
# B14 rotate: tile, block rows and window size; parts taken out
ROTATE_VARIANTS = {
    "4-byte copies": dict(kCopyTexels=1),
    "window 2176": dict(kWindowTexels=2176),
    "tile 32x32": dict(kTileH=32, kWindowTexels=2816),
    "tile 32x16": dict(kTileH=16, kWindowTexels=1536),
    "pair tile 32x8": dict(kPairTileH=8, kPairWindowTexels=1024),
    "pair two buffers": dict(kPairBuffers=2),
    "one buffer": dict(kSingleBuffers=1),
}
ROTATE_DIAGNOSTICS = {  # name -> {file: [(line, its stand-in), ...]}
    "direct only": {"rotate.cu": [("  return Window{c0, y_first, cols, rows, pitch, unit, rows * pitch <= kTexels, 0,",
                                   "  return Window{c0, y_first, cols, rows, pitch, unit, false, 0,")]},
    "no window copy": {"rotate.cu": [("  for (int e = threadIdx.y * kTileW + threadIdx.x; e < n; e += kThreads) {",
                                      "  for (int e = threadIdx.y * kTileW + threadIdx.x; e < 0; e += kThreads) {")]},
    "one tap": {"rotate.cu": [("  const float top = v00 * (1.0f - t.fx) + v10 * t.fx;\n"
                               "  const float bot = v01 * (1.0f - t.fx) + v11 * t.fx;\n"
                               "  return top * (1.0f - t.fy) + bot * t.fy;",
                               "  return t.vx0 && t.vy0 ? s[o] : 0.0f;")]},
}
HELD_ROTATE = ("direct only",)
ROTATE_OLD_PARTS = ("whole", "stores only", "taps from the position", "whole, 16x16 blocks of 8x4 warps")
ROTATE_OLD_HELD = (0, 3)

# B6 packed_warp: tile rows, block rows, window size and blocks per SM;
# parts taken out
B6_VARIANTS = {
    "1 block row, 4 blocks": dict(kThreadRows=1, kBlocksPerSm=4),
    "4 block rows, 2 blocks": dict(kThreadRows=4, kBlocksPerSm=2),
    "4 blocks": dict(kBlocksPerSm=4),
    "rows 8, 4 block rows, 2 blocks": dict(kTileRows=8, kThreadRows=4, kWindowTexels=3072, kBlocksPerSm=2),
    "rows 2": dict(kTileRows=2, kWindowTexels=1152, kBlocksPerSm=4),
}
B6_INSIDE_ONE_TAP = ("      v[c] = c0 * (1.0f - t.fx) + c1 * t.fx;", "      v[c] = q[c][0];")
B6_DIAGNOSTICS = {  # name -> {file: [(line, its stand-in), ...]}
    "direct only": {"packed_warp.cu": [("    src[s].fits = sp.win.texels() <= kWindowTexels;", "    src[s].fits = false;")]},
    "no inside path": {"packed_warp.cu": [("  if (s.fits && s.inside) {", "  if (false) {")]},
    "no gather": {"phn_common.cuh": [K5_DIAGNOSTICS["no gather"]]},
    "no decode": {"packed_warp.cu": [("      phn::decode_v210(d, q, p, rgb);",
                                      "      rgb[0] = rgb[1] = rgb[2] = __int_as_float(q.x + p);")]},
    "one tap": {"phn_common.cuh": [ONE_TAP], "packed_warp.cu": [B6_INSIDE_ONE_TAP]},
}
# gamma'->linear from two MUFU operations moved to the table's value by a
# signed byte an index (csrc/fused_v210.cu's g2l_approx and corrections),
# the bytes in device memory, read through L1; b6_set_g2l (appended to the
# variant) copies them and the transfer's constants in
B6_G2L_HELPERS = """constexpr int kBlocksPerSm = 3;
__device__ float g2l_consts[6];  // inv_max, thr, inv_delta, a1, inv_alpha, inv_gamma
__device__ signed char g2l_corr[65536];
__device__ __forceinline__ float g2l_corrected(int i) {
  const float fi = static_cast<float>(i) * g2l_consts[0];
  float r;
  if (fi < g2l_consts[1]) {
    r = fi * g2l_consts[2];
  } else {
    float l;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"((fi + g2l_consts[3]) * g2l_consts[4]));
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(g2l_consts[5] * l));
  }
  return __int_as_float(__float_as_int(r) + g2l_corr[i]);
}"""
B6_G2L_DECODE = """      {
        unsigned yc, cbc, crc;
        phn::v210_fields(q, p, yc, cbc, crc);
        const float yf = static_cast<float>(yc), uf = static_cast<float>(cbc), vf = static_cast<float>(crc);
        float lin[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          lin[c] = g2l_corrected(phn::u16_sat_rte((d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf +
                                                   d.col[4 * c + 3]) * 65535.0f));
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
      }"""
B6_G2L_SETTER = """}  // namespace

extern "C" int b6_set_g2l(const void* corr, const float* consts) {
  cudaError_t err = cudaMemcpyToSymbol(g2l_corr, corr, 65536, 0, cudaMemcpyDeviceToDevice);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g2l_consts, consts, 6 * sizeof(float));
  return static_cast<int>(err);
}"""
B6_DIAGNOSTICS["g2l approximation"] = {"packed_warp.cu": [
    ("constexpr int kBlocksPerSm = 3;", B6_G2L_HELPERS),
    ("      phn::decode_v210(d, q, p, rgb);", B6_G2L_DECODE),
    ("}  // namespace", B6_G2L_SETTER)]}
B6_DIAGNOSTICS["one-instruction index"] = {"phn_common.cuh": [
    ("  return static_cast<int>(fminf(fmaxf(rintf(x), 0.0f), 65535.0f));",
     '  unsigned short r;\n  asm("cvt.rni.u16.f32 %0, %1;" : "=h"(r) : "f"(x));\n  return r;')]}
HELD_B6 = ("direct only", "no inside path", "g2l approximation", "one-instruction index")
B6_OLD_PARTS = ("whole", "stores only", "taps from the position", "no gather")
B6_OLD_HELD = (0,)
# K4 warp: block shapes
K4_VARIANTS = {
    "32x4 blocks": dict(kBlockH=4),
    "32x16 blocks": dict(kBlockH=16),
    "64x4 blocks": dict(kBlockW=64, kBlockH=4),
}
K4_OLD_PARTS = ("whole", "stores only", "taps from the position")
K4_OLD_HELD = (0,)
# the planar unpacks: block rows and rows (4:2:0: row pairs) a thread, set
# in both sources; parts changed or taken out, "unpack" standing for both
PLANAR_SOURCES = {"planar422": "planar422_unpack.cu", "planar420": "planar420_unpack.cu"}
PLANAR_VARIANTS = {
    "4 block rows": dict(kThreadRows=4),
    "16 block rows": dict(kThreadRows=16),
    "1 row a thread": dict(kRowsPerThread=1),
    "2 rows a thread": dict(kRowsPerThread=2),
    "4 rows a thread": dict(kRowsPerThread=4),
}
PLANAR_G2L = ("constexpr unsigned kField = 0x3FFu;  // one 10-bit v210 field",
              "constexpr unsigned kField = 0x3FFu;\n" + B6_G2L_HELPERS.split("\n", 1)[1])
PLANAR_G2L_SETTER = """}  // namespace

extern "C" int planar_set_g2l(const void* corr, const float* consts) {
  cudaError_t err = cudaMemcpyToSymbol(phn::g2l_corr, corr, 65536, 0, cudaMemcpyDeviceToDevice);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phn::g2l_consts, consts, 6 * sizeof(float));
  return static_cast<int>(err);
}"""
PLANAR_DIAGNOSTICS = {  # name -> {file: [(line, its stand-in), ...]}
    "one load a sample": {"planar422_unpack.cu": [("  const bool vec_loads = vector_loads<T>(y, u, v, y_pitch, c_pitch);",
                                                   "  const bool vec_loads = false;")]},
    "4:2:0 vector loads": {"planar420_unpack.cu": [
        (f"phn::load_samples<uint8_t, {n}, false>", f"phn::load_samples<uint8_t, {n}, true>") for n in (2, 4)]},
    "one store a pixel": {"unpack": [("  const bool vec_stores = width % 4 == 0;",
                                      "  const bool vec_stores = false;")]},
    "g2l approximation": {"phn_common.cuh": [PLANAR_G2L, (
        "    lin[c] = g2l(d.g2l, gam);", "    lin[c] = g2l_corrected(u16_sat_rte(gam * 65535.0f));")],
        "unpack": [("}  // namespace", PLANAR_G2L_SETTER)]},
    "no gather": {"phn_common.cuh": [(
        "    lin[c] = g2l(d.g2l, gam);",
        "    lin[c] = static_cast<float>(u16_sat_rte(gam * 65535.0f)) * 1.52590219e-05f;")]},
}
PLANAR_GRID = "  const dim3 grid((width + 4 * phn::kQuadsPerWarp - 1) / (4 * phn::kQuadsPerWarp),"
PLANAR_CARVEOUT = ("  static bool carved = false;\n  if (!carved) {{\n    cudaFuncSetAttribute({}_unpack_kernel<{}>, "
                   "cudaFuncAttributePreferredSharedMemoryCarveout, {});\n    carved = true;\n  }}\n" + PLANAR_GRID)
PLANAR_ONE_ROW = ("""    float y1[4];
    phn::load_samples<uint8_t, 4, false>(y + static_cast<size_t>(row) * y_pitch + x0, q.y);
    if (second)
      phn::load_samples<uint8_t, 4, false>(y + static_cast<size_t>(row + 1) * y_pitch + x0, y1);
    float* o = out + static_cast<size_t>(row) * width + x0;
    phn::decode_quad<kVecStore>(d, q, o, plane, width - x0);
    if (second) {
#pragma unroll
      for (int p = 0; p < 4; ++p) q.y[p] = y1[p];
      phn::decode_quad<kVecStore>(d, q, o + width, plane, width - x0);
    }""", """    float* o = out + static_cast<size_t>(row) * width + x0;
    phn::load_samples<uint8_t, 4, false>(y + static_cast<size_t>(row) * y_pitch + x0, q.y);
    phn::decode_quad<kVecStore>(d, q, o, plane, width - x0);
    if (second) {
      phn::load_samples<uint8_t, 4, false>(y + static_cast<size_t>(row + 1) * y_pitch + x0, q.y);
      phn::decode_quad<kVecStore>(d, q, o + width, plane, width - x0);
    }""")
for name, percent in (("L1 carveout max", 0), ("L1 carveout half", 50)):
    PLANAR_DIAGNOSTICS[name] = {
        "planar422_unpack.cu": [(PLANAR_GRID, PLANAR_CARVEOUT.format("planar422", "T, kVecLoad, kVecStore", percent))],
        "planar420_unpack.cu": [(PLANAR_GRID, PLANAR_CARVEOUT.format("planar420", "kNv12, kVecStore", percent))]}
PLANAR_DIAGNOSTICS["L1 carveout max, 16 block rows"] = {
    **PLANAR_DIAGNOSTICS["L1 carveout max"],
    "unpack": [("constexpr int kThreadRows = 8;", "constexpr int kThreadRows = 16;")]}
PLANAR_DIAGNOSTICS["8 blocks an SM"] = {"unpack": [("__global__ void __launch_bounds__(kThreads)",
                                                    "__global__ void __launch_bounds__(kThreads, 8)")]}
PLANAR_DIAGNOSTICS["4:2:0 rows one by one"] = {"planar420_unpack.cu": [PLANAR_ONE_ROW]}
# the approximation only in warps most of whose quads are rough (green's
# index moves more than kRough from a quad's first pixel to its last, as
# on random planes and not on smooth video), the table's gather elsewhere
PLANAR_ROUGH = """constexpr int kQuadsPerWarp = 32;
constexpr float kRough = 4096.0f;

__device__ __forceinline__ void decode_approx(const Decode& d, float yf, float uf, float vf, float rgb[3]) {
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gam = d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf + d.col[4 * c + 3];
    lin[c] = g2l_corrected(u16_sat_rte(gam * 65535.0f));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
}"""
PLANAR_DIAGNOSTICS["g2l approximation where rough"] = {
    "phn_common.cuh": [PLANAR_G2L, ("constexpr int kQuadsPerWarp = 32;", PLANAR_ROUGH), (
        "  float c[3][4];\n",
        "  float c[3][4];\n"
        "  const float g0 = d.col[4] * q.y[0] + d.col[5] * q.cb[0] + d.col[6] * q.cr[0] + d.col[7];\n"
        "  const float g3 = d.col[4] * q.y[3] + d.col[5] * q.cb[1] + d.col[6] * q.cr[1] + d.col[7];\n"
        "  const unsigned lanes = __activemask();\n"
        "  const bool approx =\n"
        "      2 * __popc(__ballot_sync(lanes, fabsf(g3 - g0) * 65535.0f > kRough)) > __popc(lanes);\n"),
        ("    decode(d, q.y[p], q.cb[p >> 1], q.cr[p >> 1], rgb);",
         "    if (approx) decode_approx(d, q.y[p], q.cb[p >> 1], q.cr[p >> 1], rgb);\n"
         "    else decode(d, q.y[p], q.cb[p >> 1], q.cr[p >> 1], rgb);")],
    "unpack": [("}  // namespace", PLANAR_G2L_SETTER)]}
PLANAR_DIAGNOSTICS["g2l approximation where rough, 16 block rows"] = {
    **PLANAR_DIAGNOSTICS["g2l approximation where rough"],
    "unpack": [*PLANAR_DIAGNOSTICS["g2l approximation where rough"]["unpack"],
               ("constexpr int kThreadRows = 8;", "constexpr int kThreadRows = 16;")]}
PLANAR_DIAGNOSTICS["g2l approximation where rough, 8 blocks an SM"] = {
    **PLANAR_DIAGNOSTICS["g2l approximation where rough"],
    "unpack": [*PLANAR_DIAGNOSTICS["g2l approximation where rough"]["unpack"],
               *PLANAR_DIAGNOSTICS["8 blocks an SM"]["unpack"]]}
PLANAR_TIMED_ONLY = ("no gather",)  # every other diagnostic must equal the plain version
PLANAR_OLD_PARTS = ("whole", "stores only", "no gather", "loads, trivial arithmetic")
PLANAR_OLD_HELD = (0,)
PLANAR_FORMS = ("yuv422p8", "yuv422p10le", "yuv420p", "nv12")  # the variant file's form numbers
# the planar packs: block rows and stages of phn::pack_tiles, set in
# phn_common.cuh for both sources
PACK_SOURCES = {"planar422": "planar422_pack.cu", "planar420": "planar420_pack.cu"}
PACK_VARIANTS = {  # name -> [(line of phn_common.cuh, its stand-in), ...]
    "3 stages": [("constexpr int kPackStages = 2;", "constexpr int kPackStages = 3;")],
    "16 block rows": [("constexpr int kPackRows = 32;", "constexpr int kPackRows = 16;")],
    "16 block rows, 3 stages": [("constexpr int kPackRows = 32;", "constexpr int kPackRows = 16;"),
                                ("constexpr int kPackStages = 2;", "constexpr int kPackStages = 3;")],
    "conversion instructions": [(  # u16_rte_alu by cvt.rni and a conversion back
        "  const float t = fminf(fmaxf(x, 0.0f), 65535.0f) + kMagic;\n"
        "  return U16{__float_as_int(t) - __float_as_int(kMagic), t - kMagic};",
        "  const int i = u16_rte(x);\n  return U16{i, static_cast<float>(i)};")],
    # timed only: parts taken out, their codes wrong on purpose
    "no MUFU": [("    return g.alpha * moved(pow_approx(fi, g.gamma), corr, i.i) - g.alpha_m1;",
                 "    return g.alpha * moved(fi, corr, i.i) - g.alpha_m1;")],
    "no transfer": [("    const float rp = l2g_of(rgb[0][p]);\n    const float gp = l2g_of(rgb[1][p]);\n"
                     "    const float bp = l2g_of(rgb[2][p]);",
                     "    const float rp = rgb[0][p], gp = rgb[1][p], bp = rgb[2][p];")],
    "no loads": [("    if (tile < n_tiles && pack_quad_of(tile, tiles_x, quads, height, j, row))",
                  "    if (false && tile < n_tiles && pack_quad_of(tile, tiles_x, quads, height, j, row))")],
    "no stores": [("    store(row, j, encode_quad(e, l2g_of, px, width - 4 * j, chroma_every_row || (row & 1) == 0, pad));",
                   "    const QuadCodes q = encode_quad(e, l2g_of, px, width - 4 * j, chroma_every_row || (row & 1) == 0, pad);\n"
                   "    if (q.y[0] == 0xFFFFFFFFu) store(row, j, q);")],
}
PACK_TIMED_ONLY = ("no MUFU", "no transfer", "no loads", "no stores")
PACK_OLD_PARTS = ("whole", "stores only", "no powf", "loads, trivial arithmetic")
# K2 and B5, one source: kind -> its exported function; the source's
# variants: name -> {file ("cu": the source): [(line, its stand-in), ...]}
V210_SOURCE = "combine_pack.cu"
V210_FUNCTIONS = {"k2": "phn_v210_pack", "b5": "phn_combine_pack"}
V210_VARIANTS = {
    "powf": {"phn_common.cuh": [(
        "  copy_corrections(smem, corr, threadIdx.x, blockDim.x);\n"
        "  const CorrectedL2G l2g_of{e.g, reinterpret_cast<const signed char*>(smem)};",
        "  copy_corrections(smem, corr, threadIdx.x, blockDim.x);\n"
        "  const auto l2g_of = [&](float x) { return l2g(e.g, x); };")]},
    "one 4-byte copy a pixel": {"cu": [("  if (phn::quads_aligned(L, width))", "  if (false)")]},
    "3 stages": {"phn_common.cuh": [("constexpr int kSegStages = 2;", "constexpr int kSegStages = 3;")]},
    "at most 16 warps a block": {"phn_common.cuh": [("constexpr int kMaxSegWarps = 32;",
                                                     "constexpr int kMaxSegWarps = 16;")]},
    # timed only: parts taken out, their words wrong on purpose
    "no MUFU": {"phn_common.cuh": [("    return g.alpha * moved(pow_approx(fi, g.gamma), corr, i.i) - g.alpha_m1;",
                                    "    return g.alpha * moved(fi, corr, i.i) - g.alpha_m1;")]},
    "no transfer": {"phn_common.cuh": [(
        "    const float rp = l2g_of(rgb[0][p]);\n    const float gp = l2g_of(rgb[1][p]);\n"
        "    const float bp = l2g_of(rgb[2][p]);\n    ys[p] = quad_code",
        "    const float rp = rgb[0][p], gp = rgb[1][p], bp = rgb[2][p];\n    ys[p] = quad_code")]},
    "no loads": {"phn_common.cuh": [
        ("      if (4 * i < n) cp_async16(dst + 4 * i, src + 4 * i);",
         "      if (4 * i < n && n < 0) cp_async16(dst + 4 * i, src + 4 * i);"),
        ("      if (i < n) cp_async4(dst + i, src + i);", "      if (i < n && n < 0) cp_async4(dst + i, src + i);")]},
    "no encode or stores": {"phn_common.cuh": [(  # the encode is the stored value: it goes with the store
        "      if (g < groups)\n        words[",
        "      if (g < groups && width < 0)\n        words[")]},
}
V210_TIMED_ONLY = ("no MUFU", "no transfer", "no loads", "no encode or stores")
V210_OLD_PARTS = ("whole", "stores only", "no powf", "loads, trivial arithmetic")
# the edge sweep: (width, height)
V210_EDGES = [(w, 3) for w in range(1, 14)] + [(1918, 3), (1280, 16), (200, 7)]


# The C interfaces the old mappings (tools/*_variants.cu) were written
# against: the kernels' full-frame entries before their band forms added
# the row arguments (ops/_build.py _SIGNATURES holds the current ones)
_P, _I = ctypes.c_void_p, ctypes.c_int
_FULL_FRAME_SIGNATURES = {
    "phn_warp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "phn_yadif_ring": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "phn_packed_warp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
}

def set_consts(text: str, consts: dict) -> str:
    for const, value in consts.items():
        head = f"constexpr int {const} = "
        i = text.index(head) + len(head)
        text = text[:i] + str(value) + text[text.index(";", i):]
    return text


def edited_copy(out: Path, cu: str, consts: dict, edits: dict) -> Path:
    """csrc/<cu> and phn_common.cuh written into ``out`` with the
    constants set and each (line, stand-in) of ``edits[file]`` applied."""
    out.mkdir(parents=True, exist_ok=True)
    for name in (cu, "phn_common.cuh"):
        text = (CSRC / name).read_text()
        if name == cu:
            text = set_consts(text, consts)
        for old, new in edits.get(name, ()):
            if old not in text:
                raise RuntimeError(f"kernel_variants: {name} no longer has the line {old!r}")
            text = text.replace(old, new)
        (out / name).write_text(text)
    return out / cu


def build(out: Path, sections) -> dict:
    """Every variant library of the chosen sections, one nvcc each, all at
    once: name -> path."""
    from phaneron_tpu_torch.ops import _build

    jobs = {}
    slug = lambda name: name.replace(" ", "_").replace(",", "")
    if "k1" in sections:
        jobs["k1"] = ROOT / "tools" / "k1_variants.cu"
    if "yadif" in sections:
        jobs["yadif old"] = ROOT / "tools" / "yadif_variants.cu"
    if "b3" in sections:
        jobs["b3 old"] = ROOT / "tools" / "b3_variants.cu"
    if "rotate" in sections:
        jobs["rotate old"] = ROOT / "tools" / "rotate_variants.cu"
    if "b6" in sections:
        jobs["b6 old"] = ROOT / "tools" / "b6_variants.cu"
    if "k4" in sections:
        jobs["k4 old"] = ROOT / "tools" / "warp_variants.cu"
        jobs["k4 windows"] = ROOT / "tools" / "warp_windows.cu"
    if "planar" in sections:
        jobs["planar old"] = ROOT / "tools" / "planar_variants.cu"
        for kind, cu in PLANAR_SOURCES.items():
            for name, consts in PLANAR_VARIANTS.items():
                jobs[f"{kind} {name}"] = edited_copy(out / kind / slug(name), cu, consts, {})
            for name, edits in PLANAR_DIAGNOSTICS.items():
                mine = {}
                for f, e in edits.items():
                    if f in ("unpack", cu, "phn_common.cuh"):
                        mine.setdefault(cu if f == "unpack" else f, []).extend(e)
                if mine:  # a diagnostic of the other source only is not built for this one
                    jobs[f"{kind} {name}"] = edited_copy(out / kind / slug(name), cu, {}, mine)
    if "packs" in sections:
        jobs["packs"] = ROOT / "tools" / "planar_pack_variants.cu"
        for kind, cu in PACK_SOURCES.items():
            for name, edits in PACK_VARIANTS.items():
                jobs[f"{kind} {name}"] = edited_copy(out / kind / slug(name), cu, {}, {"phn_common.cuh": edits})
    if "v210packs" in sections:
        jobs["v210packs"] = ROOT / "tools" / "v210_pack_variants.cu"
        for name, edits in V210_VARIANTS.items():
            mine = {V210_SOURCE if f == "cu" else f: e for f, e in edits.items()}
            jobs[f"v210 {name}"] = edited_copy(out / "v210" / slug(name), V210_SOURCE, {}, mine)
    for section, cu, variants, diagnostics in (
            ("k5", "packed_composite.cu", K5_VARIANTS,
             {n: {"phn_common.cuh": [e]} for n, e in K5_DIAGNOSTICS.items()}),
            ("yadif", "yadif.cu", YADIF_VARIANTS, {n: {"yadif.cu": e} for n, e in YADIF_DIAGNOSTICS.items()}),
            ("yadif ring", "yadif.cu", YADIF_RING_VARIANTS,
             {n: {"yadif.cu": e} for n, e in YADIF_RING_DIAGNOSTICS.items()}),
            ("rgb3", "packed_composite.cu", RGB3_VARIANTS, RGB3_DIAGNOSTICS),
            ("b3", "fused_v210.cu", B3_VARIANTS, B3_DIAGNOSTICS),
            ("rotate", "rotate.cu", ROTATE_VARIANTS, ROTATE_DIAGNOSTICS),
            ("b6", "packed_warp.cu", B6_VARIANTS, B6_DIAGNOSTICS),
            ("k4", "warp.cu", K4_VARIANTS, {})):
        if section.split()[0] not in sections:
            continue
        for name, consts in variants.items():
            jobs[f"{section} {name}"] = edited_copy(out / slug(section) / slug(name), cu, consts, {})
        for name, edits in diagnostics.items():
            jobs[f"{section} {name}"] = edited_copy(out / slug(section) / slug(name), cu, {}, edits)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.nvcc_flags(), "-shared", "-o", str(cu.with_suffix(".so")),
                                     str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, cu in jobs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in cs.ptxas_lines(log):
            print(f"  ptxas {name}: {line}")
    return {name: cu.with_suffix(".so") for name, cu in jobs.items()}


class Lib:
    """A variant library in the shape a wrapper calls: its one exported
    function, bound as ops/_build.py binds the built library's."""

    def __init__(self, path: Path, fn_name: str):
        from phaneron_tpu_torch.ops import _build

        fn = getattr(ctypes.CDLL(str(path)), fn_name)
        fn.argtypes = list(_build._SIGNATURES[fn_name])
        fn.restype = ctypes.c_int
        setattr(self, fn_name, fn)


def timed(torch, module, libs: dict, call, check) -> dict:
    """name -> device ms of call() with module.library swapped for each
    library in turn (the built source first and last, the better of the
    two kept); check(name) runs the variant once and returns False if it
    disagrees."""
    from phaneron_tpu_torch.ops import _build

    times, bad = {}, []
    try:
        for name, lib in list(libs.items()) + [("built", libs["built"])]:
            module.library = lambda lib=lib: lib
            if not check(name):
                bad.append(name)
            ms = cs.device_ms(torch, call, batches=5, calls=5)
            print(f"  {name}: {ms:.4f} ms", flush=True)
            times[name] = min(ms, times.get(name, ms))
    finally:
        module.library = _build.library
    return times, bad


def section_k1(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import v210

    W, H, bad = cs.W, cs.H, []
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
            for part, part_name in enumerate(("whole", "stores only", "decode only", "no gather")):
                call = lambda: k1.k1_variant(mapping, part, words.data_ptr(), out.data_ptr(), W, H, groups, coeffs,
                                             g2l, torch.cuda.current_stream(dev).cuda_stream)
                if part == 0:
                    out.zero_()
                    call()
                    if not torch.equal(out, plain):
                        bad.append(f"K1 {mapping_name} on {content}")
                times.append(f"{part_name} {cs.device_ms(torch, call, calls=20):.4f}")
            print(f"K1 1920x1080, 3 channels, {content}, {mapping_name} on {card}: ms " + "; ".join(times))
    return bad


def section_k5(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.formats import v210

    cases, bad = {}, []
    for w, h in ((cs.UHD_W, cs.UHD_H), (cs.W, cs.H)):
        _, params = cs.progressive_spec_params(torch, dev, rng, w, h)
        lps = params["layers"]
        args = ([s for lp in lps for s in (lp["src"][0], lp["src_b"][0])], (2, 2, 2, 2),
                [lp["matrix"] for lp in lps], [lp["mix"] for lp in lps])
        ramps = [to_tensor(np.roll(v210.fill_buf(w, h)[0], 4 * 11 * (k + 1), axis=1), dev) for k in range(8)]
        cases[f"{w}x{h}, ramps and random words"] = (args, (w, h))
        cases[f"{w}x{h}, ramps"] = ((ramps, *args[1:]), (w, h))
    k5 = {"built": _build.library(), **{n: Lib(libs[f"k5 {n}"], "phn_packed_composite")
                                        for n in (*K5_VARIANTS, *K5_DIAGNOSTICS)}}
    for label, (args, size) in cases.items():
        kw = dict(src_kind="packed", size=size, emit="both", alpha="top")
        want = PW.packed_composite_plain(*args, **kw)

        def check(name):
            got = PW.packed_composite(*args, **kw)
            return name in K5_DIAGNOSTICS or not (cs.code_delta(torch, got[0], want[0], *size)
                                                  or not torch.equal(got[1], want[1]))

        times, wrong = timed(torch, PW, k5, lambda: PW.packed_composite(*args, src_kind="packed", size=size), check)
        bad += [f"K5 {n} at {label}" for n in wrong]
        print(f"K5 v210 words, 4 dissolve layers, {label} on {card}: ms "
              + "; ".join(f"{n} {t:.4f}" for n, t in times.items()))
    return bad


def section_yadif(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import yadif as Y

    W, H, bad = cs.W, cs.H, []
    ring = [torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev) for _ in range(3)]
    # the old mapping's parts
    old = ctypes.CDLL(str(libs["yadif old"])).yadif_old_pair
    old.argtypes = [ctypes.c_int] + list(_build._SIGNATURES["phn_yadif_pair"])
    out0, out1 = torch.empty_like(ring[0]), torch.empty_like(ring[0])
    want = Y.yadif_pair_plain(*ring, cs.TFF)
    times = []
    for part, part_name in enumerate(YADIF_OLD_PARTS):
        call = lambda: old(part, *(f.data_ptr() for f in ring), out0.data_ptr(), out1.data_ptr(), 3, H, W,
                           int(cs.TFF), 0, 0, torch.cuda.current_stream(dev).cuda_stream)
        if part == 0:
            out0.zero_()
            out1.zero_()
            call()
            if not (torch.equal(out0, want[0]) and torch.equal(out1, want[1])):
                bad.append("yadif_pair old mapping")
        times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
    print(f"yadif_pair 3 ch 1920x1080, old mapping (one thread a pixel, clamped gathers) on {card}: ms "
          + "; ".join(times))
    # the new mapping: tile shapes and parts taken out
    lib = {"built": _build.library(), **{n: Lib(libs[f"yadif {n}"], "phn_yadif_pair")
                                         for n in (*YADIF_VARIANTS, *YADIF_DIAGNOSTICS)}}
    odd = [torch.from_numpy(rng.random((4, 1081, 1918), dtype=np.float32)).to(dev) for _ in range(3)]
    for f in odd:
        f[3] = 1.0

    def check(name):
        if name in YADIF_DIAGNOSTICS:
            return True
        for frames, tff, kw in ((ring, cs.TFF, {}), (ring, not cs.TFF, dict(skip_spatial=True)),
                                (odd, cs.TFF, {}), (odd, not cs.TFF, dict(opaque=True))):
            got, exp = Y.yadif_pair(*frames, tff, **kw), Y.yadif_pair_plain(*frames, tff, **kw)
            if not all(torch.equal(g, e) for g, e in zip(got, exp)):
                return False
        return True

    times, wrong = timed(torch, Y, lib, lambda: Y.yadif_pair(*ring, cs.TFF), check)
    bad += [f"yadif_pair {n}" for n in wrong]
    print(f"yadif_pair 3 ch 1920x1080, new mapping (staged tiles) on {card}: ms "
          + "; ".join(f"{n} {t:.4f}" for n, t in times.items()))

    # the ring kernel at parity 1 (in device memory): its old mapping's parts
    par = torch.tensor(1, dtype=torch.int32, device=dev)
    old = ctypes.CDLL(str(libs["yadif old"])).yadif_old_ring
    old.argtypes = [ctypes.c_int] + list(_FULL_FRAME_SIGNATURES["phn_yadif_ring"])
    want = Y.yadif_ring_plain(*ring, 1, cs.TFF)
    times = []
    for part, part_name in enumerate(YADIF_OLD_PARTS):
        call = lambda: old(part, *(f.data_ptr() for f in ring), par.data_ptr(), out0.data_ptr(), 3, H, W,
                           int(cs.TFF), 0, 0, torch.cuda.current_stream(dev).cuda_stream)
        if part == 0:
            out0.zero_()
            call()
            if not torch.equal(out0, want):
                bad.append("yadif_ring old mapping")
        times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
    print(f"yadif_ring 3 ch 1920x1080, old mapping (one thread a pixel, clamped gathers) on {card}: ms "
          + "; ".join(times))
    # the new mapping: tile shapes and parts taken out
    lib = {"built": _build.library(), **{n: Lib(libs[f"yadif ring {n}"], "phn_yadif_ring")
                                         for n in (*YADIF_RING_VARIANTS, *YADIF_RING_DIAGNOSTICS)}}
    small = [[torch.from_numpy(rng.random((c, h, w), dtype=np.float32)).to(dev) for _ in range(3)]
             for c, h, w in ((3, 33, 65), (4, 31, 63))]

    def check_ring(name):
        if name in YADIF_RING_DIAGNOSTICS:
            return True
        for frames, tff, kw in ((ring, cs.TFF, {}), (ring, not cs.TFF, dict(skip_spatial=True)),
                                (odd, cs.TFF, {}), (odd, not cs.TFF, dict(opaque=True)),
                                (small[0], cs.TFF, {}), (small[1], not cs.TFF, {})):
            for parity in (0, 1):
                p = torch.tensor(parity, dtype=torch.int32, device=dev)
                if not torch.equal(Y.yadif_ring(*frames, p, tff, **kw), Y.yadif_ring_plain(*frames, parity, tff, **kw)):
                    return False
        return True

    times, wrong = timed(torch, Y, lib, lambda: Y.yadif_ring(*ring, par, cs.TFF), check_ring)
    bad += [f"yadif_ring {n}" for n in wrong]
    print(f"yadif_ring 3 ch 1920x1080, new mapping (staged tiles, one parity) on {card}: ms "
          + "; ".join(f"{n} {t:.4f}" for n, t in times.items()))
    return bad


def section_rgb3(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    W, H = cs.W, cs.H
    srcs = [torch.from_numpy(rng.random((3, H, W), dtype=np.float32)).to(dev) for _ in range(8)]
    mats = [to_tensor(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i), dev)
            for i in range(4)]
    mixes = [torch.tensor(0.2 + 0.15 * i, device=dev) for i in range(4)]
    args = (srcs, (2, 2, 2, 2), mats, mixes)
    want = PW.packed_composite_plain(*args, emit="both")
    lib = {"built": _build.library(), **{n: Lib(libs[f"rgb3 {n}"], "phn_packed_composite")
                                         for n in (*RGB3_VARIANTS, *RGB3_DIAGNOSTICS)}}

    def check(name):
        if name in RGB3_DIAGNOSTICS and name not in HELD_RGB3:
            return True
        got = PW.packed_composite(*args, emit="both")
        return cs.code_delta(torch, got[0], want[0], W, H) == 0 and torch.equal(got[1], want[1])

    times, bad = timed(torch, PW, lib, lambda: PW.packed_composite(*args), check)
    print(f"K5 rgb3, 4 dissolve layers, 8 sources, 1920x1080 (the interlaced tick) on {card}: ms "
          + "; ".join(f"{n} {t:.4f}" for n, t in times.items()))
    return [f"K5 rgb3 {n}" for n in bad]


def section_b3(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import v210

    variants = ctypes.CDLL(str(libs["b3 old"]))
    old = variants.b3_variant
    old.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
    variants.b3_l2g_table.argtypes = [ctypes.c_void_p] * 3
    lut = torch.empty(65536, dtype=torch.float32, device=dev)
    variants.b3_l2g_table(lut.data_ptr(), ctypes.addressof(K._encode_coeffs("709")),
                          torch.cuda.current_stream(dev).cuda_stream)
    corr = K.fused_v210_corrections_on("709", "709", dev)
    g2l_consts = ctypes.addressof(K._g2l_consts("709"))
    for name, c in (("linear->gamma'", corr.view(2, 65536)[0]), ("gamma'->linear", corr.view(2, 65536)[1])):
        print(f"{name} corrections (709): largest |difference| {int(c.abs().max())} ulp, at "
              f"{int((c != 0).sum())} of 65536 indices")
    lib = {"built": _build.library(), **{n: Lib(libs[f"b3 {n}"], "phn_fused_v210")
                                         for n in (*B3_VARIANTS, *B3_DIAGNOSTICS)}}
    mix, bad = torch.tensor([0.5], device=dev), []
    for w, h in ((cs.UHD_W, cs.UHD_H), (cs.W, cs.H)):
        ramp = v210.fill_buf(w, h)[0]
        rolled = [to_tensor(np.roll(ramp, 4 * 11 * (k + 1), axis=1), dev) for k in range(2)]
        for content, (xa, xb) in (("the fill_buf ramp into random words (the record)",
                                   (to_tensor(ramp, dev), to_tensor(cs.random_words(rng, w, h), dev))),
                                  ("two rolled ramps", rolled)):
            args = (xa, w, h, xb, mix)
            want = K.fused_v210_plain(*args)
            coeffs, g2l = K.v210_decode_args("709", "709", dev)
            enc = ctypes.addressof(K._encode_coeffs("709"))
            out = torch.empty_like(want)
            times = []
            for part, part_name in enumerate(B3_PARTS):
                call = lambda: old(part, xa.data_ptr(), xb.data_ptr(), mix.data_ptr(), out.data_ptr(), w, h,
                                   v210.pitch(w) // 6, coeffs, g2l, enc, lut.data_ptr(), g2l_consts, corr.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
                if part in B3_PARTS_HELD:
                    out.zero_()
                    rc = call()
                    if rc or cs.code_delta(torch, out, want, w, h) > cs.TOL_CODES:
                        bad.append(f"B3 {part_name}, {w}x{h}, {content} (rc {rc})")
                times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
            print(f"fused_v210 dissolve {w}x{h}, {content}, tools/b3_variants.cu on {card}: ms " + "; ".join(times))

            def check(name):
                return (name in B3_DIAGNOSTICS and name not in HELD_B3) or \
                    cs.code_delta(torch, K.fused_v210(*args), want, w, h) <= cs.TOL_CODES

            new, wrong = timed(torch, K, lib, lambda: K.fused_v210(*args), check)
            bad += [f"B3 {n}, {w}x{h}, {content}" for n in wrong]
            print(f"fused_v210 dissolve {w}x{h}, {content}, csrc/fused_v210.cu on {card}: ms "
                  + "; ".join(f"{n} {t:.4f}" for n, t in new.items()))
    return bad


def section_rotate(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import rotate as R
    from phaneron_tpu_torch.ops import warp as warp_mod

    old = ctypes.CDLL(str(libs["rotate old"])).rotate_old_mapping
    old.argtypes = [ctypes.c_int] + list(_FULL_FRAME_SIGNATURES["phn_warp"])
    lib = {"built": _build.library(), **{n: Lib(libs[f"rotate {n}"], "phn_rotate")
                                         for n in (*ROTATE_VARIANTS, *ROTATE_DIAGNOSTICS)}}
    frame = lambda w, h: torch.from_numpy(rng.random((4, h, w), dtype=np.float32)).to(dev)
    uhd = frame(cs.UHD_W, cs.UHD_H)
    cases = {f"RGBA cut at {deg} degrees, scale 0.9, 3840x2160":
             (uhd, to_tensor(cs.rotation_matrix(cs.UHD_W, cs.UHD_H, deg), dev)) for deg in (0, 45, 100, 180)}
    cases["RGBA dissolve pair, two matrices, 100 and 95 degrees, 1920x1080"] = (
        frame(cs.W, cs.H), to_tensor(cs.rotation_matrix(cs.W, cs.H, 100), dev), frame(cs.W, cs.H),
        torch.tensor([0.35], device=dev), to_tensor(cs.rotation_matrix(cs.W, cs.H, 95, 0.85), dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    bad = []
    for label, args in cases.items():
        a, m, b, mix, mb = (*args, None, None, None)[:5]
        c, h, w = a.shape
        want = R.rotate_plain(*args)
        same = lambda got: float((got - want).abs().max()) == 0.0
        out = torch.empty_like(want)
        times = []
        for part, part_name in enumerate(ROTATE_OLD_PARTS):
            call = lambda: old(part, a.data_ptr(), ptr(b), m.data_ptr(), ptr(mb), ptr(mix), None, out.data_ptr(),
                               c, h, w, torch.cuda.current_stream(dev).cuda_stream)
            if part in ROTATE_OLD_HELD:
                out.zero_()
                call()
                if not same(out):
                    bad.append(f"rotate old mapping {part_name}, {label}")
            times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
        print(f"rotate {label}, old mapping (a thread a pixel, direct gathers) on {card}: ms " + "; ".join(times))

        def check(name):
            return (name in ROTATE_DIAGNOSTICS and name not in HELD_ROTATE) or same(R.rotate(*args))

        new, wrong = timed(torch, warp_mod, lib, lambda: R.rotate(*args), check)
        bad += [f"rotate {n}, {label}" for n in wrong]
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        R.rotate(*args, branches=counts)
        print(f"rotate {label}, new mapping (shared-memory windows) on {card}: ms "
              + "; ".join(f"{n} {t:.4f}" for n, t in new.items())
              + f"; window/direct (tile, source) pairs of the built source {counts.tolist()}")
    return bad


def section_b6(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops import packed_warp as PW
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    W, H = cs.W, cs.H
    old = ctypes.CDLL(str(libs["b6 old"])).b6_old_mapping
    old.argtypes = [ctypes.c_int] + list(_FULL_FRAME_SIGNATURES["phn_packed_warp"][:-2]) + [ctypes.c_void_p]
    lib = {"built": _build.library(), **{n: Lib(libs[f"b6 {n}"], "phn_packed_warp")
                                         for n in (*B6_VARIANTS, *B6_DIAGNOSTICS)}}
    setter = ctypes.CDLL(str(libs["b6 g2l approximation"])).b6_set_g2l
    setter.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    corr = K.fused_v210_corrections_on("709", "709", dev)
    torch.cuda.synchronize()
    if setter(corr[65536:].data_ptr(), ctypes.addressof(K._g2l_consts("709"))):
        raise RuntimeError("b6_set_g2l failed")
    a, b = to_tensor(v210.fill_buf(W, H)[0], dev), to_tensor(cs.random_words(rng, W, H), dev)
    m = to_tensor(transform_matrix(W, H, scale_x=0.95, scale_y=0.95, offset_x=0.025), dev)
    mb = to_tensor(transform_matrix(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05), dev)
    mix = torch.tensor([0.5], device=dev)
    cases = {"entry shape: shared-matrix pair, scale 0.95, ramp and random words (the record)": (a, m, W, H, b, mix),
             "distinct-matrix pair (0.95 and 0.8 x 0.85)": (a, m, W, H, b, mix, mb),
             "single, random words": (b, m, W, H)}
    coeffs, g2l = K.v210_decode_args("709", "709", dev)
    groups = v210.pitch(W) // 6
    ptr = lambda t: None if t is None else t.data_ptr()
    bad = []
    for label, args in cases.items():
        want = PW.packed_warp_plain(*args)
        same = lambda got: float((got - want).abs().max()) == 0.0
        wa, wm, _, _, wb, wmix, wmb = (*args, None, None, None)[:7]
        wmb = wm if wb is not None and wmb is None else wmb
        out = torch.empty_like(want)
        times = []
        for part, part_name in enumerate(B6_OLD_PARTS):
            call = lambda: old(part, wa.data_ptr(), ptr(wb), wm.data_ptr(), ptr(wmb), ptr(wmix), out.data_ptr(), W, H,
                               groups, coeffs, g2l, torch.cuda.current_stream(dev).cuda_stream)
            if part in B6_OLD_HELD:
                out.zero_()
                call()
                if not same(out):
                    bad.append(f"B6 old mapping {part_name}, {label}")
            times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
        print(f"packed_warp {label}, old mapping (a thread a pixel, a decode a tap) on {card}: ms " + "; ".join(times))

        def check(name):
            return (name in B6_DIAGNOSTICS and name not in HELD_B6) or same(PW.packed_warp(*args))

        new, wrong = timed(torch, PW, lib, lambda: PW.packed_warp(*args), check)
        bad += [f"B6 {n}, {label}" for n in wrong]
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        PW.packed_warp(*args, branches=counts)
        print(f"packed_warp {label}, new mapping (decoded windows) on {card}: ms "
              + "; ".join(f"{n} {t:.4f}" for n, t in new.items())
              + f"; window/direct (tile, source) pairs of the built source {counts.tolist()}")
    return bad


def section_k4(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import warp as warp_mod
    from phaneron_tpu_torch.ops.geometry import transform_matrix

    old = ctypes.CDLL(str(libs["k4 old"])).warp_old_mapping
    old.argtypes = [ctypes.c_int] + list(_FULL_FRAME_SIGNATURES["phn_warp"][:-2]) + [ctypes.c_void_p]
    windows = ctypes.CDLL(str(libs["k4 windows"])).warp_windows
    windows.argtypes = list(_FULL_FRAME_SIGNATURES["phn_warp"][:-1]) + [ctypes.c_void_p, ctypes.c_void_p]
    lib = {"built": _build.library(), **{n: Lib(libs[f"k4 {n}"], "phn_warp") for n in K4_VARIANTS}}
    frame = lambda c, w, h: torch.from_numpy(rng.random((c, h, w), dtype=np.float32)).to(dev)
    mat = lambda w, h, **kw: to_tensor(transform_matrix(w, h, **kw), dev)
    W, H, UW, UH = cs.W, cs.H, cs.UHD_W, cs.UHD_H
    a3, b3, a4, b4 = frame(3, W, H), frame(3, W, H), frame(4, W, H), frame(4, W, H)
    mask = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    ua, ub = frame(4, UW, UH), frame(4, UW, UH)
    umask = torch.from_numpy(rng.random((UH, UW), dtype=np.float32)).to(dev)
    m9 = mat(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.05)
    mix = torch.tensor([0.45], device=dev)
    cases = {
        "3-channel dissolve pair, scale 0.9, 1920x1080 (the record)": (
            (a3, mat(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02), b3, mix), {}),
        "4-channel dissolve pair, 1920x1080": ((a4, mat(W, H, scale_x=0.9, offset_x=0.05), b4, mix), {}),
        "4-channel wipe pair, one matrix, 1920x1080": ((a4, m9, b4), dict(mask=mask)),
        "4-channel dissolve pair, two matrices, 1920x1080": (
            (a4, m9, b4, mix, mat(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05)), {}),
        "4-channel single, scale 0.95, 1920x1080 (the keyed frame's graphic)": (
            (a4, mat(W, H, scale_x=0.95, scale_y=0.95)), {}),
        "4-channel picture in picture, scale 0.5, dissolve, 1920x1080 (media path)": (
            (a4, mat(W, H, **cs.MEDIA_DVE), b4, mix), {}),
        "4-channel wipe pair, one matrix, 3840x2160 (wipe path)": (
            (ua, mat(UW, UH, scale_x=0.9, scale_y=0.9, offset_x=0.05), ub), dict(mask=umask)),
    }
    ptr = lambda t: None if t is None else t.data_ptr()
    bad = []
    for label, (args, kw) in cases.items():
        want = warp_mod.warp_plain(*args, **kw)
        same = lambda got: float((got - want).abs().max()) == 0.0
        a, m, b, mx, mb = (*args, None, None, None)[:5]
        c, h, w = a.shape
        out = torch.empty_like(want)
        times = []
        for part, part_name in enumerate(K4_OLD_PARTS):
            call = lambda: old(part, a.data_ptr(), ptr(b), m.data_ptr(), ptr(mb), ptr(mx), ptr(kw.get("mask")),
                               out.data_ptr(), c, h, w, torch.cuda.current_stream(dev).cuda_stream)
            if part in K4_OLD_HELD:
                out.zero_()
                call()
                if not same(out):
                    bad.append(f"K4 old mapping {part_name}, {label}")
            times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
        print(f"warp {label}, old mapping (a thread a pixel) on {card}: ms " + "; ".join(times))

        # the windowed design, held and timed before and after the built
        # kernel and its variants (the better of the two kept)
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        call = lambda br: windows(a.data_ptr(), ptr(b), m.data_ptr(), ptr(mb), ptr(mx), ptr(kw.get("mask")),
                                  out.data_ptr(), c, h, w, ptr(br), torch.cuda.current_stream(dev).cuda_stream)
        out.zero_()
        if call(counts):
            raise RuntimeError("warp_windows failed to launch")
        if not same(out):
            bad.append(f"K4 windowed design, {label}")
        win_ms = cs.device_ms(torch, lambda: call(None), batches=5, calls=5)
        new, wrong = timed(torch, warp_mod, lib, lambda: warp_mod.warp(*args, **kw),
                           lambda name: same(warp_mod.warp(*args, **kw)))
        bad += [f"K4 {n}, {label}" for n in wrong]
        win_ms = min(win_ms, cs.device_ms(torch, lambda: call(None), batches=5, calls=5))
        gs = cs.grid_sample_args(torch, [a] + ([b] if b is not None else []), m)
        gs_ms = cs.device_ms(torch, lambda: torch.nn.functional.grid_sample(
            *gs, mode="bilinear", padding_mode="zeros", align_corners=False))
        print(f"warp {label}, built (a thread a pixel, channels and mode constants) on {card}: ms "
              + "; ".join(f"{n} {t:.4f}" for n, t in new.items())
              + f"; windowed design {win_ms:.4f}, its window/direct (tile, source) pairs {counts.tolist()}"
              f"; grid_sample {gs_ms:.4f} (matrix a, no mix)")
    return bad


def section_planar(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import get_format

    fns = {"planar422": "phn_planar422_unpack", "planar420": "phn_planar420_unpack"}
    variant_args = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    old = ctypes.CDLL(str(libs["planar old"]))
    old.planar_old_mapping.argtypes = [ctypes.c_int] + variant_args
    old.planar_pixel_mapping.argtypes = variant_args
    lib = {kind: {"built": _build.library(), **{n: Lib(libs[f"{kind} {n}"], fn)
                                                for n in (*PLANAR_VARIANTS, *PLANAR_DIAGNOSTICS)
                                                if f"{kind} {n}" in libs}}
           for kind, fn in fns.items()}
    corr = K.fused_v210_corrections_on("709", "709", dev)
    torch.cuda.synchronize()
    for kind in fns:
        for name in ("g2l approximation", "g2l approximation where rough",
                     "g2l approximation where rough, 16 block rows", "g2l approximation where rough, 8 blocks an SM"):
            setter = ctypes.CDLL(str(libs[f"{kind} {name}"])).planar_set_g2l
            setter.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            if setter(corr[65536:].data_ptr(), ctypes.addressof(K._g2l_consts("709"))):
                raise RuntimeError(f"planar_set_g2l failed ({kind}, {name})")
    ptr = lambda t: None if t is None else t.data_ptr()
    bad = []
    for w, h in ((cs.W, cs.H), (cs.UHD_W, cs.UHD_H)):
        for form, fmt_name in enumerate(PLANAR_FORMS):
            kind = "planar420" if form >= 2 else "planar422"
            unpack = K.planar420_unpack if form >= 2 else K.planar422_unpack
            plain = K.planar420_unpack_plain if form >= 2 else K.planar422_unpack_plain
            fmt = get_format(fmt_name)
            p = fmt.pitch(w)
            cp = p if fmt_name == "nv12" else p // 2
            coeffs, g2l = K.decode_args(fmt_name, "709", "709", dev)
            for content, planes in (("random planes", cs.format_planes(rng, fmt_name, w, h)),
                                    ("the fill_buf ramp", fmt.fill_buf(w, h))):
                pt = [to_tensor(x, dev) for x in planes]
                y, c0, c1 = (*pt, None)[:3]
                want = plain(pt, w, h, fmt_name=fmt_name)
                same = lambda got: float((got - want).abs().max()) == 0.0
                out = torch.empty_like(want)
                label = f"{fmt_name} {w}x{h}, {content}"
                stream = lambda: torch.cuda.current_stream(dev).cuda_stream
                times = []
                for part, part_name in enumerate(PLANAR_OLD_PARTS):
                    call = lambda: old.planar_old_mapping(part, form, y.data_ptr(), c0.data_ptr(), ptr(c1),
                                                          out.data_ptr(), w, h, p, cp, coeffs, g2l, stream())
                    if part in PLANAR_OLD_HELD:
                        out.zero_()
                        call()
                        if not same(out):
                            bad.append(f"planar old mapping {part_name}, {label}")
                    times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
                call = lambda: old.planar_pixel_mapping(form, y.data_ptr(), c0.data_ptr(), ptr(c1), out.data_ptr(),
                                                        w, h, p, cp, coeffs, g2l, stream())
                out.zero_()
                call()
                if not same(out):
                    bad.append(f"planar pixel mapping, {label}")
                times.append(f"a thread a pixel {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
                print(f"planar unpack {label}, old mapping (a thread a pixel pair) on {card}: ms " + "; ".join(times))

                def check(name):
                    return name in PLANAR_TIMED_ONLY or same(
                        unpack(pt, w, h, fmt_name=fmt_name))

                new, wrong = timed(torch, K, lib[kind], lambda: unpack(pt, w, h, fmt_name=fmt_name), check)
                bad += [f"{kind} {n}, {label}" for n in wrong]
                print(f"planar unpack {label}, new mapping (a thread a quad) on {card}: ms "
                      + "; ".join(f"{n} {t:.4f}" for n, t in new.items()))
    return bad


def section_packs(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.graph.convert import to_tensor
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import get_format

    var = ctypes.CDLL(str(libs["packs"]))
    var.pack_old_mapping.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 2
    var.pack_quad.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    var.pack_quad_name.argtypes, var.pack_quad_name.restype = [ctypes.c_int], ctypes.c_char_p
    var.pack_l2g_table.argtypes = [ctypes.c_void_p] * 3
    names = []
    while (name := var.pack_quad_name(len(names))) is not None:
        names.append(name.decode())
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    corr = K.l2g_corrections_on("709", dev)
    lut = torch.empty(65536, dtype=torch.float32, device=dev)
    var.pack_l2g_table(lut.data_ptr(), ctypes.addressof(K._encode_coeffs("709")), stream())
    print(f"l2g corrections (709): largest |difference| {int(corr.abs().max())} ulp, at {int((corr != 0).sum())} "
          "of 65536 indices")
    fns = {"planar422": "phn_planar422_pack", "planar420": "phn_planar420_pack"}
    lib = {kind: {"built": _build.library(), **{n: Lib(libs[f"{kind} {n}"], fn) for n in PACK_VARIANTS}}
           for kind, fn in fns.items()}
    ptr = lambda x: None if x is None else x.data_ptr()
    bad = []
    for w, h in ((cs.W, cs.H), (cs.UHD_W, cs.UHD_H)):
        media = cs.media_frame(torch, dev, w, h)
        for form, fmt_name in enumerate(PLANAR_FORMS):
            kind = "planar420" if form >= 2 else "planar422"
            pack = K.planar420_pack if form >= 2 else K.planar422_pack
            unpack = K.planar420_unpack if form >= 2 else K.planar422_unpack
            fmt = get_format(fmt_name)
            p = fmt.pitch(w)
            cp = p if fmt_name == "nv12" else p // 2
            coeffs = ctypes.addressof(K._encode_coeffs("709", fmt_name))
            black = fmt.INFO.luma_black
            ramp = unpack([to_tensor(x, dev) for x in fmt.fill_buf(w, h)], w, h, fmt_name=fmt_name)
            rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, w)).astype(np.float32)).to(dev)
            for content, rgb in (("random RGBA", rand), ("the decoded fill_buf ramp", ramp),
                                 ("the media frame", media)):
                want = pack(rgb, fmt_name)
                outs = [torch.empty_like(x) for x in want]
                y, c0, c1 = (*outs, None)[:3]
                label = f"{fmt_name} {w}x{h}, {content}"

                def ran(call, what) -> bool:
                    """call() on poisoned planes: every sample must come out as the built kernel's."""
                    for o, x in zip(outs, want):
                        o.copy_((x.to(torch.int32) ^ 1).to(o.dtype))
                    rc = call()
                    torch.cuda.synchronize()
                    if rc or cs.plane_delta(torch, outs, want):
                        bad.append(f"{what}, {label} (rc {rc})")
                        return False
                    return True

                times = []
                for part, part_name in enumerate(PACK_OLD_PARTS):
                    call = lambda: var.pack_old_mapping(part, form, rgb.data_ptr(), y.data_ptr(), c0.data_ptr(),
                                                        ptr(c1), w, h, p, cp, black, coeffs, stream())
                    if part == 0:
                        ran(call, "pack old mapping")
                    times.append(f"{part_name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
                print(f"planar pack {label}, old mapping (a thread a pixel pair) on {card}: ms " + "; ".join(times),
                      flush=True)
                times = []
                for v, name in enumerate(names):
                    if form < 2 and name.startswith("quad a row"):
                        continue
                    call = lambda: var.pack_quad(v, form, rgb.data_ptr(), y.data_ptr(), c0.data_ptr(), ptr(c1), w, h,
                                                 p, cp, black, coeffs, corr.data_ptr(), lut.data_ptr(), stream())
                    if ran(call, f"pack {name}"):
                        times.append(f"{name} {cs.device_ms(torch, call, batches=5, calls=10):.4f}")
                print(f"planar pack {label}, tools/planar_pack_variants.cu on {card}: ms " + "; ".join(times),
                      flush=True)

                def check(name):
                    return name in PACK_TIMED_ONLY or cs.plane_delta(torch, pack(rgb, fmt_name), want) == 0

                new, wrong = timed(torch, K, lib[kind], lambda: pack(rgb, fmt_name), check)
                bad += [f"{kind} {n}, {label}" for n in wrong]
                print(f"planar pack {label}, csrc/{PACK_SOURCES[kind]} on {card}: ms "
                      + "; ".join(f"{n} {t:.4f}" for n, t in new.items()), flush=True)
    return bad


def section_v210packs(torch, dev, rng, libs, card) -> list:
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import kernels as K
    from phaneron_tpu_torch.ops.formats import v210
    from phaneron_tpu_torch.ops.geometry import transform_matrix
    from phaneron_tpu_torch.ops.warp import warp_alpha_vectors

    var = ctypes.CDLL(str(libs["v210packs"]))
    layer_args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    var.v210_old.argtypes = [ctypes.c_int] * 2 + layer_args + [ctypes.c_void_p] * 2
    var.v210_mapping.argtypes = [ctypes.c_int] + layer_args + [ctypes.c_void_p] * 3
    var.v210_mapping_name.argtypes, var.v210_mapping_name.restype = [ctypes.c_int], ctypes.c_char_p
    names = []
    while (name := var.v210_mapping_name(len(names))) is not None:
        names.append(name.decode())
    corr = K.l2g_corrections_on("709", dev)
    coeffs = ctypes.addressof(K._encode_coeffs("709"))
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    lib = {kind: {"built": _build.library(), **{n: Lib(libs[f"v210 {n}"], fn) for n in V210_VARIANTS}}
           for kind, fn in V210_FUNCTIONS.items()}

    def c_layers(kind, x):
        """The layer arrays of phn_combine_pack for a K2 frame or B5 stack
        (kept alive by the caller)."""
        layers = [x] if kind == "k2" else list(x)
        n = len(layers)
        frame = lambda f: f[0] if isinstance(f, tuple) else f
        arrs = ((ctypes.c_void_p * n)(*(frame(f).data_ptr() for f in layers)),
                (ctypes.c_int * n)(*(frame(f).shape[0] for f in layers)),
                (ctypes.c_void_p * n)(*(f[1].data_ptr() if isinstance(f, tuple) else None for f in layers)),
                (ctypes.c_void_p * n)(*(f[2].data_ptr() if isinstance(f, tuple) else None for f in layers)))
        return arrs, n

    def shape_of(kind, x):
        f = x if kind == "k2" else (x[0][0] if isinstance(x[0], tuple) else x[0])
        return f.shape[2], f.shape[1]

    def run(kind, x):
        """The case's calls: (old kernel part p), (mapping v), the built wrapper, and its words."""
        w, h = shape_of(kind, x)
        groups = v210.pitch(w) // 6
        arrs, n = c_layers(kind, x)
        out = torch.empty((h, groups * 4), dtype=torch.int32, device=dev)
        ptrs = [ctypes.addressof(a) for a in arrs]
        old = lambda part: var.v210_old(0 if kind == "k2" else 1, part, *ptrs, n, out.data_ptr(), w, h, groups,
                                        coeffs, stream())
        mapping = lambda v: var.v210_mapping(v, *ptrs, n, out.data_ptr(), w, h, groups, coeffs, corr.data_ptr(),
                                             stream())
        built = (lambda: K.v210_pack(x)) if kind == "k2" else (lambda: K.combine_pack(x))
        return arrs, out, old, mapping, built

    def words_of(call, out):
        """call()'s words on a poisoned output (every word all ones first)."""
        out.fill_(-1)
        rc = call()
        torch.cuda.synchronize()
        return None if rc else out.clone()

    bad = []
    cases = cs.v210_pack_inputs(torch, dev)
    for label, (kind, x) in cases.items():
        keep, out, old, mapping, built = run(kind, x)
        want = words_of(lambda: old(0), out)
        if want is None:
            bad.append(f"{kind} old kernel failed, {label}")
            continue
        times = []
        for part, part_name in enumerate(V210_OLD_PARTS):
            times.append(f"{part_name} {cs.device_ms(torch, lambda: old(part), batches=5, calls=10):.4f}")
        print(f"{kind} {label}, the kernel before its redesign on {card}: ms " + "; ".join(times), flush=True)
        times = []
        for v, name in enumerate(names):
            got = words_of(lambda: mapping(v), out)
            if got is None or not torch.equal(got, want):
                bad.append(f"{kind} {name}, {label}")
                continue
            times.append(f"{name} {cs.device_ms(torch, lambda: mapping(v), batches=5, calls=10):.4f}")
        print(f"{kind} {label}, tools/v210_pack_variants.cu on {card}: ms " + "; ".join(times), flush=True)
        check = lambda name: name in V210_TIMED_ONLY or torch.equal(built(), want)
        new, wrong = timed(torch, K, lib[kind], built, check)
        bad += [f"{kind} {n}, {label}" for n in wrong]
        print(f"{kind} {label}, csrc/{V210_SOURCE} on {card}: ms "
              + "; ".join(f"{n} {t:.4f}" for n, t in new.items()), flush=True)
    # the edge sweep: every held variant equal to the old kernel's words
    n_cases = 0
    held = {kind: {n: v for n, v in lib[kind].items() if n not in V210_TIMED_ONLY} for kind in lib}
    for w, h in V210_EDGES:
        rand = lambda c: torch.from_numpy(rng.uniform(-0.05, 1.05, (c, h, w)).astype(np.float32)).to(dev)

        def moved(t):
            buf = torch.empty(t.numel() + 1, dtype=torch.float32, device=dev)
            buf[1:].view(t.shape).copy_(t)
            return buf[1:].view(t.shape)

        sweep = [("k2", rand(4)), ("k2", rand(3)), ("k2", moved(rand(3)))]
        for n in (1, 2, 4, 8):
            layers = []
            for m in range(n):
                if m % 2 == 0:
                    a = torch.from_numpy(rng.random((1, h, w), dtype=np.float32)).to(dev)
                    layers.append(torch.cat([rand(3) * a, a]))
                else:
                    mat = torch.from_numpy(transform_matrix(w, h, scale_x=0.8, scale_y=0.9, offset_x=0.01 * m)).to(dev)
                    layers.append((rand(3), *warp_alpha_vectors(h, w, mat)))
            sweep += [("b5", layers), ("b5", [tuple(moved(t) for t in f) if isinstance(f, tuple) else moved(f)
                                                for f in layers])]
        for kind, x in sweep:
            keep, out, old, mapping, built = run(kind, x)
            want = words_of(lambda: old(0), out)
            calls = {name: (lambda v=v: mapping(v)) for v, name in enumerate(names)}
            results = {name: words_of(c, out) for name, c in calls.items()}
            try:
                for name, l in held[kind].items():
                    K.library = lambda l=l: l
                    results[f"csrc {name}"] = built().clone()
            finally:
                K.library = _build.library
            for name, got in results.items():
                if want is None or got is None or not torch.equal(got, want):
                    bad.append(f"{kind} {name}, edge {w}x{h}")
            n_cases += 1
    print(f"v210 packs edge sweep: {n_cases} cases at {V210_EDGES}, every held variant and build equal to the old "
          f"kernel's words: {not any('edge' in b for b in bad)}", flush=True)
    return bad


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=",".join(SECTIONS), help="comma-separated sections: " + ", ".join(SECTIONS))
    sections = [s for s in parser.parse_args().only.split(",") if s]
    if set(sections) - set(SECTIONS):
        parser.error(f"unknown sections {sorted(set(sections) - set(SECTIONS))}")
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    libs = build(ROOT / "build" / "variants", sections)
    rng = np.random.default_rng(cs.SEED)
    run = {"k1": section_k1, "k5": section_k5, "yadif": section_yadif, "rgb3": section_rgb3, "b3": section_b3,
           "rotate": section_rotate, "b6": section_b6, "k4": section_k4, "planar": section_planar,
           "packs": section_packs, "v210packs": section_v210packs}
    bad = []
    for section in sections:
        bad += run[section](torch, dev, rng, libs, card)
    print(f"variants that disagree with the plain version or the built kernel: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
