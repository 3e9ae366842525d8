// K5 packed_composite: a run of DVE layers, each a cut or a dissolve pair
// under one axis-aligned matrix, 'over' composited bottom to top, in one
// launch, emitting v210 words ('packed'), the composited frame ('rgba') or
// both.  Sources are opaque (3, H, W) float32 frames (kind rgb3), v210
// words decoded at each bilinear tap (kind packed), or (4, H, W) float32
// RGBA frames that carry their own alpha (kind rgba).
//
// Replaces three TPU kernels:
// - phaneron_tpu/ops/pallas_packed_warp.py:make_packed_composite_program
//   in all its emits, with src_kind 'rgb3' (the tick of an interlaced
//   channel: deinterlaced fields -> premixed warps -> 'over' -> encode ->
//   v210) and src_kind 'packed' (the progressive multi-layer v210
//   channel: the whole frame from source words to output words);
// - phaneron_tpu/ops/pallas_composite.py:make_composite_program (B15:
//   every layer's v210 words decoded, warped, dissolved, 'over' black,
//   alpha the top layer's separable warp alpha): kind packed, alpha top;
// - phaneron_tpu/ops/pallas_warp.py:make_layers_combine_program (B16:
//   every layer's (4, H, W) RGBA warped with its own alpha, the pair
//   mixed, 'over', alpha the top layer's): kind rgba, alpha top.
//
// Per output pixel and layer m the kernel computes, in the operation order
// of the staged plain path (ops/packed_warp.py packed_composite_plain =
// [v210_unpack_plain, 3 channels,] warp_plain, warp_alpha_vectors,
// combine_rgb, coverage, v210_pack_plain):
//   v_m = warp(a) * mix + warp(b) * (1 - mix)       (phn::sample, or
//                                                    phn::sample_v210 for words;
//                                                    all four channels for rgba)
//   alpha_m = wy[y] * wx[x]                         (the separable warp alpha of
//                                                    an opaque source), or
//   alpha_m = v_m.a                                 (kind rgba)
//   out = v_0.rgb;  out = out * (1 - alpha_m) + v_m.rgb  for m >= 1
//   cover = alpha_0;  cover = cover * (1 - alpha_m) + alpha_m
// then the v210 encode and packing of csrc/v210_pack.cu, and/or the
// (4, H, W) frame: (out, cover), the run's coverage alpha, which a layer
// above or below composites with (a run that spans part of the stack), or
// with top_alpha (a run that is the whole stack) (out, alpha_top), the
// top layer's alpha that the reference emits (combine.ts:47-59).  The
// bottom layer is written as it is: over black, 0 * k + v == v.  With
// -fmad=false it equals [K1 (3 ch) +] K4 + combine_rgb + K2 on the card
// to the bit, and the plain version up to the pack's powf rounding.  The
// TPU kernels premix the two sources before one warp and run the warp as
// bf16 hi/lo products (~2^-17), with a polynomial gamma in the decode;
// the port keeps the staged order and the exact decode, which its plain
// version and tests share.
//
// Bound: device-memory bytes.  Each source texel (or v210 word) the
// layers' matrices reach is read once (neighbouring pixels' taps share
// cache lines, so L1 and L2 serve the overlap) and 16/6 bytes of words (16
// bytes of frame for the rgba emit) are written per pixel; no intermediate
// frame, alpha plane or composite
// touches device memory, where the staged path writes and re-reads a
// decoded and a warped frame per source and the composite.  In the packed
// kind every tap is decoded where it is used: 4 taps x 2 sources x 4
// layers = 32 decodes per output pixel for the 4-layer dissolve frame,
// against 1 per source pixel in K1, which keeps the kernel well away from
// its bound (decoding each block's source window once into shared memory
// is ROADMAP's first speed item).  Design: a block covers 192
// pixels of one row (32 v210 groups).  Each thread composites one pixel in
// registers, then phn::encode_pack_block encodes and packs the row
// segment.  Matrices and mixes are read from device memory, so animating
// them needs no host synchronisation.
#include "phn_common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxSrcs = 2 * kMaxLayers;

struct Layers {
  const void* src[kMaxSrcs];  // bottom..top, n_src per layer
  const float* mat[kMaxLayers];  // (3, 3) each
  const float* mix[kMaxLayers];  // one float each; null for a cut
  int n_src[kMaxLayers];  // 1 cut, 2 dissolve pair
  int n_layers;
};

// Source kinds (ops/packed_warp.py _KINDS)
constexpr int kRgb3 = 0;
constexpr int kPacked = 1;
constexpr int kRgba = 2;

// One source's linear RGB (kind rgba: RGBA) at the taps
template <int kKind>
__device__ __forceinline__ void sample_src(const void* src, const phn::Taps& tp,
                                           const phn::Decode& d, int width, int height,
                                           int groups, float v[4]) {
  if (kKind == kPacked) {
    phn::sample_v210(static_cast<const int4*>(src), groups, d, tp, v);
  } else {
    const size_t plane = static_cast<size_t>(width) * height;
    const float* s = static_cast<const float*>(src);
#pragma unroll
    for (int c = 0; c < (kKind == kRgba ? 4 : 3); ++c) v[c] = phn::sample(s + c * plane, width, tp);
  }
}

template <int kKind>
__global__ void packed_composite_kernel(Layers L, int4* __restrict__ words,
                                        float* __restrict__ rgba, phn::Decode d, phn::Encode e,
                                        int width, int height, int groups, int top_alpha) {
  constexpr int kCh = kKind == kRgba ? 4 : 3;
  const int row = blockIdx.y;
  const int x = blockIdx.x * phn::kPixelsPerBlock + threadIdx.x;
  float out[3] = {0.0f, 0.0f, 0.0f};
  float cover = 0.0f, a = 0.0f;
  if (x < width) {
    int s = 0;
    for (int m = 0; m < L.n_layers; ++m) {
      const phn::Taps tp = phn::axis_taps(L.mat[m], x, row, width, height);
      float v[4];
      sample_src<kKind>(L.src[s], tp, d, width, height, groups, v);
      if (L.n_src[m] == 2) {
        const float mx = *L.mix[m];
        float vb[4];
        sample_src<kKind>(L.src[s + 1], tp, d, width, height, groups, vb);
#pragma unroll
        for (int c = 0; c < kCh; ++c) v[c] = v[c] * mx + vb[c] * (1.0f - mx);
      }
      if (kKind == kRgba) {
        a = v[3];
      } else {
        // warp(ones): (row-weight sum) x (column-weight sum), ops/warp.py
        // warp_alpha_vectors
        const float wy = (tp.vy0 ? 1.0f - tp.fy : 0.0f) + (tp.vy1 ? tp.fy : 0.0f);
        const float wx = (tp.vx0 ? 1.0f - tp.fx : 0.0f) + (tp.vx1 ? tp.fx : 0.0f);
        a = wy * wx;
      }
      const float k = 1.0f - a;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = m == 0 ? v[c] : out[c] * k + v[c];
      cover = m == 0 ? a : cover * k + a;
      s += L.n_src[m];
    }
    if (rgba != nullptr) {
      const size_t plane = static_cast<size_t>(width) * height;
      const size_t o = static_cast<size_t>(row) * width + x;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgba[c * plane + o] = out[c];
      rgba[3 * plane + o] = top_alpha ? a : cover;
    }
  }
  if (words != nullptr) phn::encode_pack_block(e, out, x, width, row, groups, words);
}

}  // namespace

// srcs: n_srcs sources, bottom..top: (3, height, width) float32 frames
// (kind 0, rgb3), (height, groups*4) int32 v210 words (kind 1, packed) or
// (4, height, width) float32 RGBA frames (kind 2, rgba); mats: n_layers
// (3, 3) float32; mixes: n_layers pointers to one float32 (null for a
// cut); n_src: n_layers entries of 1 or 2 summing to n_srcs.
// Outputs, at least one: words (height, groups*4) int32 (emit 'packed'),
// rgba (4, height, width) float32 (emit 'rgba'); both for emit 'both'.
// top_alpha: the frame's alpha is the top layer's (1) or the run's
// coverage (0).  dec_coeffs: col[12], gamut[9] and g2l, the gamma'->linear
// table in device memory (read for kind 1 only); enc_coeffs: col[12],
// l2g[6].  Returns cudaGetLastError().
extern "C" int phn_packed_composite(const void* const* srcs, const void* const* mats,
                                    const void* const* mixes, const int* n_src, int n_layers,
                                    int kind, void* words, void* rgba, int width, int height,
                                    int groups, const float* dec_coeffs, const float* g2l,
                                    const float* enc_coeffs, int top_alpha, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  if (kind != kRgb3 && kind != kPacked && kind != kRgba)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kPacked && (dec_coeffs == nullptr || g2l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (words == nullptr && rgba == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Layers L{};
  L.n_layers = n_layers;
  int s = 0;
  for (int m = 0; m < n_layers; ++m) {
    if (n_src[m] != 1 && n_src[m] != 2) return static_cast<int>(cudaErrorInvalidValue);
    if (n_src[m] == 2 && mixes[m] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    L.n_src[m] = n_src[m];
    L.mat[m] = static_cast<const float*>(mats[m]);
    L.mix[m] = static_cast<const float*>(mixes[m]);
    for (int r = 0; r < n_src[m]; ++r, ++s) L.src[s] = srcs[s];
  }
  const phn::Decode d = kind == kPacked ? phn::decode_from(dec_coeffs, g2l) : phn::Decode{};
  const phn::Encode e = phn::encode_from(enc_coeffs);
  const dim3 block(phn::kPixelsPerBlock);
  const dim3 grid((groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock, height);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* w = static_cast<int4*>(words);
  float* f = static_cast<float*>(rgba);
  if (kind == kPacked) {
    packed_composite_kernel<kPacked><<<grid, block, 0, st>>>(L, w, f, d, e, width, height, groups,
                                                             top_alpha);
  } else if (kind == kRgba) {
    packed_composite_kernel<kRgba><<<grid, block, 0, st>>>(L, w, f, d, e, width, height, groups,
                                                           top_alpha);
  } else {
    packed_composite_kernel<kRgb3><<<grid, block, 0, st>>>(L, w, f, d, e, width, height, groups,
                                                           top_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
