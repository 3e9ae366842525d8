// B3 fused_v210: the top v210 layer of a channel without DVE, as a cut or
// a dissolve between two clips, from source words to output words in one
// launch: decode -> optional dissolve a * mix + b * (1 - mix) -> 'over'
// black -> encode -> v210.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_fused_v210_program
// (_make_kernel), which the JAX package's make_channel_program selects
// through supported_spec whenever the top layer is such a layer: a v210
// source decodes opaque, so the top layer covers every layer below it and
// 'over' black is the identity on its RGB (0 * (1 - alpha) + rgb).
//
// The decode is phn::decode_v210 (the one K1 runs), the dissolve the
// order of ops/composite.py mix_frames, the encode that of csrc/
// v210_pack.cu (tail fields past the frame width and groups in the pitch
// pad pack as zero).  So the kernel equals its plain version (K1 plain ->
// mix_frames -> combine over black -> K2 plain) up to the pack's powf
// rounding, and K1 -> K2 on the card to the bit.
//
// Bound: device-memory bytes.  Per pixel it reads 16/6 bytes of words per
// source and writes 16/6 bytes of words; nothing else touches device
// memory, where the staged path writes and re-reads 16 bytes of RGBA per
// source pixel.  Design: one thread per 6-pixel group, one 16-byte load
// per source and one 16-byte store; the six pixels are decoded, mixed and
// encoded in registers.  The mix is read from device memory, so animating
// it needs no host synchronisation.
#include "phn_common.cuh"

namespace {

__global__ void fused_v210_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                                  const float* __restrict__ mix, int4* __restrict__ out,
                                  phn::Decode d, phn::Encode e, int width, int height,
                                  int groups) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (gi >= groups) return;

  const size_t at = static_cast<size_t>(row) * groups + gi;
  const int4 wa = a[at];
  const int4 wb = b != nullptr ? b[at] : wa;
  const float m = b != nullptr ? *mix : 1.0f;
  unsigned ys[6] = {0, 0, 0, 0, 0, 0};
  unsigned cb[3] = {0, 0, 0};
  unsigned cr[3] = {0, 0, 0};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    if (gi * 6 + p >= width) break;
    float rgb[3];
    phn::decode_v210(d, wa, p, rgb);
    if (b != nullptr) {
      float rgb_b[3];
      phn::decode_v210(d, wb, p, rgb_b);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * m + rgb_b[c] * (1.0f - m);
    }
    const float rp = phn::l2g(e.g, rgb[0]);
    const float gp = phn::l2g(e.g, rgb[1]);
    const float bp = phn::l2g(e.g, rgb[2]);
    ys[p] = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
    if ((p & 1) == 0) {
      cb[p / 2] = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
      cr[p / 2] = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
    }
  }
  out[at] = phn::v210_group(ys, cb, cr);
}

}  // namespace

// a, b: (height, groups*4) int32 v210 words (b null for a cut); mix: one
// float32 in device memory (ignored for a cut); out: like a.
// dec_coeffs: col[12], gamut[9]; g2l: the gamma'->linear table in device
// memory; enc_coeffs: col[12], l2g[6].  Returns cudaGetLastError().
extern "C" int phn_fused_v210(const void* a, const void* b, const void* mix, void* out,
                              int width, int height, int groups, const float* dec_coeffs,
                              const float* g2l, const float* enc_coeffs, void* stream) {
  if (b != nullptr && mix == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(128);
  const dim3 grid((groups + block.x - 1) / block.x, height);
  fused_v210_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), static_cast<const int4*>(b),
      static_cast<const float*>(mix), static_cast<int4*>(out),
      phn::decode_from(dec_coeffs, g2l), phn::encode_from(enc_coeffs), width, height, groups);
  return static_cast<int>(cudaGetLastError());
}
