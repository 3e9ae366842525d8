// B6 packed_warp: the axis-aligned DVE warp of one v210 source, or of a
// dissolve pair under one shared or two distinct matrices, with the v210
// decode at each bilinear tap, -> linear RGBA (4, H, W) float32.
//
// Replaces phaneron_tpu/ops/pallas_packed_warp.py:_make_program (reached
// through make_packed_warp_program and make_packed_warp_pair_program, n_mat
// 1 or 2): a v210 DVE layer that is not part of a whole-stack packed
// composite never writes its decoded RGBA frame to device memory.
//
// Output pixel (x, y) takes the taps of phn::axis_taps (the order of the
// plain version, ops/geometry.py warp_axis_aligned); each valid tap is
// decoded by phn::v210_texel (the decode K1 runs) and the lerps are those
// of phn::sample, so the kernel equals K1 (4 ch) -> K4 on the card to the
// bit, and its plain version (v210_unpack_plain -> warp_axis_aligned ->
// mix_frames) likewise.  Alpha is the warp of the constant-1 plane, and a
// pair mixes after the warp, warp(a) * mix + warp(b) * (1 - mix), per
// channel alpha included, as the staged path does (the TPU kernel
// premixes a shared-matrix pair before one warp).
//
// Bound: device-memory bytes.  Each source word the matrices reach is
// read once (neighbouring pixels' taps share the 16-byte group loads
// through L1 and L2) and 16 bytes of RGBA are written per pixel.  Every
// tap is decoded where it is used, 4 (single) or 8 (pair) decodes per
// output pixel against 1 per source pixel in K1; decoding each block's
// source window once into shared memory is ROADMAP B6's first redesign
// item.  Design: one thread per output pixel; matrices and the mix are
// read from device memory, so animating them needs no host
// synchronisation.
#include "phn_common.cuh"

namespace {

__global__ void packed_warp_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                                   const float* __restrict__ mat_a,
                                   const float* __restrict__ mat_b,
                                   const float* __restrict__ mix, float* __restrict__ out,
                                   phn::Decode d, int width, int height, int groups) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const phn::Taps ta = phn::axis_taps(mat_a, x, y, width, height);
  float v[4];
  phn::sample_v210(a, groups, d, ta, v);
  v[3] = phn::bilerp(ta, 1.0f, 1.0f, 1.0f, 1.0f);
  if (b != nullptr) {
    const phn::Taps tb = phn::axis_taps(mat_b, x, y, width, height);
    float vb[4];
    phn::sample_v210(b, groups, d, tb, vb);
    vb[3] = phn::bilerp(tb, 1.0f, 1.0f, 1.0f, 1.0f);
    const float m = *mix;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = v[c] * m + vb[c] * (1.0f - m);
  }
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * plane + o] = v[c];
}

}  // namespace

// a, b: (height, groups*4) int32 v210 words (b null for a single warp);
// mat_a, mat_b: (3, 3) float32 (mat_b == mat_a for a shared-matrix
// pair); mix: one float32 (ignored without b); out: (4, height, width)
// float32.  coeffs: col[12], gamut[9]; g2l: the gamma'->linear table in
// device memory.  Returns cudaGetLastError().
extern "C" int phn_packed_warp(const void* a, const void* b, const void* mat_a,
                               const void* mat_b, const void* mix, void* out, int width,
                               int height, int groups, const float* coeffs, const float* g2l,
                               void* stream) {
  if (b != nullptr && (mat_b == nullptr || mix == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  packed_warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), static_cast<const int4*>(b),
      static_cast<const float*>(mat_a), static_cast<const float*>(mat_b),
      static_cast<const float*>(mix), static_cast<float*>(out),
      phn::decode_from(coeffs, g2l), width, height, groups);
  return static_cast<int>(cudaGetLastError());
}
