// K4 warp_axis_aligned: the axis-aligned DVE warp of (C, H, W) float32
// frames: a single source, a dissolve pair, or a wipe pair, each pair under
// one shared matrix or two distinct ones.
//
// Replaces phaneron_tpu/ops/pallas_warp.py:_make_program (reached through
// make_warp_program, make_warp_pair_program and make_wipe_pair_program),
// in all its modes, for 4-channel RGBA and 3-channel opaque frames (n_ch
// 3: the alpha of an opaque frame is separable, ops/warp.py
// warp_alpha_vectors, and is never warped).
//
// Output pixel (x, y) samples each source at the bilinear taps of
// phn::axis_taps (phn_common.cuh) under its own matrix, in the order of the
// plain version (ops/geometry.py warp_axis_aligned), so with -fmad=false
// the kernel agrees with it to the bit up to the sign of zero.
//
// Pair modes mix after the warp, the order of the plain path (the JAX
// package's XLA expressions, pipeline.py:466-476), not the TPU kernel's
// premix:
//   dissolve  out = warp(a, mat) * mix + warp(b, mat_b) * (1 - mix)
//   wipe      out = warp(b, mat_b) * m + warp(a, mat) * (1 - m)
// where m is the (H, W) mask plane (the unpacked mask's R channel) read in
// output space.  Both orders read the same bytes.
//
// Bound: device-memory bytes.  Per output pixel and channel it reads four
// taps of each source and writes 4 bytes; the taps of neighbouring
// threads overlap, so L1 and L2 serve most of them and device memory sees
// about one read of each source.  Design: one thread per output pixel
// gathers its taps directly (no scale buckets, DMA windows or one-hot MXU
// weights), and the matrices, mix and mask are read from device memory, so
// animating them needs no host synchronisation.
#include "phn_common.cuh"

namespace {

__global__ void warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            const float* __restrict__ mat, const float* __restrict__ mat_b,
                            const float* __restrict__ mix, const float* __restrict__ mask,
                            float* __restrict__ out, int channels, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const phn::Taps t = phn::axis_taps(mat, x, y, width, height);
  const phn::Taps tb = b != nullptr ? phn::axis_taps(mat_b, x, y, width, height) : t;
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  // dissolve: weights (mix, 1 - mix); wipe: (1 - m, m), summed b first
  float m = 1.0f;
  if (mask != nullptr) {
    m = mask[o];
  } else if (b != nullptr) {
    m = *mix;
  }
  for (int c = 0; c < channels; ++c) {
    float v = phn::sample(a + c * plane, width, t);
    if (b != nullptr) {
      const float vb = phn::sample(b + c * plane, width, tb);
      v = mask != nullptr ? vb * m + v * (1.0f - m) : v * m + vb * (1.0f - m);
    }
    out[c * plane + o] = v;
  }
}

}  // namespace

// a, b: (channels, height, width) float32 (b null for a single warp);
// mat, mat_b: (3, 3) float32 (mat_b null: b under mat); mix: one float32
// (dissolve); mask: (height, width) float32 (wipe; null for a dissolve);
// out: like a.  Returns cudaGetLastError().
extern "C" int phn_warp(const void* a, const void* b, const void* mat, const void* mat_b,
                        const void* mix, const void* mask, void* out, int channels, int height,
                        int width, void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(mat),
      static_cast<const float*>(mat_b != nullptr ? mat_b : mat),
      static_cast<const float*>(mix), static_cast<const float*>(mask),
      static_cast<float*>(out), channels, height, width);
  return static_cast<int>(cudaGetLastError());
}
