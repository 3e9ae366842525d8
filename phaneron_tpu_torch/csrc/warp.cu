// K4 warp_axis_aligned: the axis-aligned DVE warp of (C, H, W) float32
// frames, single source or a dissolve pair with one shared matrix.
//
// Replaces phaneron_tpu/ops/pallas_warp.py:_make_program (reached through
// make_warp_program and make_warp_pair_program), in its single and
// dissolve-pair modes, for 4-channel RGBA and 3-channel opaque frames
// (n_ch 3: the alpha of an opaque frame is separable, ops/warp.py
// warp_alpha_vectors, and is never warped).
//
// Output pixel (x, y) samples the source at the bilinear taps of
// phn::axis_taps (phn_common.cuh), in the order of the plain version
// (ops/geometry.py warp_axis_aligned), so with -fmad=false the kernel
// agrees with it to the bit up to the sign of zero.
//
// Pair mode warps both sources with the same matrix and mixes after the
// warp: out = warp(a) * mix + warp(b) * (1 - mix), the order of the plain
// path, not the TPU kernel's premix.  Both orders read the same bytes.
//
// Bound: device-memory bytes.  Per output pixel and channel it reads four
// taps of each source and writes 4 bytes; the taps of neighbouring
// threads overlap, so L1 and L2 serve most of them and device memory sees
// about one read of each source.  Design: one thread per output pixel
// gathers its taps directly (no scale buckets, DMA windows or one-hot MXU
// weights), and the matrix and mix are read from device memory, so
// animating them needs no host synchronisation.
#include "phn_common.cuh"

namespace {

__global__ void warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            const float* __restrict__ mat, const float* __restrict__ mix,
                            float* __restrict__ out, int channels, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const phn::Taps t = phn::axis_taps(mat, x, y, width, height);
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  const float m = b != nullptr ? *mix : 1.0f;
  for (int c = 0; c < channels; ++c) {
    float v = phn::sample(a + c * plane, width, t);
    if (b != nullptr) {
      const float vb = phn::sample(b + c * plane, width, t);
      v = v * m + vb * (1.0f - m);
    }
    out[c * plane + o] = v;
  }
}

}  // namespace

// a, b: (channels, height, width) float32 (b null for a single warp);
// mat: (3, 3) float32; mix: one float32 (ignored without b); out: like a.
// Returns cudaGetLastError().
extern "C" int phn_warp(const void* a, const void* b, const void* mat, const void* mix,
                        void* out, int channels, int height, int width, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(mat), static_cast<const float*>(mix),
      static_cast<float*>(out), channels, height, width);
  return static_cast<int>(cudaGetLastError());
}
