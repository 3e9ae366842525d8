// K4 warp_axis_aligned: the axis-aligned DVE warp of (C, H, W) float32
// frames, single source or a dissolve pair with one shared matrix.
//
// Replaces phaneron_tpu/ops/pallas_warp.py:_make_program (reached through
// make_warp_program and make_warp_pair_program), in its single and
// dissolve-pair modes.
//
// Output pixel (x, y) samples the source at texel coordinates
//   px = (m00 * (x/W - 0.5) + m02 + 0.5) * W - 0.5
//   py = (m11 * (y/H - 0.5) + m12 + 0.5) * H - 0.5
// (pallas_warp.py:541-547, geometry.py:186-196) from the taps floor and
// floor+1 with weight frac; a tap outside the frame contributes 0.  The
// lerp runs along rows first, then along columns, in the order of the
// plain version (ops/geometry.py warp_axis_aligned), so with -fmad=false
// the kernel agrees with it to the bit up to the sign of zero.
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

__device__ __forceinline__ float sample(const float* __restrict__ s, int width, int x0,
                                        int y0, bool vx0, bool vx1, bool vy0, bool vy1,
                                        float fx, float fy) {
  // row pointers are dereferenced only where the row is valid
  const float* r0 = s + static_cast<ptrdiff_t>(y0) * width;
  const float* r1 = r0 + width;
  float c0 = 0.0f, c1 = 0.0f;
  if (vx0) {
    const float t0 = vy0 ? r0[x0] : 0.0f;
    const float t1 = vy1 ? r1[x0] : 0.0f;
    c0 = t0 * (1.0f - fy) + t1 * fy;
  }
  if (vx1) {
    const float t0 = vy0 ? r0[x0 + 1] : 0.0f;
    const float t1 = vy1 ? r1[x0 + 1] : 0.0f;
    c1 = t0 * (1.0f - fy) + t1 * fy;
  }
  return c0 * (1.0f - fx) + c1 * fx;
}

__global__ void warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            const float* __restrict__ mat, const float* __restrict__ mix,
                            float* __restrict__ out, int channels, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float ix = static_cast<float>(x) / fw - 0.5f;
  const float iy = static_cast<float>(y) / fh - 0.5f;
  const float px = (mat[0] * ix + mat[2] + 0.5f) * fw - 0.5f;
  const float py = (mat[4] * iy + mat[5] + 0.5f) * fh - 0.5f;
  const float flx = floorf(px), fly = floorf(py);
  const float fx = px - flx, fy = py - fly;
  const int x0 = static_cast<int>(flx), y0 = static_cast<int>(fly);
  const bool vx0 = x0 >= 0 && x0 < width, vx1 = x0 + 1 >= 0 && x0 + 1 < width;
  const bool vy0 = y0 >= 0 && y0 < height, vy1 = y0 + 1 >= 0 && y0 + 1 < height;

  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  const float m = b != nullptr ? *mix : 1.0f;
  for (int c = 0; c < channels; ++c) {
    float v = sample(a + c * plane, width, x0, y0, vx0, vx1, vy0, vy1, fx, fy);
    if (b != nullptr) {
      const float vb = sample(b + c * plane, width, x0, y0, vx0, vx1, vy0, vy1, fx, fy);
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
