// B14 rotate: the general affine DVE warp (MIXER ROTATION at any angle, and
// any shear or scale) of (C, H, W) float32 frames, a single source, a
// dissolve pair or a wipe pair, each pair under one shared matrix or two.
//
// Replaces phaneron_tpu/ops/pallas_rotate.py:_make_pass, reached through
// make_rotate_program (a quarter turn plus two shear passes, one kernel
// launch per pass and source, then an XLA mix).  That design exists only
// because Mosaic has no gather; it approximates the direct bilinear gather
// and differs from it at content step edges.  This kernel computes what it
// approximates, ops/geometry.py warp_affine: output pixel (x, y) samples
// the source at
//   px = m00 * ix + m01 * iy + m02 + 0.5,  ix = x / W - 0.5
//   py = m10 * ix + m11 * iy + m12 + 0.5,  iy = y / H - 0.5
// in texel coordinates u = px * W - 0.5, v = py * H - 0.5, taps floor and
// floor + 1 with weight frac, border zero, lerping along x first and then
// along y (warp_affine's _sample_bilinear; phn::sample lerps y first, as
// the axis-aligned warp does).  With -fmad=false each product and sum
// rounds as in the plain version, so the kernel equals it to the bit up to
// the sign of zero.  It takes any matrix, so the TPU's quarter-turn and
// shear-bucket codes (rot_bucket, rot_bucket_b) are not read.
//
// Pair modes mix after the warps, as the plain path does:
//   dissolve  out = warp(a, mat) * mix + warp(b, mat_b) * (1 - mix)
//   wipe      out = warp(b, mat_b) * m + warp(a, mat) * (1 - m)
// with m the (H, W) mask plane read in output space.  A rotated transition
// is one launch.
//
// Bound: device-memory bytes.  Each output pixel reads four taps of each
// source and writes 4 bytes per channel; neighbouring threads' taps share
// cache lines along the rotated rows, so L1 and L2 serve the overlap and
// device memory sees about one read of each source texel the matrix
// reaches.  Design: one thread per output pixel gathers directly; matrices,
// mix and mask are read from device memory, so animating them needs no
// host synchronisation.
#include "phn_common.cuh"

namespace {

// Taps of output pixel (x, y) under the affine matrix mat (3, 3).  The
// tap index is clamped to [-2, size] before the integer conversion, which
// keeps every validity flag and keeps the conversion defined for positions
// far off the frame.
__device__ __forceinline__ phn::Taps affine_taps(const float* mat, int x, int y, int width,
                                                 int height) {
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float ix = static_cast<float>(x) / fw - 0.5f;
  const float iy = static_cast<float>(y) / fh - 0.5f;
  const float px = mat[0] * ix + mat[1] * iy + mat[2] + 0.5f;
  const float py = mat[3] * ix + mat[4] * iy + mat[5] + 0.5f;
  const float u = px * fw - 0.5f;
  const float v = py * fh - 0.5f;
  const float flx = floorf(u), fly = floorf(v);
  phn::Taps t;
  t.fx = u - flx;
  t.fy = v - fly;
  t.x0 = static_cast<int>(fminf(fmaxf(flx, -2.0f), fw));
  t.y0 = static_cast<int>(fminf(fmaxf(fly, -2.0f), fh));
  t.vx0 = t.x0 >= 0 && t.x0 < width;
  t.vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < width;
  t.vy0 = t.y0 >= 0 && t.y0 < height;
  t.vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < height;
  return t;
}

// One (H, W) plane at the taps: lerp along x (top and bottom rows), then
// along y.  Only valid texels are read; an invalid tap counts as 0.
__device__ __forceinline__ float sample_affine(const float* __restrict__ s, int width,
                                               const phn::Taps& t) {
  const float* r0 = s + static_cast<ptrdiff_t>(t.y0) * width;
  const float* r1 = r0 + width;
  const float v00 = t.vx0 && t.vy0 ? r0[t.x0] : 0.0f;
  const float v10 = t.vx1 && t.vy0 ? r0[t.x0 + 1] : 0.0f;
  const float v01 = t.vx0 && t.vy1 ? r1[t.x0] : 0.0f;
  const float v11 = t.vx1 && t.vy1 ? r1[t.x0 + 1] : 0.0f;
  const float top = v00 * (1.0f - t.fx) + v10 * t.fx;
  const float bot = v01 * (1.0f - t.fx) + v11 * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

__global__ void rotate_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ mat, const float* __restrict__ mat_b,
                              const float* __restrict__ mix, const float* __restrict__ mask,
                              float* __restrict__ out, int channels, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const phn::Taps t = affine_taps(mat, x, y, width, height);
  const phn::Taps tb = b != nullptr ? affine_taps(mat_b, x, y, width, height) : t;
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  float m = 1.0f;
  if (mask != nullptr) {
    m = mask[o];
  } else if (b != nullptr) {
    m = *mix;
  }
  for (int c = 0; c < channels; ++c) {
    float v = sample_affine(a + c * plane, width, t);
    if (b != nullptr) {
      const float vb = sample_affine(b + c * plane, width, tb);
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
extern "C" int phn_rotate(const void* a, const void* b, const void* mat, const void* mat_b,
                          const void* mix, const void* mask, void* out, int channels,
                          int height, int width, void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  rotate_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(mat),
      static_cast<const float*>(mat_b != nullptr ? mat_b : mat),
      static_cast<const float*>(mix), static_cast<const float*>(mask),
      static_cast<float*>(out), channels, height, width);
  return static_cast<int>(cudaGetLastError());
}
