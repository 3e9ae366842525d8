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
// weights).  The channel count and the mode are template constants, so
// every channel's taps of both sources are loaded before any is blended.
// On the H100 this beats shared-memory windows of each tile's source
// texels (tools/warp_windows.cu) at every shape timed, 1080p and UHD
// (tools/kernel_variants.py k4; PERF.md).  The matrices, mix and mask are
// read from device memory, so animating them needs no host
// synchronisation.
#include "phn_common.cuh"

namespace {

constexpr int kBlockW = 32;  // threads: a warp's row of pixels
constexpr int kBlockH = 8;  // by kBlockH rows
constexpr int kSingle = 0, kDissolve = 1, kWipe = 2;  // modes

template <int kCh, int kMode>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ mat, const float* __restrict__ mat_b,
                const float* __restrict__ mix, const float* __restrict__ mask,
                float* __restrict__ out, int height, int width) {
  const int x = blockIdx.x * kBlockW + threadIdx.x;
  const int y = blockIdx.y * kBlockH + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  const phn::Taps t = phn::axis_taps(mat, x, y, width, height);
  float v[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) v[c] = phn::sample(a + c * plane, width, t);
  if (kMode == kSingle) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) out[c * plane + o] = v[c];
    return;
  }
  const phn::Taps tb = phn::axis_taps(mat_b, x, y, width, height);
  float vb[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) vb[c] = phn::sample(b + c * plane, width, tb);
  // dissolve: weights (mix, 1 - mix); wipe: (1 - m, m), summed b first
  const float m = kMode == kWipe ? mask[o] : *mix;
#pragma unroll
  for (int c = 0; c < kCh; ++c)
    out[c * plane + o] = kMode == kWipe ? vb[c] * m + v[c] * (1.0f - m) : v[c] * m + vb[c] * (1.0f - m);
}

template <int kCh>
void launch(int mode, const float* a, const float* b, const float* mat, const float* mat_b,
            const float* mix, const float* mask, float* out, int height, int width,
            cudaStream_t st) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((width + kBlockW - 1) / kBlockW, (height + kBlockH - 1) / kBlockH);
  if (mode == kSingle) {
    warp_kernel<kCh, kSingle><<<grid, block, 0, st>>>(a, b, mat, mat_b, mix, mask, out, height, width);
  } else if (mode == kDissolve) {
    warp_kernel<kCh, kDissolve><<<grid, block, 0, st>>>(a, b, mat, mat_b, mix, mask, out, height, width);
  } else {
    warp_kernel<kCh, kWipe><<<grid, block, 0, st>>>(a, b, mat, mat_b, mix, mask, out, height, width);
  }
}

}  // namespace

// a, b: (channels, height, width) float32, channels 3 or 4 (b null for a
// single warp); mat, mat_b: (3, 3) float32 (mat_b null: b under mat); mix:
// one float32 (dissolve); mask: (height, width) float32 (wipe; null for a
// dissolve); out: like a.  Returns cudaGetLastError().
extern "C" int phn_warp(const void* a, const void* b, const void* mat, const void* mat_b,
                        const void* mix, const void* mask, void* out, int channels, int height,
                        int width, void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels != 3 && channels != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int mode = b == nullptr ? kSingle : (mask != nullptr ? kWipe : kDissolve);
  const auto fa = static_cast<const float*>(a), fb = static_cast<const float*>(b);
  const auto fm = static_cast<const float*>(mat);
  const auto fmb = mat_b != nullptr ? static_cast<const float*>(mat_b) : fm;
  const auto fmix = static_cast<const float*>(mix), fmask = static_cast<const float*>(mask);
  const auto o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (channels == 4) {
    launch<4>(mode, fa, fb, fm, fmb, fmix, fmask, o, height, width, st);
  } else {
    launch<3>(mode, fa, fb, fm, fmb, fmix, fmask, o, height, width, st);
  }
  return static_cast<int>(cudaGetLastError());
}
