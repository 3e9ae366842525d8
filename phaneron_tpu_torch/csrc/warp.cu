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
//
// Band form (a row-sharded channel, parallel/bands.py): the launch writes
// output rows [row0, row0 + rows) from source windows that hold the rows
// the band's taps reach (ops/packed_warp.py axis_window).  Taps are taken
// at the frame's own rows and height, and a tap's row indexes the window
// as ty - src_row0, so every output pixel equals the full-frame launch's.
#include "phn_common.cuh"

namespace {

constexpr int kBlockW = 32;  // threads: a warp's row of pixels
constexpr int kBlockH = 8;  // by kBlockH rows
constexpr int kSingle = 0, kDissolve = 1, kWipe = 2;  // modes

// kBand false: a full-frame launch, the band of every row (row0 0, rows
// height, the sources whole and their planes width * height apart), with
// no band arithmetic in its code
template <int kCh, int kMode, bool kBand>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ mat, const float* __restrict__ mat_b,
                const float* __restrict__ mix, const float* __restrict__ mask,
                float* __restrict__ out, int height, int width, int row0, int rows,
                int src_plane) {
  const int x = blockIdx.x * kBlockW + threadIdx.x;
  const int ly = blockIdx.y * kBlockH + threadIdx.y;  // the row in the output (the band)
  const int n = kBand ? rows : height;
  if (x >= width || ly >= n) return;
  const int y = kBand ? row0 + ly : ly;  // the frame's row
  const size_t plane = static_cast<size_t>(width) * n;
  const size_t splane = kBand ? static_cast<size_t>(src_plane) : plane;
  const size_t o = static_cast<size_t>(ly) * width + x;
  const phn::Taps t = phn::axis_taps(mat, x, y, width, height);
  float v[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) v[c] = phn::sample(a + c * splane, width, t);
  if (kMode == kSingle) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) out[c * plane + o] = v[c];
    return;
  }
  const phn::Taps tb = phn::axis_taps(mat_b, x, y, width, height);
  float vb[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) vb[c] = phn::sample(b + c * splane, width, tb);
  // dissolve: weights (mix, 1 - mix); wipe: (1 - m, m), summed b first
  const float m = kMode == kWipe ? mask[o] : *mix;
#pragma unroll
  for (int c = 0; c < kCh; ++c)
    out[c * plane + o] = kMode == kWipe ? vb[c] * m + v[c] * (1.0f - m) : v[c] * m + vb[c] * (1.0f - m);
}

template <int kCh, int kMode>
void launch_mode(bool band, const float* a, const float* b, const float* mat, const float* mat_b,
                 const float* mix, const float* mask, float* out, int height, int width, int row0,
                 int rows, int src_plane, cudaStream_t st) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((width + kBlockW - 1) / kBlockW, (rows + kBlockH - 1) / kBlockH);
  if (band) {
    warp_kernel<kCh, kMode, true><<<grid, block, 0, st>>>(a, b, mat, mat_b, mix, mask, out, height, width,
                                                          row0, rows, src_plane);
  } else {
    warp_kernel<kCh, kMode, false><<<grid, block, 0, st>>>(a, b, mat, mat_b, mix, mask, out, height, width,
                                                           row0, rows, src_plane);
  }
}

template <int kCh>
void launch(int mode, bool band, const float* a, const float* b, const float* mat, const float* mat_b,
            const float* mix, const float* mask, float* out, int height, int width, int row0,
            int rows, int src_plane, cudaStream_t st) {
  if (mode == kSingle) {
    launch_mode<kCh, kSingle>(band, a, b, mat, mat_b, mix, mask, out, height, width, row0, rows, src_plane, st);
  } else if (mode == kDissolve) {
    launch_mode<kCh, kDissolve>(band, a, b, mat, mat_b, mix, mask, out, height, width, row0, rows, src_plane, st);
  } else {
    launch_mode<kCh, kWipe>(band, a, b, mat, mat_b, mix, mask, out, height, width, row0, rows, src_plane, st);
  }
}

}  // namespace

// a, b: the source windows, `channels` planes of src_rows rows by `width`
// columns, frame rows src_row0 .. src_row0 + src_rows - 1, each row
// `width` floats after the last and the planes of both src_plane floats
// apart (b null for a single warp); mat, mat_b: (3, 3) float32 (mat_b
// null: b under mat); mix: one float32 (dissolve); mask: (rows, width)
// float32 (wipe; null for a dissolve); out: (channels, rows, width), frame
// rows row0 .. row0 + rows - 1 of the (channels, height, width) result.  A
// full-frame launch is row0 0, rows height, src_row0 0, src_rows height.
// Returns cudaGetLastError().
extern "C" int phn_warp(const void* a, const void* b, const void* mat, const void* mat_b,
                        const void* mix, const void* mask, void* out, int channels, int height,
                        int width, int row0, int rows, int src_row0, int src_rows, int src_plane,
                        void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels != 3 && channels != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (!phn::band_ok(height, row0, rows, src_row0, src_rows) || width <= 0 ||
      src_plane < src_rows * width)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = b == nullptr ? kSingle : (mask != nullptr ? kWipe : kDissolve);
  // the windows addressed by frame row
  const auto fa = phn::frame_row0(static_cast<const float*>(a), src_row0, width);
  const auto fb = b != nullptr ? phn::frame_row0(static_cast<const float*>(b), src_row0, width) : nullptr;
  const auto fm = static_cast<const float*>(mat);
  const auto fmb = mat_b != nullptr ? static_cast<const float*>(mat_b) : fm;
  const auto fmix = static_cast<const float*>(mix), fmask = static_cast<const float*>(mask);
  const auto o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool band = !(row0 == 0 && rows == height && src_row0 == 0 && src_rows == height &&
                      static_cast<long long>(src_plane) == static_cast<long long>(width) * height);
  if (channels == 4) {
    launch<4>(mode, band, fa, fb, fm, fmb, fmix, fmask, o, height, width, row0, rows, src_plane, st);
  } else {
    launch<3>(mode, band, fa, fb, fm, fmb, fmix, fmask, o, height, width, row0, rows, src_plane, st);
  }
  return static_cast<int>(cudaGetLastError());
}
