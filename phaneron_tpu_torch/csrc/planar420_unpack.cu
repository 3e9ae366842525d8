// B12 planar420_unpack: 8-bit 4:2:0, yuv420p (Y, Cb and Cr planes) or nv12 (Y
// and one interleaved CbCr plane) -> linear RGBA (4, H, W) float32, at any
// width and height (odd ones too).
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:_make_planar420_spatial_unpack
// and the phase kernel of make_planar420_unpack_rgba, which covers other
// widths.  Their even-height assert and 8- and 16-row padding are Mosaic
// layouts and have no counterpart here; the 2x2 nearest upsample, a one-hot
// MXU product and a sublane row double on the TPU (the product also
// de-interleaves nv12), is a register shared by the pixels of a quad in both
// rows of a row pair.
//
// Bound: device-memory bytes (1.5 bytes of samples read and 16 bytes of RGBA
// written per pixel).  The first design, one thread a pixel pair of one row
// storing o[2k] and then o[2k + 1] in each plane, wrote half of every sector
// a store touched, twice (with a constant decode and no loads it ran
// 0.93-0.95x its whole time on the fill_buf ramps), and loaded each chroma
// sample in both rows that use it (tools/kernel_variants.py planar; PERF.md).
// Design: one thread a quad of both rows of a row pair (phn::Quad: 4 pixels of
// a row; 8 pixels share 2 Cb and 2 Cr samples), 32 quads (128 pixels) a warp,
// so a 1080p, UHD or 720p row is whole warps.  Each chroma sample is read
// once, by the one thread whose 8 pixels use it; each plane is stored in one
// 16-byte store, consecutive lanes on consecutive floats.  A block is 32 x
// kThreadRows threads, each walking kRowsPerThread row pairs.  An odd height's
// last row pair has one row.  The samples load one at a time: one 4-byte load
// of a luma quad and one 2- or 4-byte load of the chroma pairs ran 0.97-1.10x
// these byte loads, slower on every ramp (1.06-1.10x on B12's own record, the
// yuv420p 1080p ramp), so 4:2:0 has no vector-load build (PERF.md).  16-byte
// stores where the width is a multiple of 4, one store a pixel elsewhere.  What
// sets the time now is as in csrc/planar422_unpack.cu: the stores on
// video-like planes, the gamma'->linear gathers on random ones.
#include "phn_common.cuh"

namespace {

constexpr int kThreadRows = 8;  // block rows: a block is 32 x kThreadRows threads
constexpr int kRowsPerThread = 1;  // row pairs a thread walks, kThreadRows apart
constexpr int kThreads = phn::kQuadsPerWarp * kThreadRows;
constexpr int kRowsPerBlock = kThreadRows * kRowsPerThread;  // row pairs

template <bool kNv12, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
    planar420_unpack_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ c0,
                            const uint8_t* __restrict__ c1, float* __restrict__ out,
                            const __grid_constant__ phn::Decode d, int width, int height,
                            int y_pitch, int c_pitch) {
  const int j = blockIdx.x * phn::kQuadsPerWarp + threadIdx.x;
  const int x0 = 4 * j;
  if (x0 >= width) return;
  const size_t plane = static_cast<size_t>(width) * height;
  const int pairs = (height + 1) / 2;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int pair = blockIdx.y * kRowsPerBlock + r * kThreadRows + threadIdx.y;
    if (pair >= pairs) break;
    phn::Quad q;
    const size_t c = static_cast<size_t>(pair) * c_pitch;
    if constexpr (kNv12) {  // Cb, Cr of chroma sample 2j, then of 2j + 1
      float cbcr[4];
      phn::load_samples<uint8_t, 4, false>(c0 + c + x0, cbcr);
      q.cb[0] = cbcr[0];
      q.cr[0] = cbcr[1];
      q.cb[1] = cbcr[2];
      q.cr[1] = cbcr[3];
    } else {
      phn::load_samples<uint8_t, 2, false>(c0 + c + 2 * j, q.cb);
      phn::load_samples<uint8_t, 2, false>(c1 + c + 2 * j, q.cr);
    }
    const int row = 2 * pair;
    const bool second = row + 1 < height;
    float y1[4];
    phn::load_samples<uint8_t, 4, false>(y + static_cast<size_t>(row) * y_pitch + x0, q.y);
    if (second)
      phn::load_samples<uint8_t, 4, false>(y + static_cast<size_t>(row + 1) * y_pitch + x0, y1);
    float* o = out + static_cast<size_t>(row) * width + x0;
    phn::decode_quad<kVecStore>(d, q, o, plane, width - x0);
    if (second) {
#pragma unroll
      for (int p = 0; p < 4; ++p) q.y[p] = y1[p];
      phn::decode_quad<kVecStore>(d, q, o + width, plane, width - x0);
    }
  }
}

template <bool kNv12, bool kVecStore>
void launch(const void* y, const void* c0, const void* c1, float* out, const phn::Decode& d,
            int width, int height, int y_pitch, int c_pitch, cudaStream_t s) {
  const int pairs = (height + 1) / 2;
  const dim3 grid((width + 4 * phn::kQuadsPerWarp - 1) / (4 * phn::kQuadsPerWarp),
                  (pairs + kRowsPerBlock - 1) / kRowsPerBlock);
  planar420_unpack_kernel<kNv12, kVecStore><<<grid, dim3(phn::kQuadsPerWarp, kThreadRows), 0, s>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(c0),
      static_cast<const uint8_t*>(c1), out, d, width, height, y_pitch, c_pitch);
}

}  // namespace

// y: (height, y_pitch) uint8.  yuv420p (interleaved 0): c0, c1 the Cb and
// Cr planes, ((height + 1) / 2, c_pitch = y_pitch / 2); nv12 (interleaved
// 1): c0 the CbCr plane ((height + 1) / 2, c_pitch = y_pitch), c1 unused.
// out: (4, height, width) float32.  coeffs: col[12], gamut[9]; g2l: the
// gamma'->linear table in device memory.  Returns cudaGetLastError().
extern "C" int phn_planar420_unpack(const void* y, const void* c0, const void* c1, void* out,
                                    int width, int height, int y_pitch, int c_pitch,
                                    int interleaved, const float* coeffs, const float* g2l,
                                    void* stream) {
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const bool vec_stores = width % 4 == 0;
  if (interleaved && vec_stores) {
    launch<true, true>(y, c0, c1, o, d, width, height, y_pitch, c_pitch, s);
  } else if (interleaved) {
    launch<true, false>(y, c0, c1, o, d, width, height, y_pitch, c_pitch, s);
  } else if (vec_stores) {
    launch<false, true>(y, c0, c1, o, d, width, height, y_pitch, c_pitch, s);
  } else {
    launch<false, false>(y, c0, c1, o, d, width, height, y_pitch, c_pitch, s);
  }
  return static_cast<int>(cudaGetLastError());
}
