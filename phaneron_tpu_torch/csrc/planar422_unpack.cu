// K3 / B10 planar422_unpack: planar 4:2:2, 8-bit (yuv422p8, uint8 samples) or
// 10-bit (yuv422p10le, uint16 samples) -> linear RGBA (4, H, W) float32.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:_make_planar422_spatial_unpack
// (reached through make_planar422_unpack_rgba) and the phase kernel of
// make_planar422_unpack_rgba, which covers other widths.  The 2x nearest
// chroma upsample, a one-hot MXU product on the TPU (with a 4*hi8 + lo2 bf16
// split of 10-bit codes), is a register shared by a quad's pixels.
//
// Bound: device-memory bytes.  Per pixel it reads 2 samples (2 or 4 bytes) and
// writes 16 bytes of RGBA.  The first design, one thread a pixel pair storing
// o[2k] and then o[2k + 1] in each plane, wrote half of every sector a store
// touched, twice: with a constant decode and no loads it ran 0.85-0.91x its
// whole time on the fill_buf ramps (tools/kernel_variants.py planar;
// PERF.md).  Design: one thread a quad (phn::Quad, 4 pixels of a row and their
// 2 Cb and 2 Cr samples), 32 quads (128 pixels) a warp, so a 1080p, UHD or
// 720p row is whole warps; its luma in one 4- or 8-byte load, each chroma
// pair in one 2- or 4-byte load (every sample read once), and each plane
// stored in one 16-byte store, consecutive lanes on consecutive floats.  A
// block is 32 x kThreadRows threads, each walking kRowsPerThread rows.  The
// vector loads (0.95-1.00x one load a sample) run where every plane and row
// is aligned for them, one load a sample elsewhere (the 8-bit planes may lie
// at any byte); 16-byte stores where the width is a multiple of 4, one store
// a pixel elsewhere.  Now the stores run near the bound on video-like planes;
// on full-range random planes the gamma'->linear gathers, whose cells then
// differ from lane to lane and miss L1, take about half the time.  B3's MUFU
// gamma'->linear with correction bytes halves that, but is slower on the
// ramps, in every warp or only in warps of rough quads, so the gather stays
// (PERF.md).
#include "phn_common.cuh"

namespace {

constexpr int kThreadRows = 8;  // block rows: a block is 32 x kThreadRows threads
constexpr int kRowsPerThread = 2;  // rows a thread walks, kThreadRows apart
constexpr int kThreads = phn::kQuadsPerWarp * kThreadRows;
constexpr int kRowsPerBlock = kThreadRows * kRowsPerThread;

template <typename T, bool kVecLoad, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
    planar422_unpack_kernel(const T* __restrict__ y, const T* __restrict__ u,
                            const T* __restrict__ v, float* __restrict__ out,
                            const __grid_constant__ phn::Decode d, int width, int height,
                            int y_pitch, int c_pitch) {
  const int j = blockIdx.x * phn::kQuadsPerWarp + threadIdx.x;
  const int x0 = 4 * j;
  if (x0 >= width) return;
  const size_t plane = static_cast<size_t>(width) * height;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = blockIdx.y * kRowsPerBlock + r * kThreadRows + threadIdx.y;
    if (row >= height) break;
    phn::Quad q;
    phn::load_samples<T, 4, kVecLoad>(y + static_cast<size_t>(row) * y_pitch + x0, q.y);
    phn::load_samples<T, 2, kVecLoad>(u + static_cast<size_t>(row) * c_pitch + 2 * j, q.cb);
    phn::load_samples<T, 2, kVecLoad>(v + static_cast<size_t>(row) * c_pitch + 2 * j, q.cr);
    phn::decode_quad<kVecStore>(d, q, out + static_cast<size_t>(row) * width + x0, plane,
                                width - x0);
  }
}

template <typename T, bool kVecLoad, bool kVecStore>
void launch(const void* y, const void* u, const void* v, float* out, const phn::Decode& d,
            int width, int height, int y_pitch, int c_pitch, cudaStream_t s) {
  const dim3 grid((width + 4 * phn::kQuadsPerWarp - 1) / (4 * phn::kQuadsPerWarp),
                  (height + kRowsPerBlock - 1) / kRowsPerBlock);
  planar422_unpack_kernel<T, kVecLoad, kVecStore><<<grid, dim3(phn::kQuadsPerWarp, kThreadRows), 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(u), static_cast<const T*>(v), out, d,
      width, height, y_pitch, c_pitch);
}

// Whether a quad's luma loads as one 4-sample word and each chroma pair as
// one 2-sample word: every plane and row aligned to its load.
template <typename T>
bool vector_loads(const void* y, const void* u, const void* v, int y_pitch, int c_pitch) {
  const auto at = [](const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  return at(y, 4 * sizeof(T)) && at(u, 2 * sizeof(T)) && at(v, 2 * sizeof(T)) && y_pitch % 4 == 0 &&
         c_pitch % 2 == 0;
}

template <typename T>
void launch_any(const void* y, const void* u, const void* v, float* out, const phn::Decode& d,
                int width, int height, int y_pitch, int c_pitch, cudaStream_t s) {
  const bool vec_loads = vector_loads<T>(y, u, v, y_pitch, c_pitch);
  const bool vec_stores = width % 4 == 0;
  if (vec_loads && vec_stores) {
    launch<T, true, true>(y, u, v, out, d, width, height, y_pitch, c_pitch, s);
  } else if (vec_loads) {
    launch<T, true, false>(y, u, v, out, d, width, height, y_pitch, c_pitch, s);
  } else if (vec_stores) {
    launch<T, false, true>(y, u, v, out, d, width, height, y_pitch, c_pitch, s);
  } else {
    launch<T, false, false>(y, u, v, out, d, width, height, y_pitch, c_pitch, s);
  }
}

}  // namespace

// y: (height, y_pitch); u, v: (height, c_pitch) samples, uint8 for
// num_bits 8 and uint16 for num_bits 10; out: (4, height, width) float32.
// coeffs: col[12], gamut[9] of the format's decode; g2l: the
// gamma'->linear table (65536 float32) in device memory.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another bit depth.
extern "C" int phn_planar422_unpack(const void* y, const void* u, const void* v, void* out,
                                    int width, int height, int y_pitch, int c_pitch,
                                    int num_bits, const float* coeffs, const float* g2l,
                                    void* stream) {
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (num_bits == 8) {
    launch_any<uint8_t>(y, u, v, o, d, width, height, y_pitch, c_pitch, s);
  } else if (num_bits == 10) {
    launch_any<uint16_t>(y, u, v, o, d, width, height, y_pitch, c_pitch, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
