// B11 planar422_pack: linear RGB(A) (C, H, W) float32, C = 3 or 4 ->
// planar 4:2:2 planes, 8-bit (yuv422p8, uint8) or 10-bit (yuv422p10le,
// uint16).
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_planar422_pack_rgba.
//
// Bound: device-memory bytes (12 bytes of RGB read and 2 samples written
// per pixel).  The first design, one thread a pixel pair (three scalar
// loads a pixel, four 1- or 2-byte stores a pair) with three full-precision
// powf a pixel, ran at a third of its bound, and the powf set its time:
// without them it ran at 0.32x (tools/kernel_variants.py packs; PERF.md).
// Design: linear->gamma' is phn::CorrectedL2G, two MUFU operations and a
// correction byte from shared memory, equal to powf to the bit (a gather
// from a 65536-float table of its values was as fast on the ramps, 1.4x
// slower on the media frame, 2x on random RGBA); the table indices and the
// codes are rounded without conversion instructions (phn::u16_rte_alu),
// which issue at a quarter rate and cost 10-20 % at 1080p.  One thread a
// quad (4 pixels of a row, their 2 Cb and 2 Cr samples), 32 quads (128
// pixels) a warp; the luma quad in one 4- or 8-byte store and each chroma
// pair in one 2- or 4-byte store.  phn::pack_tiles: one persistent block an SM
// copies the 64 KB of corrections once and walks tiles of 32 quads by
// kPackRows rows, R, G and B staged with cp.async a tile ahead, one
// 16-byte copy a plane where the frame is 16-byte aligned and its width a
// multiple of 4 (one 4-byte copy a pixel elsewhere; the C entry decides).
// The pitch pad's quads write black luma and null chroma in the same pass
// (an odd width's last pixel too); alpha is never read.
#include "phn_common.cuh"

namespace {

// The planes of a quad's codes: the luma quad in one 4- or 8-byte store,
// each chroma pair in one 2- or 4-byte store
template <typename T>
struct Store422 {
  T *y, *u, *v;
  int y_pitch, c_pitch;
  __device__ __forceinline__ void operator()(int row, int j, const phn::QuadCodes& q) const {
    phn::store4(y + static_cast<size_t>(row) * y_pitch + 4 * j, q.y[0], q.y[1], q.y[2], q.y[3]);
    const size_t c = static_cast<size_t>(row) * c_pitch + 2 * j;
    phn::store2(u + c, q.cb[0], q.cb[1]);
    phn::store2(v + c, q.cr[0], q.cr[1]);
  }
};

template <typename T, bool kVecLoad>
__global__ void __launch_bounds__(phn::kPackThreads, 1)
    planar422_pack_kernel(const float* __restrict__ rgb, const __grid_constant__ phn::Encode e,
                          phn::PlanarPad pad, const int4* __restrict__ corr, Store422<T> store, int width,
                          int height) {
  phn::pack_tiles<kVecLoad>(rgb, e, pad, corr, width, height, store.y_pitch, true, store);
}

template <typename T, bool kVecLoad>
int launch(const float* rgb, const phn::Encode& e, const phn::PlanarPad& pad, const void* corr,
           const Store422<T>& store, int width, int height, cudaStream_t s) {
  static int resident[phn::kMaxDevices];
  cudaError_t err;
  const int grid = phn::pack_grid(planar422_pack_kernel<T, kVecLoad>, store.y_pitch, height, resident, &err);
  if (grid == 0) return static_cast<int>(err);
  planar422_pack_kernel<T, kVecLoad><<<grid, dim3(phn::kQuadsPerWarp, phn::kPackRows), phn::kPackSmemBytes, s>>>(
      rgb, e, pad, static_cast<const int4*>(corr), store, width, height);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const float* rgb, void* y, void* u, void* v, const phn::Encode& e, const phn::PlanarPad& pad,
               const void* corr, int width, int height, int y_pitch, int c_pitch, cudaStream_t s) {
  const auto at = [](const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (!at(y, 4 * sizeof(T)) || !at(u, 2 * sizeof(T)) || !at(v, 2 * sizeof(T)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Store422<T> store{static_cast<T*>(y), static_cast<T*>(u), static_cast<T*>(v), y_pitch, c_pitch};
  if (at(rgb, 16) && width % 4 == 0) return launch<T, true>(rgb, e, pad, corr, store, width, height, s);
  return launch<T, false>(rgb, e, pad, corr, store, width, height, s);
}

}  // namespace

// rgb: (C, height, width) float32, C >= 3, 4-byte aligned; y: (height,
// y_pitch), u, v: (height, c_pitch = y_pitch / 2) samples, uint8 for
// num_bits 8 and uint16 for num_bits 10, y aligned to 4 samples and u, v
// to 2 (else cudaErrorMisalignedAddress).  coeffs: col[12], l2g[6] of the
// format's encode; corr: the l2g corrections of those l2g constants
// (65536 bytes in device memory, 16-byte aligned; phn_l2g_corrections).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another bit
// depth, pitches other than these or no corrections.
extern "C" int phn_planar422_pack(const void* rgb, void* y, void* u, void* v, int width,
                                  int height, int y_pitch, int c_pitch, int num_bits,
                                  int luma_black, const float* coeffs, const void* corr, void* stream) {
  if (corr == nullptr || reinterpret_cast<uintptr_t>(corr) % 16 != 0 || y_pitch % 8 != 0 ||
      2 * c_pitch != y_pitch)
    return static_cast<int>(cudaErrorInvalidValue);
  const phn::Encode e = phn::encode_from(coeffs);
  const phn::PlanarPad pad = phn::planar_pad(num_bits, luma_black);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(rgb);
  if (num_bits == 8) return launch_any<uint8_t>(in, y, u, v, e, pad, corr, width, height, y_pitch, c_pitch, s);
  if (num_bits == 10) return launch_any<uint16_t>(in, y, u, v, e, pad, corr, width, height, y_pitch, c_pitch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
