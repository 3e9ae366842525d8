// B13 planar420_pack: linear RGB(A) (C, H, W) float32, C = 3 or 4 ->
// 8-bit 4:2:0 planes, yuv420p (Y, Cb, Cr) or nv12 (Y and one interleaved
// CbCr plane), at any width and height.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_planar420_pack_rgba.
//
// Bound: device-memory bytes (12 bytes of RGB read and 1.5 bytes written
// per pixel).  The first design, one thread a pixel pair of one row (three
// scalar loads a pixel, single-byte stores, chroma on even rows only) with
// three full-precision powf a pixel, ran at 28 % of its bound, and the
// powf set its time (tools/kernel_variants.py packs; PERF.md).  Design: as
// csrc/planar422_pack.cu (phn::pack_tiles: phn::CorrectedL2G from shared
// memory, a thread a quad of a row, persistent blocks, R, G and B staged
// with cp.async a tile ahead); the even rows' quads also give chroma
// samples 2j and 2j + 1 of chroma row y / 2 (yuv420p.ts:191-201), stored in
// one 4-byte store (nv12: Cb Cr Cb Cr) or one 2-byte store a plane
// (yuv420p); each luma quad in one 4-byte store.  A quad of both rows of a
// row pair a thread, so that every thread does the same work, was no
// faster when both loaded into registers (1.06x a row a thread at 1080p,
// 0.95x at UHD), and two rows a tile ahead do not fit in shared memory
// beside the corrections.  Pixels past the width pack as black luma and
// null chroma, the pitch pad written in the same pass; alpha is never
// read.
#include "phn_common.cuh"

namespace {

// The planes of a quad's codes: the luma quad in one 4-byte store; on an
// even row the chroma in one 4-byte store (nv12: Cb Cr Cb Cr) or one
// 2-byte store a plane (yuv420p)
template <bool kNv12>
struct Store420 {
  uint8_t *y, *c0, *c1;
  int y_pitch, c_pitch;
  __device__ __forceinline__ void operator()(int row, int j, const phn::QuadCodes& q) const {
    phn::store4(y + static_cast<size_t>(row) * y_pitch + 4 * j, q.y[0], q.y[1], q.y[2], q.y[3]);
    if (row & 1) return;
    const size_t c = static_cast<size_t>(row >> 1) * c_pitch;
    if constexpr (kNv12) {
      phn::store4(c0 + c + 4 * j, q.cb[0], q.cr[0], q.cb[1], q.cr[1]);
    } else {
      phn::store2(c0 + c + 2 * j, q.cb[0], q.cb[1]);
      phn::store2(c1 + c + 2 * j, q.cr[0], q.cr[1]);
    }
  }
};

template <bool kNv12, bool kVecLoad>
__global__ void __launch_bounds__(phn::kPackThreads, 1)
    planar420_pack_kernel(const float* __restrict__ rgb, const __grid_constant__ phn::Encode e,
                          phn::PlanarPad pad, const int4* __restrict__ corr, Store420<kNv12> store, int width,
                          int height) {
  phn::pack_tiles<kVecLoad>(rgb, e, pad, corr, width, height, store.y_pitch, false, store);
}

template <bool kNv12, bool kVecLoad>
int launch(const float* rgb, const phn::Encode& e, const phn::PlanarPad& pad, const void* corr,
           const Store420<kNv12>& store, int width, int height, cudaStream_t s) {
  static int resident[phn::kMaxDevices];
  cudaError_t err;
  const int grid = phn::pack_grid(planar420_pack_kernel<kNv12, kVecLoad>, store.y_pitch, height, resident, &err);
  if (grid == 0) return static_cast<int>(err);
  planar420_pack_kernel<kNv12, kVecLoad><<<grid, dim3(phn::kQuadsPerWarp, phn::kPackRows), phn::kPackSmemBytes, s>>>(
      rgb, e, pad, static_cast<const int4*>(corr), store, width, height);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNv12>
int launch_any(const float* rgb, const phn::Encode& e, const phn::PlanarPad& pad, const void* corr,
               const Store420<kNv12>& store, int width, int height, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(rgb) % 16 == 0 && width % 4 == 0)
    return launch<kNv12, true>(rgb, e, pad, corr, store, width, height, s);
  return launch<kNv12, false>(rgb, e, pad, corr, store, width, height, s);
}

}  // namespace

// rgb: (C, height, width) float32, C >= 3, 4-byte aligned; y: (height,
// y_pitch) uint8, aligned to 4 bytes.  yuv420p (interleaved 0): c0, c1 the
// Cb and Cr planes ((height + 1) / 2, c_pitch = y_pitch / 2), each aligned
// to 2 bytes; nv12 (interleaved 1): c0 the CbCr plane ((height + 1) / 2,
// c_pitch = y_pitch), aligned to 4 bytes, c1 unused (misaligned planes:
// cudaErrorMisalignedAddress).  coeffs: col[12], l2g[6] of the format's
// encode; corr: the l2g corrections of those l2g constants (65536 bytes in
// device memory, 16-byte aligned; phn_l2g_corrections).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for pitches other than
// these or no corrections.
extern "C" int phn_planar420_pack(const void* rgb, void* y, void* c0, void* c1, int width,
                                  int height, int y_pitch, int c_pitch, int interleaved,
                                  int luma_black, const float* coeffs, const void* corr, void* stream) {
  const auto at = [](const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (corr == nullptr || !at(corr, 16) || y_pitch % 8 != 0 || c_pitch != (interleaved ? y_pitch : y_pitch / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!at(y, 4) || !at(c0, interleaved ? 4 : 2) || (!interleaved && !at(c1, 2)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const phn::Encode e = phn::encode_from(coeffs);
  const phn::PlanarPad pad = phn::planar_pad(8, luma_black);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(rgb);
  uint8_t *y8 = static_cast<uint8_t*>(y), *a8 = static_cast<uint8_t*>(c0), *b8 = static_cast<uint8_t*>(c1);
  if (interleaved) return launch_any(in, e, pad, corr, Store420<true>{y8, a8, b8, y_pitch, c_pitch}, width, height, s);
  return launch_any(in, e, pad, corr, Store420<false>{y8, a8, b8, y_pitch, c_pitch}, width, height, s);
}
