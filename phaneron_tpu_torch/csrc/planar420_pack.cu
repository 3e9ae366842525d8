// B13 planar420_pack: linear RGB(A) (C, H, W) float32, C = 3 or 4 ->
// 8-bit 4:2:0 planes, yuv420p (Y, Cb, Cr) or nv12 (Y and one interleaved
// CbCr plane), at any width and height.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_planar420_pack_rgba.
//
// Bound: device-memory bytes (12 bytes of RGB read and 1.5 bytes written
// per pixel).  Design: one thread per pixel pair of the pitch and row: it
// encodes both pixels' luma on every row and, on even rows only, the even
// pixel's Cb and Cr into chroma row y / 2 (yuv420p.ts:191-201), so
// (H + 1) / 2 chroma rows; nv12 stores Cb and Cr side by side at 2k and
// 2k + 1.  Pixels past the width pack as black luma and null chroma, the
// pitch pad written in the same pass.  Alpha is never read.
#include "phn_common.cuh"

namespace {

__global__ void planar420_pack_kernel(const float* __restrict__ rgb, uint8_t* __restrict__ y,
                                      uint8_t* __restrict__ c0, uint8_t* __restrict__ c1,
                                      phn::Encode e, phn::PlanarPad pad, int width, int height,
                                      int y_pitch, int c_pitch, int interleaved) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (2 * k >= y_pitch) return;

  const bool chroma = (row & 1) == 0;
  const phn::PairCodes c =
      phn::encode_pair(e, rgb + static_cast<size_t>(row) * width,
                       static_cast<size_t>(width) * height, 2 * k, width, chroma, pad);
  uint8_t* yrow = y + static_cast<size_t>(row) * y_pitch;
  yrow[2 * k] = static_cast<uint8_t>(c.y[0]);
  yrow[2 * k + 1] = static_cast<uint8_t>(c.y[1]);
  if (!chroma) return;
  const size_t crow = static_cast<size_t>(row >> 1) * c_pitch;
  if (interleaved) {
    c0[crow + 2 * k] = static_cast<uint8_t>(c.cb);
    c0[crow + 2 * k + 1] = static_cast<uint8_t>(c.cr);
  } else {
    c0[crow + k] = static_cast<uint8_t>(c.cb);
    c1[crow + k] = static_cast<uint8_t>(c.cr);
  }
}

}  // namespace

// rgb: (C, height, width) float32, C >= 3; y: (height, y_pitch) uint8.
// yuv420p (interleaved 0): c0, c1 the Cb and Cr planes ((height + 1) / 2,
// c_pitch = y_pitch / 2); nv12 (interleaved 1): c0 the CbCr plane
// ((height + 1) / 2, c_pitch = y_pitch), c1 unused.  coeffs: col[12],
// l2g[6] of the format's encode.  Returns cudaGetLastError().
extern "C" int phn_planar420_pack(const void* rgb, void* y, void* c0, void* c1, int width,
                                  int height, int y_pitch, int c_pitch, int interleaved,
                                  int luma_black, const float* coeffs, void* stream) {
  const int pairs = y_pitch / 2;
  const dim3 block(128);
  const dim3 grid((pairs + block.x - 1) / block.x, height);
  planar420_pack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<uint8_t*>(y), static_cast<uint8_t*>(c0),
      static_cast<uint8_t*>(c1), phn::encode_from(coeffs), phn::planar_pad(8, luma_black), width,
      height, y_pitch, c_pitch, interleaved);
  return static_cast<int>(cudaGetLastError());
}
