// B11 planar422_pack: linear RGB(A) (C, H, W) float32, C = 3 or 4 ->
// planar 4:2:2 planes, 8-bit (yuv422p8, uint8) or 10-bit (yuv422p10le,
// uint16).
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_planar422_pack_rgba.
//
// Bound: device-memory bytes (12 bytes of RGB read and 2 samples written
// per pixel; the encode's powf is ~2 % of the float32 rate at that
// traffic).  Design: one thread per pixel pair of the pitch, where the TPU
// kernel splits even and odd pixels into phase planes in XLA: it encodes
// both pixels' luma and the even pixel's chroma (yuv422p10.ts:169-170)
// with the codes masked to the bit depth, and writes the pad codes (black
// luma, null chroma) for pixels past the width, so the pitch pad costs no
// second pass.  Alpha is never read.
#include "phn_common.cuh"

namespace {

template <typename T>
__global__ void planar422_pack_kernel(const float* __restrict__ rgb, T* __restrict__ y,
                                      T* __restrict__ u, T* __restrict__ v, phn::Encode e,
                                      phn::PlanarPad pad, int width, int height, int y_pitch,
                                      int c_pitch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (k >= c_pitch) return;

  const phn::PairCodes c =
      phn::encode_pair(e, rgb + static_cast<size_t>(row) * width,
                       static_cast<size_t>(width) * height, 2 * k, width, true, pad);
  T* yrow = y + static_cast<size_t>(row) * y_pitch;
  yrow[2 * k] = static_cast<T>(c.y[0]);
  yrow[2 * k + 1] = static_cast<T>(c.y[1]);
  u[static_cast<size_t>(row) * c_pitch + k] = static_cast<T>(c.cb);
  v[static_cast<size_t>(row) * c_pitch + k] = static_cast<T>(c.cr);
}

}  // namespace

// rgb: (C, height, width) float32, C >= 3; y: (height, y_pitch), u, v:
// (height, c_pitch = y_pitch / 2) samples, uint8 for num_bits 8 and
// uint16 for num_bits 10.  coeffs: col[12], l2g[6] of the format's encode.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another bit
// depth.
extern "C" int phn_planar422_pack(const void* rgb, void* y, void* u, void* v, int width,
                                  int height, int y_pitch, int c_pitch, int num_bits,
                                  int luma_black, const float* coeffs, void* stream) {
  const dim3 block(128);
  const dim3 grid((c_pitch + block.x - 1) / block.x, height);
  const phn::Encode e = phn::encode_from(coeffs);
  const phn::PlanarPad pad = phn::planar_pad(num_bits, luma_black);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(rgb);
  if (num_bits == 8) {
    planar422_pack_kernel<uint8_t><<<grid, block, 0, s>>>(
        in, static_cast<uint8_t*>(y), static_cast<uint8_t*>(u), static_cast<uint8_t*>(v), e, pad,
        width, height, y_pitch, c_pitch);
  } else if (num_bits == 10) {
    planar422_pack_kernel<uint16_t><<<grid, block, 0, s>>>(
        in, static_cast<uint16_t*>(y), static_cast<uint16_t*>(u), static_cast<uint16_t*>(v), e,
        pad, width, height, y_pitch, c_pitch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
