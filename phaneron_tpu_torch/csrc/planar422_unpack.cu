// K3 / B10 planar422_unpack: planar 4:2:2, 8-bit (yuv422p8, uint8
// samples) or 10-bit (yuv422p10le, uint16 samples) -> linear RGBA
// (4, H, W) float32.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:_make_planar422_spatial_unpack
// (reached through make_planar422_unpack_rgba) and the phase kernel of
// make_planar422_unpack_rgba, which covers other widths.
//
// Bound: device-memory bytes.  Per pixel it reads 2 samples (2 or 4
// bytes) and writes 16 bytes of RGBA.  Design: one thread per pixel pair
// reads its two luma samples and the pair's one Cb and Cr sample, so the
// 2x nearest chroma upsample is a shared register instead of the TPU
// kernel's one-hot MXU product (and its 4*hi8 + lo2 bf16 split of 10-bit
// codes).  Neighbouring threads read neighbouring samples.
#include "phn_common.cuh"

namespace {

template <typename T>
__global__ void planar422_unpack_kernel(const T* __restrict__ y, const T* __restrict__ u,
                                        const T* __restrict__ v, float* __restrict__ out,
                                        phn::Decode d, int width, int height, int y_pitch,
                                        int c_pitch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (2 * k >= width) return;

  const size_t c = static_cast<size_t>(row) * c_pitch + k;
  phn::decode_pair(d, y + static_cast<size_t>(row) * y_pitch, 2 * k, width,
                   static_cast<float>(u[c]), static_cast<float>(v[c]),
                   out + static_cast<size_t>(row) * width, static_cast<size_t>(width) * height);
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
  const int pairs = (width + 1) / 2;
  const dim3 block(128);
  const dim3 grid((pairs + block.x - 1) / block.x, height);
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (num_bits == 8) {
    planar422_unpack_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), o, d, width, height, y_pitch, c_pitch);
  } else if (num_bits == 10) {
    planar422_unpack_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(y), static_cast<const uint16_t*>(u),
        static_cast<const uint16_t*>(v), o, d, width, height, y_pitch, c_pitch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
