// K3 planar422_unpack: 8-bit planar 4:2:2 (yuv422p8) -> linear RGBA
// (4, H, W) float32.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:_make_planar422_spatial_unpack
// (reached through make_planar422_unpack_rgba) and the phase kernel of
// make_planar422_unpack_rgba, which covers other widths.
//
// Bound: device-memory bytes.  Per pixel it reads 2 bytes of samples and
// writes 16 bytes of RGBA.  Design: one thread per pixel pair reads its
// two luma samples and the pair's one Cb and Cr sample, so the 2x nearest
// chroma upsample is a shared register instead of the TPU kernel's
// one-hot MXU product.  Neighbouring threads read neighbouring samples.
#include "phn_common.cuh"

namespace {

__global__ void planar422_unpack_kernel(const uint8_t* __restrict__ y,
                                        const uint8_t* __restrict__ u,
                                        const uint8_t* __restrict__ v,
                                        float* __restrict__ out, phn::Decode d, int width,
                                        int height, int y_pitch, int c_pitch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  const int x0 = 2 * k;
  if (x0 >= width) return;

  const float uf = static_cast<float>(u[static_cast<size_t>(row) * c_pitch + k]);
  const float vf = static_cast<float>(v[static_cast<size_t>(row) * c_pitch + k]);
  const uint8_t* yrow = y + static_cast<size_t>(row) * y_pitch;
  const size_t plane = static_cast<size_t>(width) * height;
  float* o = out + static_cast<size_t>(row) * width;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int x = x0 + q;
    if (x >= width) break;
    float rgb[3];
    phn::decode(d, static_cast<float>(yrow[x]), uf, vf, rgb);
    o[x] = rgb[0];
    o[plane + x] = rgb[1];
    o[2 * plane + x] = rgb[2];
    o[3 * plane + x] = 1.0f;
  }
}

}  // namespace

// y: (height, y_pitch) uint8; u, v: (height, c_pitch) uint8; out: (4,
// height, width) float32.  coeffs: col[12], gamut[9]; g2l: the
// gamma'->linear table (65536 float32) in device memory.  Returns
// cudaGetLastError().
extern "C" int phn_planar422_unpack(const void* y, const void* u, const void* v, void* out,
                                    int width, int height, int y_pitch, int c_pitch,
                                    const float* coeffs, const float* g2l, void* stream) {
  const int pairs = (width + 1) / 2;
  const dim3 block(128);
  const dim3 grid((pairs + block.x - 1) / block.x, height);
  planar422_unpack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<float*>(out), phn::decode_from(coeffs, g2l),
      width, height, y_pitch, c_pitch);
  return static_cast<int>(cudaGetLastError());
}
