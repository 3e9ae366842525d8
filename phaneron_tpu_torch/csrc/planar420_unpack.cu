// B12 planar420_unpack: 8-bit 4:2:0, yuv420p (Y, Cb and Cr planes) or
// nv12 (Y and one interleaved CbCr plane) -> linear RGBA (4, H, W)
// float32, at any width and height (odd ones too).
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:_make_planar420_spatial_unpack
// and the phase kernel of make_planar420_unpack_rgba, which covers other
// widths.  Their even-height assert and 8- and 16-row padding are Mosaic
// layouts and have no counterpart here.
//
// Bound: device-memory bytes (1.5 bytes of samples read and 16 bytes of
// RGBA written per pixel).  Design: one thread per pixel pair; row y reads
// chroma row y / 2, so the 2x2 nearest upsample is an index, where the TPU
// kernel runs a one-hot MXU product and a sublane row double.  nv12 reads
// Cb and Cr at 2k and 2k + 1 of its interleaved row: the de-interleave the
// one-hot product absorbs on the TPU is the address.
#include "phn_common.cuh"

namespace {

__global__ void planar420_unpack_kernel(const uint8_t* __restrict__ y,
                                        const uint8_t* __restrict__ c0,
                                        const uint8_t* __restrict__ c1,
                                        float* __restrict__ out, phn::Decode d, int width,
                                        int height, int y_pitch, int c_pitch, int interleaved) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (2 * k >= width) return;

  const uint8_t* crow = c0 + static_cast<size_t>(row >> 1) * c_pitch;
  float uf, vf;
  if (interleaved) {
    uf = static_cast<float>(crow[2 * k]);
    vf = static_cast<float>(crow[2 * k + 1]);
  } else {
    uf = static_cast<float>(crow[k]);
    vf = static_cast<float>(c1[static_cast<size_t>(row >> 1) * c_pitch + k]);
  }
  phn::decode_pair(d, y + static_cast<size_t>(row) * y_pitch, 2 * k, width, uf, vf,
                   out + static_cast<size_t>(row) * width, static_cast<size_t>(width) * height);
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
  const int pairs = (width + 1) / 2;
  const dim3 block(128);
  const dim3 grid((pairs + block.x - 1) / block.x, height);
  planar420_unpack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(c0),
      static_cast<const uint8_t*>(c1), static_cast<float*>(out), phn::decode_from(coeffs, g2l),
      width, height, y_pitch, c_pitch, interleaved);
  return static_cast<int>(cudaGetLastError());
}
