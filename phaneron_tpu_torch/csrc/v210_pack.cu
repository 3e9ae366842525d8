// K2 v210_pack: linear RGB(A) (C, H, W) float32 -> v210 words.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_v210_pack_rgba.
//
// Bound: device-memory bytes.  Per pixel it reads 12 bytes of RGB (alpha
// is never read) and writes 16/6 bytes of words.  Design: one thread per
// 6-pixel group encodes its pixels in registers (transfer function, 3x4
// matrix, rte, ushort saturation, 10-bit mask; chroma from the even
// pixels) and writes its four words with one 16-byte store, where the TPU
// kernel needed a phase-planar relayout of the input.  Fields past the
// frame width, and whole groups in the pitch pad, pack as zero.
#include "phn_common.cuh"

namespace {

__global__ void v210_pack_kernel(const float* __restrict__ rgb, int4* __restrict__ words,
                                 phn::Encode e, int width, int height, int groups) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (gi >= groups) return;

  const size_t plane = static_cast<size_t>(width) * height;
  const float* in = rgb + static_cast<size_t>(row) * width;
  unsigned ys[6] = {0, 0, 0, 0, 0, 0};
  unsigned cb[3] = {0, 0, 0};
  unsigned cr[3] = {0, 0, 0};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int x = gi * 6 + p;
    if (x >= width) break;
    const float rp = phn::l2g(e.g, in[x]);
    const float gp = phn::l2g(e.g, in[plane + x]);
    const float bp = phn::l2g(e.g, in[2 * plane + x]);
    ys[p] = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
    if ((p & 1) == 0) {
      cb[p / 2] = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
      cr[p / 2] = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
    }
  }
  words[static_cast<size_t>(row) * groups + gi] = phn::v210_group(ys, cb, cr);
}

}  // namespace

// rgb: (C >= 3, height, width) float32; words: (height, groups*4) int32.
// coeffs: col[12], l2g[6].  Returns cudaGetLastError().
extern "C" int phn_v210_pack(const void* rgb, void* words, int width, int height,
                             int groups, const float* coeffs, void* stream) {
  const dim3 block(128);
  const dim3 grid((groups + block.x - 1) / block.x, height);
  v210_pack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<int4*>(words), phn::encode_from(coeffs),
      width, height, groups);
  return static_cast<int>(cudaGetLastError());
}
