// K1 v210_unpack: v210 words -> linear RGB(A) (C, H, W) float32, C = 4
// (alpha 1) or 3 (alpha-free opaque frames), for up to kMaxSrcs sources
// in one launch.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:_make_v210_spatial_unpack
// (reached through make_v210_unpack_rgba_batch) and the phase kernel of
// make_v210_unpack_rgba, which covers widths that are not a multiple of
// 128, in both channel counts (make_v210_unpack_rgba_batch(channels=3)
// is the alpha-free variant).  One kernel serves every width: the last
// group is clipped at the frame width.
//
// Bound: device-memory bytes.  Per pixel it reads 16/6 bytes of words and
// writes 16 bytes of RGBA (12 of RGB with C = 3); the arithmetic (two
// matrices and three gathers from the gamma'->linear table, which stays
// in L1/L2) is far below the card's rate.  Design: one thread per 6-pixel group
// reads its four words with a single 16-byte load and gathers the fields
// directly in registers, where the TPU kernel needed phase planes and
// one-hot MXU deinterleaves.  Threads of a warp cover neighbouring
// groups, so the word loads are fully coalesced; each output row is
// written by consecutive threads, 24 bytes apart.
#include "phn_common.cuh"

namespace {

constexpr int kMaxSrcs = 8;

struct Sources {
  const int4* words[kMaxSrcs];
  float* out[kMaxSrcs];
};

__global__ void v210_unpack_kernel(Sources s, phn::Decode d, int width, int height,
                                   int groups, int channels) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  const int x0 = gi * 6;
  if (gi >= groups || x0 >= width) return;

  const int4 w = s.words[blockIdx.z][static_cast<size_t>(row) * groups + gi];
  const size_t plane = static_cast<size_t>(width) * height;
  float* o = s.out[blockIdx.z] + static_cast<size_t>(row) * width;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int x = x0 + p;
    if (x >= width) break;
    float rgb[3];
    phn::decode_v210(d, w, p, rgb);
    o[x] = rgb[0];
    o[plane + x] = rgb[1];
    o[2 * plane + x] = rgb[2];
    if (channels == 4) o[3 * plane + x] = 1.0f;
  }
}

}  // namespace

// words[i]: (height, groups*4) int32 words; outs[i]: (channels, height,
// width) float32, channels 3 or 4.  coeffs: col[12], gamut[9]; g2l: the
// gamma'->linear table (65536 float32) in device memory.  Returns
// cudaGetLastError().
extern "C" int phn_v210_unpack(const void* const* words, void* const* outs, int n_srcs,
                               int width, int height, int groups, int channels,
                               const float* coeffs, const float* g2l, void* stream) {
  if (n_srcs < 1 || n_srcs > kMaxSrcs || (channels != 3 && channels != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Sources s{};
  for (int i = 0; i < n_srcs; ++i) {
    s.words[i] = static_cast<const int4*>(words[i]);
    s.out[i] = static_cast<float*>(outs[i]);
  }
  const dim3 block(128);
  const dim3 grid((groups + block.x - 1) / block.x, height, n_srcs);
  v210_unpack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s, phn::decode_from(coeffs, g2l), width, height, groups, channels);
  return static_cast<int>(cudaGetLastError());
}
