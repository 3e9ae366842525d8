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
// matrices and three gathers from the gamma'->linear table) is below the
// card's rate.  The stores set the time of the first design, one thread
// per 6-pixel group storing six pixels 24 bytes apart from each lane: with
// a constant decode it ran nearly as long as whole, and without stores a
// third of it (tools/kernel_variants.py; PERF.md).  Design: one
// thread per output pixel.  A block covers kPixelsPerBlock pixels (32
// groups) of kRows rows, so a 1080p or UHD row is whole blocks; the six
// threads of a group load its four words with one 16-byte load each (one
// request per warp: the lanes share lines) and take their own fields with
// phn::v210_fields_lane, without diverging on the pixel's place in the
// group.  Each channel plane is then written by consecutive threads on
// consecutive floats, a whole 128-byte line per warp.  Now the stores run
// near the bound, and on full-range random words the table gathers (whose
// cells then differ from lane to lane) take the larger part of the time.
#include "phn_common.cuh"

namespace {

constexpr int kMaxSrcs = 8;
constexpr int kRows = 4;  // rows per block

struct Sources {
  const int4* words[kMaxSrcs];
  float* out[kMaxSrcs];
};

__global__ void __launch_bounds__(phn::kPixelsPerBlock)
    v210_unpack_kernel(const __grid_constant__ Sources s, const __grid_constant__ phn::Decode d,
                       int width, int height, int groups, int channels) {
  const int t = threadIdx.x;
  const int x = blockIdx.x * phn::kPixelsPerBlock + t;
  if (x >= width) return;
  const int g = blockIdx.x * phn::kGroupsPerBlock + t / 6, p = t % 6;
  const int4* words = s.words[blockIdx.z];
  float* out = s.out[blockIdx.z];
  const size_t plane = static_cast<size_t>(width) * height;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = blockIdx.y * kRows + r;
    if (row >= height) break;
    const int4 w = __ldg(words + static_cast<size_t>(row) * groups + g);
    unsigned y, cb, cr;
    phn::v210_fields_lane(w, p, y, cb, cr);
    float rgb[3];
    phn::decode(d, static_cast<float>(y), static_cast<float>(cb), static_cast<float>(cr), rgb);
    float* o = out + static_cast<size_t>(row) * width + x;
    o[0] = rgb[0];
    o[plane] = rgb[1];
    o[2 * plane] = rgb[2];
    if (channels == 4) o[3 * plane] = 1.0f;
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
  const dim3 block(phn::kPixelsPerBlock);
  const dim3 grid((width + phn::kPixelsPerBlock - 1) / phn::kPixelsPerBlock,
                  (height + kRows - 1) / kRows, n_srcs);
  v210_unpack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      s, phn::decode_from(coeffs, g2l), width, height, groups, channels);
  return static_cast<int>(cudaGetLastError());
}
