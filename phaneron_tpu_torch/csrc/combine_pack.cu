// B5 combine_pack: the staged channel's tail, N layers premultiplied
// 'over' onto the implicit black base, then the v210 encode and pack, in
// one pass.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_v210_combine_pack.  A
// layer is a (4, H, W) RGBA frame (alpha its plane 3) or a (3, H, W)
// opaque frame whose alpha is the separable warp alpha wy[y] * wx[x]
// (ops/warp.py warp_alpha_vectors; the (rgb, wy, wx) tuples of the
// 3-channel route).  Per pixel, in the order of ops/composite.py
// combine_rgb:
//   out = rgb_0;  out = out * (1 - alpha_m) + rgb_m  for m >= 1
// then the encode of csrc/v210_pack.cu.  With -fmad=false the kernel
// equals combine / combine_rgb + K2 on the card to the bit, and its plain
// version up to the pack's powf rounding.
//
// Bound: device-memory bytes.  Per pixel it reads 16 (RGBA) or 12 (RGB)
// bytes per layer and writes 16/6 bytes of words; the composite never
// touches device memory, where the plain combine runs ~25 elementwise
// kernels a layer, each reading and writing a full frame.  Design: a
// block covers 192 pixels of one row (32 v210 groups); each thread
// composites one pixel in registers, then phn::encode_pack_block encodes
// and packs the row segment.
#include "phn_common.cuh"

namespace {

constexpr int kMaxLayers = 8;

struct Layers {
  const float* frame[kMaxLayers];  // (4, H, W) or (3, H, W), bottom..top
  const float* wy[kMaxLayers];  // (H,) for a (3, H, W) frame, else null
  const float* wx[kMaxLayers];  // (W,) for a (3, H, W) frame, else null
  int n_layers;
};

__global__ void combine_pack_kernel(Layers L, int4* __restrict__ words, phn::Encode e,
                                    int width, int height, int groups) {
  const int row = blockIdx.y;
  const int x = blockIdx.x * phn::kPixelsPerBlock + threadIdx.x;
  float out[3] = {0.0f, 0.0f, 0.0f};
  if (x < width) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t o = static_cast<size_t>(row) * width + x;
    for (int m = 0; m < L.n_layers; ++m) {
      const float* f = L.frame[m];
      if (m == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[c] = f[c * plane + o];
        continue;
      }
      const float a = L.wy[m] != nullptr ? L.wy[m][row] * L.wx[m][x] : f[3 * plane + o];
      const float k = 1.0f - a;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = out[c] * k + f[c * plane + o];
    }
  }
  phn::encode_pack_block(e, out, x, width, row, groups, words);
}

}  // namespace

// frames: n_layers float32 frames bottom..top, (channels[m], height,
// width) with channels[m] 4 or 3; wys, wxs: per layer the (height,) and
// (width,) alpha vectors of a 3-channel frame (null for 4 channels).
// words: (height, groups*4) int32.  coeffs: col[12], l2g[6].  Returns
// cudaGetLastError().
extern "C" int phn_combine_pack(const void* const* frames, const int* channels,
                                const void* const* wys, const void* const* wxs, int n_layers,
                                void* words, int width, int height, int groups,
                                const float* coeffs, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  Layers L{};
  L.n_layers = n_layers;
  for (int m = 0; m < n_layers; ++m) {
    const bool rgb3 = channels[m] == 3;
    if ((!rgb3 && channels[m] != 4) || (rgb3 && (wys[m] == nullptr || wxs[m] == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    L.frame[m] = static_cast<const float*>(frames[m]);
    L.wy[m] = rgb3 ? static_cast<const float*>(wys[m]) : nullptr;
    L.wx[m] = rgb3 ? static_cast<const float*>(wxs[m]) : nullptr;
  }
  const dim3 block(phn::kPixelsPerBlock);
  const dim3 grid((groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock, height);
  combine_pack_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<int4*>(words), phn::encode_from(coeffs), width, height, groups);
  return static_cast<int>(cudaGetLastError());
}
