// The v210 packs: K2 v210_pack, a linear RGB(A) (C, H, W) float32 frame
// -> v210 words, and B5 combine_pack, the staged channel's tail, N layers
// premultiplied 'over' onto the implicit black base, then K2's encode and
// pack, in one pass.  One kernel: K2 is B5 over one layer (instances
// with the layer count compiled in for one and two layers).
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_v210_pack_rgba (K2)
// and make_v210_combine_pack (B5).  A layer is a (4, H, W) RGBA frame
// (alpha its plane 3) or a (3, H, W) opaque frame whose alpha is the
// separable warp alpha wy[y] * wx[x] (ops/warp.py warp_alpha_vectors; the
// (rgb, wy, wx) tuples of the 3-channel route).  Per pixel, in the order
// of ops/composite.py combine_rgb:
//   out = rgb_0;  out = out * (1 - alpha_m) + rgb_m  for m >= 1
// (layer 0's alpha is never read), then the encode: linear->gamma', the
// 3x4 matrix, rte and saturation, chroma from the even pixels; fields past
// the frame width, and whole groups in the pitch pad, pack as zero.  With
// -fmad=false the kernel equals combine_rgb + K2 on the card to the bit,
// and its plain version up to torch.pow's rounding of linear->gamma'.
//
// Bound: device-memory bytes.  Per pixel it reads 12 bytes of RGB for
// layer 0 and 16 (RGBA) or 12 (RGB) for each layer above, and writes 16/6
// bytes of words; the composite never touches device memory, where the
// plain combine runs ~25 elementwise kernels a layer, each reading and
// writing a full frame.  The first designs (K2 a thread a 6-pixel group,
// each lane's loads 24 bytes from its neighbour's; B5 a 192-thread block
// a row segment, codes exchanged behind a block barrier) computed three
// full-precision powf a pixel, two thirds of K2's time, and ran at 29 %
// and 50 % of their bounds (tools/kernel_variants.py v210packs; PERF.md).
// Design: phn::v210_segments: one persistent block an SM copies the l2g
// corrections into shared memory once, and its warps walk 192-pixel row
// segments, a lane a 6-pixel group, its words in one 16-byte store.  Each
// warp copies a segment's rows of the layers' planes into shared memory
// with cp.async one stage ahead of the one it composites (every layer in
// a stage up to two layers, one layer a stage above; 16 bytes a copy
// where every frame is 16-byte aligned and the width a multiple of 4,
// else 4: the C entry decides); linear->gamma' by two MUFU operations
// moved to powf's bits by the correction bytes.  Loading into registers
// instead (a lane three pixel pairs, codes exchanged through shared
// memory) was slower at one and two layers, and slower still when it
// prefetched the next segment into L2 (PERF.md).
#include "phn_common.cuh"

namespace {

// kLayers: 1 (K2, and B5 over one layer), 2 (B5 on every staged main
// path) or 0 (any other count, read at run time)
template <int kLayers, bool kVec>
__global__ void __launch_bounds__(32 * (kLayers == 1 ? phn::kMaxSegWarps : phn::kLayersSegWarps), 1)
    pack_kernel(const __grid_constant__ phn::Layers L, const __grid_constant__ phn::Encode e,
                const int4* __restrict__ corr, int4* __restrict__ words, int width, int height, int groups) {
  phn::v210_segments<kLayers, kVec>(L, e, corr, words, width, height, groups);
}

int resident[3][2][phn::kMaxDevices];

template <int kLayers>
int launch_with(const phn::Layers& L, const phn::Encode& e, const void* corr, void* words, int width, int height,
                int groups, cudaStream_t s) {
  if (phn::quads_aligned(L, width))
    return phn::launch_segments(pack_kernel<kLayers, true>, L, e, corr, words, width, height, groups,
                                resident[kLayers][1], s);
  return phn::launch_segments(pack_kernel<kLayers, false>, L, e, corr, words, width, height, groups,
                              resident[kLayers][0], s);
}

// The instance of the layer count (layer 0's alpha is never read, so one
// layer is K2's work)
int launch(const phn::Layers& L, const float* coeffs, const void* corr, void* words, int width, int height,
           int groups, void* stream) {
  const phn::Encode e = phn::encode_from(coeffs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L.n_layers == 1) return launch_with<1>(L, e, corr, words, width, height, groups, s);
  if (L.n_layers == 2) return launch_with<2>(L, e, corr, words, width, height, groups, s);
  return launch_with<0>(L, e, corr, words, width, height, groups, s);
}

}  // namespace

// K2.  rgb: (C >= 3, height, width) float32, 4-byte aligned; words:
// (height, groups*4) int32, 16-byte aligned.  coeffs: col[12], l2g[6];
// corr: the l2g corrections of those l2g constants (65536 bytes in device
// memory, 16-byte aligned; phn_l2g_corrections).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for no corrections.
extern "C" int phn_v210_pack(const void* rgb, void* words, int width, int height, int groups,
                             const float* coeffs, const void* corr, void* stream) {
  phn::Layers L{};
  L.frame[0] = static_cast<const float*>(rgb);
  L.n_layers = 1;
  return launch(L, coeffs, corr, words, width, height, groups, stream);
}

// B5.  frames: n_layers float32 frames bottom..top, (channels[m], height,
// width) with channels[m] 4 or 3; wys, wxs: per layer the (height,) and
// (width,) alpha vectors of a 3-channel frame (null for 4 channels); all
// 4-byte aligned.  words, coeffs, corr as phn_v210_pack's.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for 0 or more than
// kMaxLayers layers, another channel count, a 3-channel frame without its
// alpha vectors or no corrections.
extern "C" int phn_combine_pack(const void* const* frames, const int* channels,
                                const void* const* wys, const void* const* wxs, int n_layers,
                                void* words, int width, int height, int groups,
                                const float* coeffs, const void* corr, void* stream) {
  if (n_layers < 1 || n_layers > phn::kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  phn::Layers L{};
  L.n_layers = n_layers;
  for (int m = 0; m < n_layers; ++m) {
    const bool rgb3 = channels[m] == 3;
    if ((!rgb3 && channels[m] != 4) || (rgb3 && (wys[m] == nullptr || wxs[m] == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    L.frame[m] = static_cast<const float*>(frames[m]);
    L.wy[m] = rgb3 ? static_cast<const float*>(wys[m]) : nullptr;
    L.wx[m] = rgb3 ? static_cast<const float*>(wxs[m]) : nullptr;
  }
  return launch(L, coeffs, corr, words, width, height, groups, stream);
}
