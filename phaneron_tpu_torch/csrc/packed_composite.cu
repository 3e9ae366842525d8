// K5 packed_composite (rgb3): a run of DVE layers over opaque (3, H, W)
// float32 sources, each a cut or a dissolve pair under one axis-aligned
// matrix, 'over' composited bottom to top and packed to v210 words, in
// one launch.
//
// Replaces phaneron_tpu/ops/pallas_packed_warp.py:make_packed_composite_program
// in its src_kind='rgb3', emit='packed' mode: the whole tick of an
// interlaced channel (deinterlaced fields -> premixed warps -> 'over' ->
// encode -> v210) that the JAX package runs as one TPU kernel.  Its
// 'packed' source kind (v210 words decoded in the warp window) and its
// 'rgba' emit are still to port (ROADMAP.md B7).
//
// Per output pixel and layer m the kernel computes, in the operation order
// of the staged plain path (ops/packed_warp.py packed_composite_plain =
// warp_plain, warp_alpha_vectors, combine_rgb, v210_pack_plain):
//   rgb_m = warp(a) * mix + warp(b) * (1 - mix)     (phn::sample, as csrc/warp.cu)
//   alpha_m = wy[y] * wx[x]                         (the separable warp alpha)
//   out = rgb_0;  out = out * (1 - alpha_m) + rgb_m  for m >= 1
// then the v210 encode and packing of csrc/v210_pack.cu.  With -fmad=false it equals
// K4 + combine_rgb + K2 on the card to the bit, and the plain version up
// to the pack's powf rounding.  The TPU kernel premixes the two sources
// before one warp and runs the warp as bf16 hi/lo products (~2^-17); the
// port keeps the staged order, which its plain version and tests share.
//
// Bound: device-memory bytes.  Each source texel the layers' matrices
// reach is read once (neighbouring pixels' taps share cache lines, so L1
// and L2 serve the overlap) and 16/6 bytes of words are written per pixel;
// no intermediate frame, alpha plane or composite touches device memory,
// where the staged path writes and re-reads a warped frame per layer and
// the composite.  Design: a block covers 192 pixels of one row (32 v210
// groups).  Each thread composites one pixel in registers and encodes it
// (luma for every pixel, chroma for even ones) into shared memory; then 32
// threads assemble one group's four words each and write them with one
// 16-byte store.  Matrices and mixes are read from device memory, so
// animating them needs no host synchronisation.
#include "phn_common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxSrcs = 2 * kMaxLayers;
constexpr int kGroupsPerBlock = 32;
constexpr int kPixelsPerBlock = 6 * kGroupsPerBlock;

struct Layers {
  const float* src[kMaxSrcs];  // bottom..top, n_src per layer
  const float* mat[kMaxLayers];  // (3, 3) each
  const float* mix[kMaxLayers];  // one float each; null for a cut
  int n_src[kMaxLayers];  // 1 cut, 2 dissolve pair
  int n_layers;
};

__global__ void packed_composite_kernel(Layers L, int4* __restrict__ words, phn::Encode e,
                                        int width, int height, int groups) {
  __shared__ unsigned ys[kPixelsPerBlock];
  __shared__ unsigned cb[kPixelsPerBlock / 2];
  __shared__ unsigned cr[kPixelsPerBlock / 2];

  const int t = threadIdx.x;
  const int row = blockIdx.y;
  const int x = blockIdx.x * kPixelsPerBlock + t;
  unsigned yc = 0, cbc = 0, crc = 0;
  if (x < width) {
    const size_t plane = static_cast<size_t>(width) * height;
    float out[3] = {0.0f, 0.0f, 0.0f};
    int s = 0;
    for (int m = 0; m < L.n_layers; ++m) {
      const phn::Taps tp = phn::axis_taps(L.mat[m], x, row, width, height);
      // warp(ones): (row-weight sum) x (column-weight sum), ops/warp.py
      // warp_alpha_vectors
      const float wy = (tp.vy0 ? 1.0f - tp.fy : 0.0f) + (tp.vy1 ? tp.fy : 0.0f);
      const float wx = (tp.vx0 ? 1.0f - tp.fx : 0.0f) + (tp.vx1 ? tp.fx : 0.0f);
      const float k = 1.0f - wy * wx;
      const bool pair = L.n_src[m] == 2;
      const float mx = pair ? *L.mix[m] : 1.0f;
      const float* a = L.src[s];
      const float* b = pair ? L.src[s + 1] : nullptr;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = phn::sample(a + c * plane, width, tp);
        if (pair) {
          const float vb = phn::sample(b + c * plane, width, tp);
          v = v * mx + vb * (1.0f - mx);
        }
        out[c] = m == 0 ? v : out[c] * k + v;
      }
      s += L.n_src[m];
    }
    const float rp = phn::l2g(e.g, out[0]);
    const float gp = phn::l2g(e.g, out[1]);
    const float bp = phn::l2g(e.g, out[2]);
    yc = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
    if ((x & 1) == 0) {
      cbc = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
      crc = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
    }
  }
  ys[t] = yc;
  if ((t & 1) == 0) {
    cb[t / 2] = cbc;
    cr[t / 2] = crc;
  }
  __syncthreads();

  const int gi = blockIdx.x * kGroupsPerBlock + t;
  if (t >= kGroupsPerBlock || gi >= groups) return;
  words[static_cast<size_t>(row) * groups + gi] =
      phn::v210_group(ys + 6 * t, cb + 3 * t, cr + 3 * t);
}

}  // namespace

// srcs: n_srcs (3, height, width) float32 frames, bottom..top; mats:
// n_layers (3, 3) float32; mixes: n_layers pointers to one float32 (null
// for a cut); n_src: n_layers entries of 1 or 2 summing to n_srcs.
// words: (height, groups*4) int32.  coeffs: col[12], l2g[6].
// Returns cudaGetLastError().
extern "C" int phn_packed_composite(const void* const* srcs, const void* const* mats,
                                    const void* const* mixes, const int* n_src, int n_layers,
                                    void* words, int width, int height, int groups,
                                    const float* coeffs, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  Layers L{};
  L.n_layers = n_layers;
  int s = 0;
  for (int m = 0; m < n_layers; ++m) {
    if (n_src[m] != 1 && n_src[m] != 2) return static_cast<int>(cudaErrorInvalidValue);
    if (n_src[m] == 2 && mixes[m] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    L.n_src[m] = n_src[m];
    L.mat[m] = static_cast<const float*>(mats[m]);
    L.mix[m] = static_cast<const float*>(mixes[m]);
    for (int r = 0; r < n_src[m]; ++r, ++s) L.src[s] = static_cast<const float*>(srcs[s]);
  }
  const dim3 block(kPixelsPerBlock);
  const dim3 grid((groups + kGroupsPerBlock - 1) / kGroupsPerBlock, height);
  packed_composite_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<int4*>(words), phn::encode_from(coeffs), width, height, groups);
  return static_cast<int>(cudaGetLastError());
}
