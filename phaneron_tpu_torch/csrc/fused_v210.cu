// B3 fused_v210: the top v210 layer of a channel without DVE, as a cut or
// a dissolve between two clips, from source words to output words in one
// launch: decode -> optional dissolve a * mix + b * (1 - mix) -> 'over'
// black -> encode -> v210.
//
// Replaces phaneron_tpu/ops/pallas_kernels.py:make_fused_v210_program
// (_make_kernel), which the JAX package's make_channel_program selects
// through supported_spec whenever the top layer is such a layer: a v210
// source decodes opaque, so the top layer covers every layer below it and
// 'over' black is the identity on its RGB (0 * (1 - alpha) + rgb).
//
// The decode is phn::decode_v210 (the one K1 runs), the dissolve the
// order of ops/composite.py mix_frames, the encode that of K2 (csrc/
// combine_pack.cu; tail fields past the frame width and groups in the pitch
// pad pack as zero).  So the kernel equals its plain version (K1 plain ->
// mix_frames -> combine over black -> K2 plain) up to the pack's powf
// rounding, and K1 -> K2 on the card to the bit.
//
// Bound: device-memory bytes.  Per pixel it reads 16/6 bytes of words per
// source and writes 16/6 bytes of words; nothing else touches device
// memory, where the staged path writes and re-reads 16 bytes of RGBA per
// source pixel.  What set the first design's time was arithmetic, not
// memory: the three full-precision powf of a pixel's linear->gamma' were
// half of it (tools/kernel_variants.py b3; PERF.md).  Design: both
// transfers are functions of a 16-bit table index i, so their value at
// every index is known in advance.  The kernel computes linear->gamma'
// with two MUFU operations (ex2 and lg2 of the formula) and moves the
// result's bits by a signed byte a table index, the difference to powf's
// bits, which phn_l2g_corrections (csrc/l2g_corrections.cu) computes on
// the card with the same instructions: equal to powf, and so to K2, to the
// bit.
// gamma'->linear is a gather from the g2l table, cheap where a warp's
// indices lie close together (video, and the L1 cache holds their part of
// the 256 KB table) and slow where they do not (full-range random words);
// so each warp looks at the spread of a source's indices in a tile and
// takes either the gather or, like linear->gamma', two MUFU operations and
// a byte of correction, equal to the table to the bit either way.  The two
// correction tables (64 KB each) sit in shared memory: one persistent
// block an SM copies them once, then walks tiles of 32 groups by kRows
// rows, one thread a 6-pixel group: one 16-byte load per source and one
// 16-byte store, the six pixels decoded, mixed and encoded in registers.
// The mix is read from device memory, so animating it needs no host
// synchronisation.
#include "phn_common.cuh"

namespace {

// the transfers' shared helpers (phn_common.cuh: linear->gamma' without
// powf)
using phn::index_of;
using phn::kTable;
using phn::l2g_corrected;
using phn::moved;
using phn::pow_approx;
using phn::u16_rte;

constexpr int kRows = 32;  // tile rows; a block is 32 x kRows threads
constexpr int kBlocksPerSm = 1;
constexpr int kThreads = phn::kGroupsPerBlock * kRows;
constexpr int kSmemBytes = 2 * kTable;  // l2g corrections, then g2l corrections
constexpr int kGatherSpan = 8192;  // a warp gathers g2l when its indices span at most this many

// gamma'->linear in the g2l table's float32 expressions (ops/gamma.py
// g2l_table): fi below thr -> fi * inv_delta, else
// ((fi + a1) * inv_alpha) ** inv_gamma
struct G2L {
  float inv_max, thr, inv_delta, a1, inv_alpha, inv_gamma;
};

__device__ __forceinline__ float g2l_approx(const G2L& g, int i) {
  const float fi = static_cast<float>(i) * g.inv_max;
  if (fi < g.thr) return fi * g.inv_delta;
  return pow_approx((fi + g.a1) * g.inv_alpha, g.inv_gamma);
}

// gamma' of channel c from the codes, in phn::decode's expressions, but
// R' without its Cb term and B' without its Cr term: their coefficients
// are +-0 in every colour matrix (ops/colour_maths.py ycbcr2rgb_matrix;
// phn_fused_v210 refuses others), and a zero term of a finite code adds
// nothing, so leaving them out changes no bit.
__device__ __forceinline__ float gamma_of(const phn::Decode& d, int c, float yf, float uf, float vf) {
  if (c == 0) return d.col[0] * yf + d.col[2] * vf + d.col[3];
  if (c == 2) return d.col[8] * yf + d.col[9] * uf + d.col[11];
  return d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf + d.col[4 * c + 3];
}

// phn::decode_v210, the g2l table's cell gathered (kGather) or from
// g2l_approx and the index's correction
template <bool kGather>
__device__ __forceinline__ void decode_px(const phn::Decode& d, const G2L& g, const signed char* corr,
                                         const int4& w, int p, float rgb[3]) {
  unsigned y, cb, cr;
  phn::v210_fields(w, p, y, cb, cr);
  const float yf = static_cast<float>(y), uf = static_cast<float>(cb), vf = static_cast<float>(cr);
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int i = index_of(gamma_of(d, c, yf, uf, vf));
    lin[c] = kGather ? __ldg(d.g2l + i) : moved(g2l_approx(g, i), corr, i);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
}

__device__ __forceinline__ void decode_pixel(const phn::Decode& d, const G2L& g, const signed char* corr,
                                            bool gather, const int4& w, int p, float rgb[3]) {
  if (gather) {
    decode_px<true>(d, g, corr, w, p, rgb);
  } else {
    decode_px<false>(d, g, corr, w, p, rgb);
  }
}

// Whether the warp's g2l indices of the words w lie close together: the
// span of the green channel's index of the groups' first pixels
__device__ __forceinline__ bool gathers(const phn::Decode& d, const int4& w) {
  unsigned y, cb, cr;
  phn::v210_fields(w, 0, y, cb, cr);
  const unsigned i = index_of(gamma_of(d, 1, static_cast<float>(y), static_cast<float>(cb),
                                              static_cast<float>(cr)));
  const unsigned lanes = __activemask();
  return static_cast<int>(__reduce_max_sync(lanes, i) - __reduce_min_sync(lanes, i)) <= kGatherSpan;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fused_v210_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                      const float* __restrict__ mix, int4* __restrict__ out,
                      const __grid_constant__ phn::Decode d, const __grid_constant__ phn::Encode e,
                      const __grid_constant__ G2L g2l, const int4* __restrict__ corrections,
                      int width, int height, int groups) {
  extern __shared__ int4 tables[];  // kSmemBytes of corrections
  const signed char* l2g_corr = reinterpret_cast<const signed char*>(tables);
  const signed char* g2l_corr = l2g_corr + kTable;
  for (int i = threadIdx.y * phn::kGroupsPerBlock + threadIdx.x; i < kSmemBytes / 16; i += kThreads)
    phn::cp_async16(tables + i, corrections + i);
  phn::cp_async_commit();
  phn::cp_async_wait<0>();
  __syncthreads();

  const int tiles_x = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock;
  const int n_tiles = tiles_x * ((height + kRows - 1) / kRows);
  const float m = b != nullptr ? __ldg(mix) : 1.0f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int gi = (tile % tiles_x) * phn::kGroupsPerBlock + threadIdx.x;
    const int row = (tile / tiles_x) * kRows + threadIdx.y;
    if (gi >= groups || row >= height) continue;
    const size_t at = static_cast<size_t>(row) * groups + gi;
    const int4 wa = __ldg(a + at);
    const int4 wb = b != nullptr ? __ldg(b + at) : wa;
    const bool gather_a = gathers(d, wa), gather_b = b != nullptr && gathers(d, wb);
    unsigned ys[6] = {0, 0, 0, 0, 0, 0};
    unsigned cb[3] = {0, 0, 0};
    unsigned cr[3] = {0, 0, 0};
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (gi * 6 + p >= width) break;
      float rgb[3];
      decode_pixel(d, g2l, g2l_corr, gather_a, wa, p, rgb);
      if (b != nullptr) {
        float rgb_b[3];
        decode_pixel(d, g2l, g2l_corr, gather_b, wb, p, rgb_b);
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * m + rgb_b[c] * (1.0f - m);
      }
      const float rp = l2g_corrected(e.g, l2g_corr, rgb[0]);
      const float gp = l2g_corrected(e.g, l2g_corr, rgb[1]);
      const float bp = l2g_corrected(e.g, l2g_corr, rgb[2]);
      ys[p] = static_cast<unsigned>(u16_rte(e.col[0] * rp + e.col[1] * gp + e.col[2] * bp + e.col[3])) & phn::kField;
      if ((p & 1) == 0) {
        cb[p / 2] = static_cast<unsigned>(u16_rte(e.col[4] * rp + e.col[5] * gp + e.col[6] * bp + e.col[7])) & phn::kField;
        cr[p / 2] = static_cast<unsigned>(u16_rte(e.col[8] * rp + e.col[9] * gp + e.col[10] * bp + e.col[11])) & phn::kField;
      }
    }
    out[at] = phn::v210_group(ys, cb, cr);
  }
}

// corr[i]: gamma'->linear, bits(table[i]) - bits(g2l_approx) (the
// linear->gamma' half is csrc/l2g_corrections.cu's)
__global__ void corrections_kernel(G2L g2l, const float* __restrict__ table, signed char* __restrict__ corr,
                                   int* __restrict__ bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTable) return;
  corr[i] = phn::correction(table[i], g2l_approx(g2l, i), bad);
}

G2L g2l_from(const float* c) { return G2L{c[0], c[1], c[2], c[3], c[4], c[5]}; }

}  // namespace

// corr: 65536 bytes in device memory, filled with the corrections of the
// decode's gamma'->linear (g2l: its table in device memory; g2l_consts:
// inv_max, thr, inv_delta, a1, inv_alpha, inv_gamma, the table's float32
// constants); bad: one int32 in device memory, set to the count of
// indices whose correction a byte cannot hold (0 expected).  Returns
// cudaGetLastError().
extern "C" int phn_fused_v210_corrections(void* corr, void* bad, const float* g2l, const float* g2l_consts,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  corrections_kernel<<<kTable / 256, 256, 0, st>>>(g2l_from(g2l_consts), g2l, static_cast<signed char*>(corr),
                                                   static_cast<int*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// a, b: (height, groups*4) int32 v210 words (b null for a cut); mix: one
// float32 in device memory (ignored for a cut); out: like a.
// dec_coeffs: col[12] (R' without Cb and B' without Cr: col[1] and
// col[10] zero, else cudaErrorInvalidValue), gamut[9]; g2l: the gamma'->linear table in device
// memory; enc_coeffs: col[12], l2g[6]; g2l_consts: as
// phn_fused_v210_corrections takes them; corr: 2 * 65536 bytes (16-byte
// aligned), the encode's l2g corrections (phn_l2g_corrections), then the
// decode's g2l ones (phn_fused_v210_corrections).
// Returns cudaGetLastError().
extern "C" int phn_fused_v210(const void* a, const void* b, const void* mix, void* out,
                              int width, int height, int groups, const float* dec_coeffs,
                              const float* g2l, const float* enc_coeffs, const float* g2l_consts,
                              const void* corr, void* stream) {
  if ((b != nullptr && mix == nullptr) || corr == nullptr || dec_coeffs[1] != 0.0f ||
      dec_coeffs[10] != 0.0f)
    return static_cast<int>(cudaErrorInvalidValue);
  static int resident[phn::kMaxDevices];
  cudaError_t err;
  const int wave = phn::resident_blocks(fused_v210_kernel, kThreads, kSmemBytes, resident, &err);
  if (wave == 0) return static_cast<int>(err);
  const int n_tiles = ((groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock) *
                      ((height + kRows - 1) / kRows);
  fused_v210_kernel<<<min(n_tiles, wave), dim3(phn::kGroupsPerBlock, kRows), kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), static_cast<const int4*>(b),
      static_cast<const float*>(mix), static_cast<int4*>(out),
      phn::decode_from(dec_coeffs, g2l), phn::encode_from(enc_coeffs), g2l_from(g2l_consts),
      static_cast<const int4*>(corr), width, height, groups);
  return static_cast<int>(cudaGetLastError());
}
