// B3's suspects told apart (tools/kernel_variants.py b3): the fused v210
// program in its first thread mapping (one thread per 6-pixel group, the
// six pixels decoded, mixed and encoded in a loop that breaks at the frame
// width, linear->gamma' by powf; csrc/fused_v210.cu before its redesign),
// whole and with one part taken out or changed, and two other designs:
//   part 0: whole
//   part 1: stores only (no loads, no decode, no encode: a constant group)
//   part 2: no gamma'->linear gather (the table index scaled instead)
//   part 3: no linear->gamma' powf (the linear segment's expression for
//           every code)
//   part 4: no width break for full groups (the loop unrolled without it
//           where all six pixels lie inside the frame)
//   part 5: one thread a pixel (K1's decode, phn::v210_fields_lane) in
//           blocks of 192 pixels by 2 rows, the block's codes packed from
//           shared memory as phn::encode_pack_block packs them
//   part 6: part 0 with linear->gamma' gathered from a float32 table of
//           its value at all 65536 indices in device memory (b3_l2g_table)
//   parts 7-9: one thread a pixel as part 5, with the transfers of
//           csrc/fused_v210.cu (included below): MUFU approximations moved
//           to the exact value by the corrections, a warp gathering
//           gamma'->linear where its indices lie close; part 7 in
//           persistent blocks of 192 pixels by 5 rows with the corrections
//           in shared memory (one block an SM, as the built kernel), parts
//           8 and 9 in blocks of 192 by 2 and by 4 rows that read the
//           corrections from device memory through L1 (no shared-memory
//           table: as many blocks an SM as registers allow)
// Parts 0 and 4-9 compute the kernel's function; 1-3 are timed only.
#include "../phaneron_tpu_torch/csrc/fused_v210.cu"

namespace {

template <int kPart>
__device__ __forceinline__ void old_decode_px(const phn::Decode& d, const int4& w, int p, float rgb[3]) {
  unsigned y, cb, cr;
  phn::v210_fields(w, p, y, cb, cr);
  const float yf = static_cast<float>(y), uf = static_cast<float>(cb), vf = static_cast<float>(cr);
  if (kPart != 2) {
    phn::decode(d, yf, uf, vf, rgb);
    return;
  }
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gam = d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf + d.col[4 * c + 3];
    lin[c] = static_cast<float>(phn::u16_sat_rte(gam * 65535.0f)) * 1.52590219e-05f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
}

template <int kPart>
__device__ __forceinline__ float l2g_px(const phn::L2G& g, const float* lut, float x) {
  if (kPart == 6) return __ldg(lut + phn::u16_sat_rte(x * 65535.0f));
  if (kPart != 3) return phn::l2g(g, x);
  const float fi = static_cast<float>(phn::u16_sat_rte(x * 65535.0f)) * g.inv_max;
  return fi * g.delta;
}

// pixel p of the group: decode, mix, encode into the group's codes
template <int kPart>
__device__ __forceinline__ void pixel(const phn::Decode& d, const phn::Encode& e, const float* lut,
                                      const int4& wa, const int4& wb, bool pair, float m, int p,
                                      unsigned ys[6], unsigned cb[3], unsigned cr[3]) {
  float rgb[3];
  old_decode_px<kPart>(d, wa, p, rgb);
  if (pair) {
    float rgb_b[3];
    old_decode_px<kPart>(d, wb, p, rgb_b);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * m + rgb_b[c] * (1.0f - m);
  }
  const float rp = l2g_px<kPart>(e.g, lut, rgb[0]);
  const float gp = l2g_px<kPart>(e.g, lut, rgb[1]);
  const float bp = l2g_px<kPart>(e.g, lut, rgb[2]);
  ys[p] = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
  if ((p & 1) == 0) {
    cb[p / 2] = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
    cr[p / 2] = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
  }
}

template <int kPart>
__global__ void group_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                             const float* __restrict__ mix, int4* __restrict__ out,
                             phn::Decode d, phn::Encode e, const float* __restrict__ lut, int width,
                             int height, int groups) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (gi >= groups) return;
  const size_t at = static_cast<size_t>(row) * groups + gi;
  if (kPart == 1) {
    out[at] = make_int4(gi, row, width, height);
    return;
  }
  const int4 wa = a[at];
  const int4 wb = b != nullptr ? b[at] : wa;
  const float m = b != nullptr ? *mix : 1.0f;
  unsigned ys[6] = {0, 0, 0, 0, 0, 0};
  unsigned cb[3] = {0, 0, 0};
  unsigned cr[3] = {0, 0, 0};
  if (kPart == 4 && gi * 6 + 6 <= width) {
#pragma unroll
    for (int p = 0; p < 6; ++p) pixel<kPart>(d, e, lut, wa, wb, b != nullptr, m, p, ys, cb, cr);
  } else {
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (gi * 6 + p >= width) break;
      pixel<kPart>(d, e, lut, wa, wb, b != nullptr, m, p, ys, cb, cr);
    }
  }
  out[at] = phn::v210_group(ys, cb, cr);
}

// one thread a pixel: K1's decode, then the row segments' encode and pack
__global__ void pixel_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                             const float* __restrict__ mix, int4* __restrict__ out,
                             const __grid_constant__ phn::Decode d,
                             const __grid_constant__ phn::Encode e, int width, int height,
                             int groups) {
  constexpr int kRows = 2;
  __shared__ unsigned ys[kRows][phn::kPixelsPerBlock];
  __shared__ unsigned cbs[kRows][phn::kPixelsPerBlock / 2];
  __shared__ unsigned crs[kRows][phn::kPixelsPerBlock / 2];
  const int t = threadIdx.x, s = threadIdx.y;
  const int x = blockIdx.x * phn::kPixelsPerBlock + t;
  const int row = blockIdx.y * kRows + s;
  unsigned yc = 0, cbc = 0, crc = 0;
  if (x < width && row < height) {
    const size_t at = static_cast<size_t>(row) * groups + blockIdx.x * phn::kGroupsPerBlock + t / 6;
    const int p = t % 6;
    const int4 wa = __ldg(a + at);
    const int4 wb = b != nullptr ? __ldg(b + at) : wa;
    unsigned y, cb, cr;
    float rgb[3];
    phn::v210_fields_lane(wa, p, y, cb, cr);
    phn::decode(d, static_cast<float>(y), static_cast<float>(cb), static_cast<float>(cr), rgb);
    if (b != nullptr) {
      const float m = __ldg(mix);
      float rgb_b[3];
      phn::v210_fields_lane(wb, p, y, cb, cr);
      phn::decode(d, static_cast<float>(y), static_cast<float>(cb), static_cast<float>(cr), rgb_b);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * m + rgb_b[c] * (1.0f - m);
    }
    const float rp = phn::l2g(e.g, rgb[0]);
    const float gp = phn::l2g(e.g, rgb[1]);
    const float bp = phn::l2g(e.g, rgb[2]);
    yc = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
    if ((x & 1) == 0) {
      cbc = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
      crc = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
    }
  }
  ys[s][t] = yc;
  if ((t & 1) == 0) {
    cbs[s][t / 2] = cbc;
    crs[s][t / 2] = crc;
  }
  __syncthreads();
  const int gi = blockIdx.x * phn::kGroupsPerBlock + t;
  if (t >= phn::kGroupsPerBlock || gi >= groups || row >= height) return;
  out[static_cast<size_t>(row) * groups + gi] = phn::v210_group(ys[s] + 6 * t, cbs[s] + 3 * t, crs[s] + 3 * t);
}

// Linear RGB of pixel p of the group whose words are w, in the built
// kernel's expressions (decode_px): gamma'->linear gathered from the table
// where the warp's green indices span at most kGatherSpan, else from
// g2l_approx and the correction; every lane of the warp takes part
__device__ __forceinline__ void decode_lane(const phn::Decode& d, const G2L& g, const signed char* corr,
                                            const int4& w, int p, float rgb[3]) {
  unsigned y, cb, cr;
  phn::v210_fields_lane(w, p, y, cb, cr);
  const float yf = static_cast<float>(y), uf = static_cast<float>(cb), vf = static_cast<float>(cr);
  int idx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) idx[c] = index_of(gamma_of(d, c, yf, uf, vf));
  const unsigned i1 = static_cast<unsigned>(idx[1]);
  const bool gather = static_cast<int>(__reduce_max_sync(0xffffffffu, i1) - __reduce_min_sync(0xffffffffu, i1)) <=
                      kGatherSpan;
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) lin[c] = gather ? __ldg(d.g2l + idx[c]) : moved(g2l_approx(g, idx[c]), corr, idx[c]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
}

// parts 7-9: one thread a pixel, tiles of 192 pixels (32 groups) by
// kPxRows rows walked by persistent blocks; kSmem: the corrections copied
// into shared memory once a block, else read from device memory
template <int kPxRows, bool kSmem>
__global__ void __launch_bounds__(phn::kPixelsPerBlock * kPxRows, 1)
    pixel_corrected_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                           const float* __restrict__ mix, int4* __restrict__ out,
                           const __grid_constant__ phn::Decode d, const __grid_constant__ phn::Encode e,
                           const __grid_constant__ G2L g2l, const int4* __restrict__ corrections,
                           int width, int height, int groups) {
  constexpr int kT = phn::kPixelsPerBlock * kPxRows;
  extern __shared__ int4 tables[];
  __shared__ unsigned ys[kPxRows][phn::kPixelsPerBlock];
  __shared__ unsigned cbs[kPxRows][phn::kPixelsPerBlock / 2];
  __shared__ unsigned crs[kPxRows][phn::kPixelsPerBlock / 2];
  const int t = threadIdx.x, s = threadIdx.y;
  if (kSmem) {
    for (int i = s * phn::kPixelsPerBlock + t; i < kSmemBytes / 16; i += kT)
      phn::cp_async16(tables + i, corrections + i);
    phn::cp_async_commit();
    phn::cp_async_wait<0>();
    __syncthreads();
  }
  const signed char* l2g_corr = reinterpret_cast<const signed char*>(kSmem ? tables : corrections);
  const signed char* g2l_corr = l2g_corr + kTable;
  const int segs = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock;
  const int n_tiles = segs * ((height + kPxRows - 1) / kPxRows);
  const float m = b != nullptr ? __ldg(mix) : 1.0f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int seg = tile % segs;
    const int row = (tile / segs) * kPxRows + s;  // one row a warp: 192 threads are 6 warps
    const int x = seg * phn::kPixelsPerBlock + t;
    const int gi = seg * phn::kGroupsPerBlock + t / 6;
    unsigned yc = 0, cbc = 0, crc = 0;
    if (row < height) {
      const size_t at = static_cast<size_t>(row) * groups + gi;
      const int4 zero = make_int4(0, 0, 0, 0);
      const int4 wa = gi < groups ? __ldg(a + at) : zero;
      const int4 wb = b != nullptr && gi < groups ? __ldg(b + at) : wa;
      float rgb[3];
      decode_lane(d, g2l, g2l_corr, wa, t % 6, rgb);
      if (b != nullptr) {
        float rgb_b[3];
        decode_lane(d, g2l, g2l_corr, wb, t % 6, rgb_b);
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * m + rgb_b[c] * (1.0f - m);
      }
      if (x < width) {
        const float rp = l2g_corrected(e.g, l2g_corr, rgb[0]);
        const float gp = l2g_corrected(e.g, l2g_corr, rgb[1]);
        const float bp = l2g_corrected(e.g, l2g_corr, rgb[2]);
        yc = static_cast<unsigned>(u16_rte(e.col[0] * rp + e.col[1] * gp + e.col[2] * bp + e.col[3])) & phn::kField;
        if ((x & 1) == 0) {
          cbc = static_cast<unsigned>(u16_rte(e.col[4] * rp + e.col[5] * gp + e.col[6] * bp + e.col[7])) & phn::kField;
          crc = static_cast<unsigned>(u16_rte(e.col[8] * rp + e.col[9] * gp + e.col[10] * bp + e.col[11])) & phn::kField;
        }
      }
    }
    ys[s][t] = yc;
    if ((t & 1) == 0) {
      cbs[s][t / 2] = cbc;
      crs[s][t / 2] = crc;
    }
    __syncthreads();
    const int go = seg * phn::kGroupsPerBlock + t;
    if (row < height && t < phn::kGroupsPerBlock && go < groups)
      out[static_cast<size_t>(row) * groups + go] = phn::v210_group(ys[s] + 6 * t, cbs[s] + 3 * t, crs[s] + 3 * t);
    __syncthreads();  // the codes are read before the next tile writes them
  }
}

template <int kPxRows, bool kSmem>
int launch_pixel(const int4* a, const int4* b, const float* mix, int4* out, const phn::Decode& d,
                 const phn::Encode& e, const G2L& g, const int4* corr, int width, int height, int groups,
                 cudaStream_t st) {
  const auto kernel = pixel_corrected_kernel<kPxRows, kSmem>;
  constexpr int smem = kSmem ? kSmemBytes : 0;
  const int n_tiles = ((groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock) *
                      ((height + kPxRows - 1) / kPxRows);
  int blocks = n_tiles;
  if (kSmem) {
    static int resident[phn::kMaxDevices];
    cudaError_t err;
    const int wave = phn::resident_blocks(kernel, phn::kPixelsPerBlock * kPxRows, smem, resident, &err);
    if (wave == 0) return static_cast<int>(err);
    blocks = min(n_tiles, wave);
  }
  kernel<<<blocks, dim3(phn::kPixelsPerBlock, kPxRows), smem, st>>>(a, b, mix, out, d, e, g, corr, width, height,
                                                                    groups);
  return static_cast<int>(cudaGetLastError());
}

// the transfer at every table index, for part 6
__global__ void l2g_table_kernel(phn::L2G g, float* __restrict__ lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536) lut[i] = phn::l2g(g, static_cast<float>(i) / 65535.0f);
}

template <int kPart>
void launch(const int4* a, const int4* b, const float* mix, int4* out, const phn::Decode& d,
            const phn::Encode& e, const float* lut, int width, int height, int groups, cudaStream_t st) {
  group_kernel<kPart><<<dim3((groups + 127) / 128, height), 128, 0, st>>>(a, b, mix, out, d, e, lut, width,
                                                                          height, groups);
}

}  // namespace

// lut: 65536 float32 in device memory, filled with linear->gamma' of the
// encode (enc_coeffs) at every table index, for part 6.  Returns
// cudaGetLastError().
extern "C" int b3_l2g_table(void* lut, const float* enc_coeffs, void* stream) {
  l2g_table_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(phn::encode_from(enc_coeffs).g,
                                                                       static_cast<float*>(lut));
  return static_cast<int>(cudaGetLastError());
}

// The arguments of phn_fused_v210 after the part, with b3_l2g_table's
// table before g2l_consts and the corrections.  Returns
// cudaGetLastError().
extern "C" int b3_variant(int part, const void* a, const void* b, const void* mix, void* out, int width,
                          int height, int groups, const float* dec_coeffs, const float* g2l,
                          const float* enc_coeffs, const void* l2g, const float* g2l_consts,
                          const void* corr, void* stream) {
  const phn::Decode d = phn::decode_from(dec_coeffs, g2l);
  const phn::Encode e = phn::encode_from(enc_coeffs);
  const int4* pa = static_cast<const int4*>(a);
  const int4* pb = static_cast<const int4*>(b);
  const float* m = static_cast<const float*>(mix);
  const float* lut = static_cast<const float*>(l2g);
  int4* o = static_cast<int4*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const G2L g = g2l_from(g2l_consts);
  const int4* c = static_cast<const int4*>(corr);
  switch (part) {
    case 0: launch<0>(pa, pb, m, o, d, e, lut, width, height, groups, st); break;
    case 1: launch<1>(pa, pb, m, o, d, e, lut, width, height, groups, st); break;
    case 2: launch<2>(pa, pb, m, o, d, e, lut, width, height, groups, st); break;
    case 3: launch<3>(pa, pb, m, o, d, e, lut, width, height, groups, st); break;
    case 4: launch<4>(pa, pb, m, o, d, e, lut, width, height, groups, st); break;
    case 5:
      pixel_kernel<<<dim3((groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock, (height + 1) / 2),
                     dim3(phn::kPixelsPerBlock, 2), 0, st>>>(pa, pb, m, o, d, e, width, height, groups);
      break;
    case 6: launch<6>(pa, pb, m, o, d, e, lut, width, height, groups, st); break;
    case 7: return launch_pixel<5, true>(pa, pb, m, o, d, e, g, c, width, height, groups, st);
    case 8: return launch_pixel<2, false>(pa, pb, m, o, d, e, g, c, width, height, groups, st);
    case 9: return launch_pixel<4, false>(pa, pb, m, o, d, e, g, c, width, height, groups, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
