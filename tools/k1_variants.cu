// K1's suspects told apart (tools/kernel_variants.py): the v210 unpack in
// two thread mappings, each whole and with one part taken out.
//   mapping 0: one thread per 6-pixel group, six pixels stored per plane
//              24 bytes apart from each lane (K1 before its redesign)
//   mapping 1: one thread per pixel, each plane stored by consecutive
//              threads (csrc/v210_unpack.cu)
//   part 0: the whole unpack (3 channels); 1: the stores only (a constant
//   decode, no loads); 2: the decode only (no stores); 3: no
//   gamma'->linear gather (the table index scaled instead)
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

template <int kPart>
__device__ __forceinline__ void unpack_px(const phn::Decode& d, unsigned y, unsigned cb,
                                          unsigned cr, float rgb[3]) {
  if (kPart == 1) {
    rgb[0] = 0.25f;
    rgb[1] = 0.5f;
    rgb[2] = 0.75f;
  } else if (kPart == 3) {
    const float yf = static_cast<float>(y), uf = static_cast<float>(cb), vf = static_cast<float>(cr);
    float lin[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gam = d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf + d.col[4 * c + 3];
      lin[c] = static_cast<float>(phn::u16_sat_rte(gam * 65535.0f)) * 1.52590219e-05f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
  } else {
    phn::decode(d, static_cast<float>(y), static_cast<float>(cb), static_cast<float>(cr), rgb);
  }
}

// the decode-only part keeps its result alive with a store no pixel takes
template <int kPart>
__device__ __forceinline__ void store_px(float* o, size_t plane, const float rgb[3], float& acc) {
  if (kPart == 2) {
    acc += rgb[0] + rgb[1] + rgb[2];
  } else {
    o[0] = rgb[0];
    o[plane] = rgb[1];
    o[2 * plane] = rgb[2];
  }
}

template <int kPart>
__global__ void group_kernel(const int4* words, float* out, const __grid_constant__ phn::Decode d,
                             int width, int height, int groups) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const int x0 = gi * 6;
  if (gi >= groups || x0 >= width) return;
  const size_t plane = static_cast<size_t>(width) * height;
  float* o = out + static_cast<size_t>(blockIdx.y) * width;
  const int4 w = kPart == 1 ? int4{} : words[static_cast<size_t>(blockIdx.y) * groups + gi];
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    if (x0 + p >= width) break;
    unsigned y, cb, cr;
    phn::v210_fields(w, p, y, cb, cr);
    float rgb[3];
    unpack_px<kPart>(d, y, cb, cr, rgb);
    store_px<kPart>(o + x0 + p, plane, rgb, acc);
  }
  if (kPart == 2 && acc == -1.0f) o[x0] = acc;
}

template <int kPart>
__global__ void pixel_kernel(const int4* words, float* out, const __grid_constant__ phn::Decode d,
                             int width, int height, int groups) {
  constexpr int kRows = 4;
  const int t = threadIdx.x;
  const int x = blockIdx.x * phn::kPixelsPerBlock + t;
  if (x >= width) return;
  const int g = blockIdx.x * phn::kGroupsPerBlock + t / 6, p = t % 6;
  const size_t plane = static_cast<size_t>(width) * height;
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = blockIdx.y * kRows + r;
    if (row >= height) break;
    const int4 w = kPart == 1 ? int4{} : __ldg(words + static_cast<size_t>(row) * groups + g);
    unsigned y, cb, cr;
    phn::v210_fields_lane(w, p, y, cb, cr);
    float rgb[3];
    unpack_px<kPart>(d, y, cb, cr, rgb);
    store_px<kPart>(out + static_cast<size_t>(row) * width + x, plane, rgb, acc);
  }
  if (kPart == 2 && acc == -1.0f) out[x] = acc;
}

template <int kPart>
void launch(int mapping, const int4* w, float* o, const phn::Decode& d, int width, int height,
            int groups, cudaStream_t st) {
  if (mapping == 0) {
    group_kernel<kPart><<<dim3((groups + 127) / 128, height), 128, 0, st>>>(w, o, d, width, height,
                                                                          groups);
  } else {
    pixel_kernel<kPart><<<dim3((width + phn::kPixelsPerBlock - 1) / phn::kPixelsPerBlock,
                               (height + 3) / 4),
                          phn::kPixelsPerBlock, 0, st>>>(w, o, d, width, height, groups);
  }
}

}  // namespace

// words: (height, groups*4) int32; out: (3, height, width) float32;
// coeffs, g2l: as phn_v210_unpack.  Returns cudaGetLastError().
extern "C" int k1_variant(int mapping, int part, const void* words, void* out, int width, int height,
                          int groups, const float* coeffs, const float* g2l, void* stream) {
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  const int4* w = static_cast<const int4*>(words);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (part) {
    case 0: launch<0>(mapping, w, o, d, width, height, groups, st); break;
    case 1: launch<1>(mapping, w, o, d, width, height, groups, st); break;
    case 2: launch<2>(mapping, w, o, d, width, height, groups, st); break;
    case 3: launch<3>(mapping, w, o, d, width, height, groups, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
