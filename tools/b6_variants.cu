// B6's suspects told apart (tools/kernel_variants.py b6): the packed warp
// in its first thread mapping (csrc/packed_warp.cu before its redesign:
// one thread an output pixel in 32x8 blocks, every valid tap decoded where
// it is used, four decodes a source and pixel), whole and with one part
// taken out or changed:
//   part 0: whole
//   part 1: stores only (no taps, no loads: a value made from the position)
//   part 2: the taps, the lerps and the mix, each tap's RGB made from the
//           tap's position in place of its word load and decode
//   part 3: whole without the gamma'->linear gather (the table index
//           scaled in its place)
// Part 0 computes the kernel's function; 1-3 are timed only.
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

// phn::v210_texel with the gather replaced by the index it would read
__device__ __forceinline__ void texel_no_gather(const int4* __restrict__ words, int groups, int x,
                                                int y, const phn::Decode& d, float rgb[3]) {
  const int4 w = __ldg(words + static_cast<size_t>(y) * groups + x / 6);
  unsigned yc, cb, cr;
  phn::v210_fields(w, x % 6, yc, cb, cr);
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gam = d.col[4 * c] * static_cast<float>(yc) + d.col[4 * c + 1] * static_cast<float>(cb) +
                      d.col[4 * c + 2] * static_cast<float>(cr) + d.col[4 * c + 3];
    lin[c] = static_cast<float>(phn::u16_sat_rte(gam * 65535.0f)) * (1.0f / 65535.0f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
}

template <int kPart>
__device__ __forceinline__ void texel(const int4* __restrict__ words, int groups, int x, int y,
                                      const phn::Decode& d, float rgb[3]) {
  if (kPart == 2) {
    const float q = static_cast<float>(x + 3 * y);
    rgb[0] = q;
    rgb[1] = q + 0.5f;
    rgb[2] = q + 0.25f;
  } else if (kPart == 3) {
    texel_no_gather(words, groups, x, y, d, rgb);
  } else {
    phn::v210_texel(words, groups, x, y, d, rgb);
  }
}

template <int kPart>
__device__ __forceinline__ void sample_part(const int4* __restrict__ words, int groups,
                                            const phn::Decode& d, const phn::Taps& t,
                                            float out[3]) {
  float v[4][3] = {};
  if (t.vx0 && t.vy0) texel<kPart>(words, groups, t.x0, t.y0, d, v[0]);
  if (t.vx0 && t.vy1) texel<kPart>(words, groups, t.x0, t.y0 + 1, d, v[1]);
  if (t.vx1 && t.vy0) texel<kPart>(words, groups, t.x0 + 1, t.y0, d, v[2]);
  if (t.vx1 && t.vy1) texel<kPart>(words, groups, t.x0 + 1, t.y0 + 1, d, v[3]);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = phn::bilerp(t, v[0][c], v[1][c], v[2][c], v[3][c]);
}

template <int kPart>
__global__ void b6_old_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                              const float* __restrict__ mat_a, const float* __restrict__ mat_b,
                              const float* __restrict__ mix, float* __restrict__ out,
                              phn::Decode d, int width, int height, int groups) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  if (kPart == 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane + o] = static_cast<float>(x + c) * 0.25f + y;
    return;
  }
  const phn::Taps ta = phn::axis_taps(mat_a, x, y, width, height);
  float v[4];
  sample_part<kPart>(a, groups, d, ta, v);
  v[3] = phn::bilerp(ta, 1.0f, 1.0f, 1.0f, 1.0f);
  if (b != nullptr) {
    const phn::Taps tb = phn::axis_taps(mat_b, x, y, width, height);
    float vb[4];
    sample_part<kPart>(b, groups, d, tb, vb);
    vb[3] = phn::bilerp(tb, 1.0f, 1.0f, 1.0f, 1.0f);
    const float m = *mix;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = v[c] * m + vb[c] * (1.0f - m);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * plane + o] = v[c];
}

}  // namespace

// The arguments of the old phn_packed_warp after the part.  Returns
// cudaGetLastError().
extern "C" int b6_old_mapping(int part, const void* a, const void* b, const void* mat_a,
                              const void* mat_b, const void* mix, void* out, int width, int height,
                              int groups, const float* coeffs, const float* g2l, void* stream) {
  if (b != nullptr && (mat_b == nullptr || mix == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto wa = static_cast<const int4*>(a), wb = static_cast<const int4*>(b);
  const auto ma = static_cast<const float*>(mat_a), mb = static_cast<const float*>(mat_b);
  const auto fmix = static_cast<const float*>(mix);
  const auto o = static_cast<float*>(out);
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  switch (part) {
    case 0: b6_old_kernel<0><<<grid, block, 0, st>>>(wa, wb, ma, mb, fmix, o, d, width, height, groups); break;
    case 1: b6_old_kernel<1><<<grid, block, 0, st>>>(wa, wb, ma, mb, fmix, o, d, width, height, groups); break;
    case 2: b6_old_kernel<2><<<grid, block, 0, st>>>(wa, wb, ma, mb, fmix, o, d, width, height, groups); break;
    case 3: b6_old_kernel<3><<<grid, block, 0, st>>>(wa, wb, ma, mb, fmix, o, d, width, height, groups); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
