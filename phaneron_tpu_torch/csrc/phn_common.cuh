// Shared device helpers for the channel-frame kernels: OpenCL-style
// rounding, the analytic transfer functions and the YCbCr decode.
//
// Every expression keeps the operation order of the plain PyTorch
// versions (phaneron_tpu_torch/ops/gamma.py, ops/colorspace.py), and the
// library is compiled with -fmad=false (ops/_build.py): each multiply and
// add rounds on its own, as on the CPU, so a kernel differs from its plain
// version only where CUDA's powf and the host's pow round differently.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace phn {

constexpr unsigned kField = 0x3FFu;  // one 10-bit v210 field

// gamma'->linear literals, in the order of ops/gamma.py g2l_constants
struct G2L {
  float inv_max, beta, inv_delta, alpha_m1, inv_alpha, inv_gamma;
};

// linear->gamma' literals, in the order of ops/gamma.py l2g_constants
struct L2G {
  float inv_max, beta, delta, alpha, alpha_m1, gamma;
};

// YCbCr code -> linear RGB: 3x4 colour matrix (rows R', G', B' over
// (Y, U, V, 1)), transfer function, 3x3 gamut matrix
struct Decode {
  float col[12];
  float gamut[9];
  G2L g;
};

// linear RGB -> YCbCr code: transfer function, 3x4 matrix (rows Y, U, V
// over (R', G', B', 1))
struct Encode {
  float col[12];
  L2G g;
};

// convert_ushort_sat_rte: round half to even, clamp to [0, 65535]
__device__ __forceinline__ int u16_sat_rte(float x) {
  return static_cast<int>(fminf(fmaxf(rintf(x), 0.0f), 65535.0f));
}

// The transfer function at the LUT cell the reference would index,
// lut[u16_sat_rte(x * 65535)], evaluated analytically
__device__ __forceinline__ float g2l(const G2L& g, float x) {
  float fi = static_cast<float>(u16_sat_rte(x * 65535.0f)) * g.inv_max;
  if (fi < g.beta) return fi * g.inv_delta;
  return powf((fi + g.alpha_m1) * g.inv_alpha, g.inv_gamma);
}

__device__ __forceinline__ float l2g(const L2G& g, float x) {
  float fi = static_cast<float>(u16_sat_rte(x * 65535.0f)) * g.inv_max;
  if (fi < g.beta) return fi * g.delta;
  return g.alpha * powf(fi, g.gamma) - g.alpha_m1;
}

__device__ __forceinline__ void decode(const Decode& d, float yf, float uf, float vf,
                                       float rgb[3]) {
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float gam = d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf +
                d.col[4 * c + 3];
    lin[c] = g2l(d.g, gam);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] +
             d.gamut[3 * c + 2] * lin[2];
  }
}

// One code row of the encode matrix, rounded and saturated
__device__ __forceinline__ int encode_row(const Encode& e, int c, float rp, float gp,
                                          float bp) {
  return u16_sat_rte(e.col[4 * c] * rp + e.col[4 * c + 1] * gp + e.col[4 * c + 2] * bp +
                     e.col[4 * c + 3]);
}

inline Decode decode_from(const float* coeffs) {
  // coeffs: col[12], gamut[9], g2l[6] (ops/kernels.py _decode_coeffs)
  Decode d;
  for (int i = 0; i < 12; ++i) d.col[i] = coeffs[i];
  for (int i = 0; i < 9; ++i) d.gamut[i] = coeffs[12 + i];
  d.g = G2L{coeffs[21], coeffs[22], coeffs[23], coeffs[24], coeffs[25], coeffs[26]};
  return d;
}

inline Encode encode_from(const float* coeffs) {
  // coeffs: col[12], l2g[6] (ops/kernels.py _encode_coeffs)
  Encode e;
  for (int i = 0; i < 12; ++i) e.col[i] = coeffs[i];
  e.g = L2G{coeffs[12], coeffs[13], coeffs[14], coeffs[15], coeffs[16], coeffs[17]};
  return e;
}

}  // namespace phn
