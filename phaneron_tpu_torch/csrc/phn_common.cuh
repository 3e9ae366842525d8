// Shared device helpers for the channel-frame kernels: OpenCL-style
// rounding, the analytic transfer functions, the YCbCr decode and encode,
// the v210 group packing and the axis-aligned bilinear taps.
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

// v210 words of one 6-pixel group from its 10-bit codes (luma of every
// pixel, chroma of the even ones)
__device__ __forceinline__ int4 v210_group(const unsigned ys[6], const unsigned cb[3],
                                           const unsigned cr[3]) {
  int4 w;
  w.x = static_cast<int>((cr[0] << 20) | (ys[0] << 10) | cb[0]);
  w.y = static_cast<int>((ys[2] << 20) | (cb[1] << 10) | ys[1]);
  w.z = static_cast<int>((cb[2] << 20) | (ys[3] << 10) | cr[1]);
  w.w = static_cast<int>((ys[5] << 20) | (cr[2] << 10) | ys[4]);
  return w;
}

// The bilinear taps of output pixel (x, y) under an axis-aligned DVE
// matrix (3, 3), in the order of ops/geometry.py warp_axis_aligned:
// texel coordinates
//   px = (m00 * (x/W - 0.5) + m02 + 0.5) * W - 0.5
//   py = (m11 * (y/H - 0.5) + m12 + 0.5) * H - 0.5
// (pallas_warp.py:541-547, geometry.py:186-196), taps floor and floor+1
// with weight frac; a tap outside the frame is invalid and reads 0.
struct Taps {
  int x0, y0;
  float fx, fy;
  bool vx0, vx1, vy0, vy1;
};

__device__ __forceinline__ Taps axis_taps(const float* mat, int x, int y, int width,
                                          int height) {
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float ix = static_cast<float>(x) / fw - 0.5f;
  const float iy = static_cast<float>(y) / fh - 0.5f;
  const float px = (mat[0] * ix + mat[2] + 0.5f) * fw - 0.5f;
  const float py = (mat[4] * iy + mat[5] + 0.5f) * fh - 0.5f;
  const float flx = floorf(px), fly = floorf(py);
  Taps t;
  t.fx = px - flx;
  t.fy = py - fly;
  t.x0 = static_cast<int>(flx);
  t.y0 = static_cast<int>(fly);
  t.vx0 = t.x0 >= 0 && t.x0 < width;
  t.vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < width;
  t.vy0 = t.y0 >= 0 && t.y0 < height;
  t.vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < height;
  return t;
}

// One (H, W) plane at the taps: the lerp along rows first, then along
// columns.  Row pointers are dereferenced only where the row is valid.
__device__ __forceinline__ float sample(const float* __restrict__ s, int width, const Taps& t) {
  const float* r0 = s + static_cast<ptrdiff_t>(t.y0) * width;
  const float* r1 = r0 + width;
  float c0 = 0.0f, c1 = 0.0f;
  if (t.vx0) {
    const float t0 = t.vy0 ? r0[t.x0] : 0.0f;
    const float t1 = t.vy1 ? r1[t.x0] : 0.0f;
    c0 = t0 * (1.0f - t.fy) + t1 * t.fy;
  }
  if (t.vx1) {
    const float t0 = t.vy0 ? r0[t.x0 + 1] : 0.0f;
    const float t1 = t.vy1 ? r1[t.x0 + 1] : 0.0f;
    c1 = t0 * (1.0f - t.fy) + t1 * t.fy;
  }
  return c0 * (1.0f - t.fx) + c1 * t.fx;
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
