// Shared device helpers for the channel-frame kernels: OpenCL-style
// rounding, the transfer functions (linear->gamma' also without powf),
// the YCbCr decode and encode, the v210 word fields and group packing,
// the axis-aligned bilinear taps, the decode window of a v210 source, the
// block-wide encode + pack of a row segment (K5), the planar quad decode
// and the planar quad encode, and the v210 packs' staged row segments (K2,
// B5).
//
// Every expression keeps the operation order of the plain PyTorch
// versions (phaneron_tpu_torch/ops/gamma.py, ops/colorspace.py,
// ops/geometry.py), and the library is compiled with -fmad=false
// (ops/_build.py): each multiply and add rounds on its own, as on the
// CPU.  gamma'->linear is a gather from the host-built table the plain
// versions gather from (ops/gamma.py g2l_table), so a decode equals its
// plain version to the bit; a kernel differs from its plain version only
// where CUDA's powf and torch.pow round linear->gamma' differently.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace phn {

constexpr unsigned kField = 0x3FFu;  // one 10-bit v210 field

// linear->gamma' literals, in the order of ops/gamma.py l2g_constants
struct L2G {
  float inv_max, beta, delta, alpha, alpha_m1, gamma;
};

// YCbCr code -> linear RGB: 3x4 colour matrix (rows R', G', B' over
// (Y, U, V, 1)), the gamma'->linear table (65536 float32 in device
// memory), 3x3 gamut matrix
struct Decode {
  float col[12];
  float gamut[9];
  const float* g2l;
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

// gamma'->linear: the table cell the reference indexes,
// lut[u16_sat_rte(x * 65535)]
__device__ __forceinline__ float g2l(const float* lut, float x) {
  return __ldg(lut + u16_sat_rte(x * 65535.0f));
}

__device__ __forceinline__ float l2g(const L2G& g, float x) {
  float fi = static_cast<float>(u16_sat_rte(x * 65535.0f)) * g.inv_max;
  if (fi < g.beta) return fi * g.delta;
  return g.alpha * powf(fi, g.gamma) - g.alpha_m1;
}

// ---- linear->gamma' without powf (B3, B11, B13).  l2g depends only on
// its table index i = u16_sat_rte(x * 65535), so powf's bits are known at
// all kTable indices in advance.  A kernel computes the power with two
// MUFU operations (pow_approx) and moves the result's bits by a signed
// byte an index, the difference to powf's bits (the l2g corrections,
// csrc/l2g_corrections.cu, built on the card with the same instructions):
// equal to l2g to the bit.
constexpr int kTable = 65536;  // table indices: one signed byte each

// u16_sat_rte (round half to even, clamp to [0, 65535], NaN to 0) in one
// conversion
__device__ __forceinline__ int u16_rte(float x) {
  unsigned short r;
  asm("cvt.rni.u16.f32 %0, %1;" : "=h"(r) : "f"(x));
  return r;
}

// The table index of a transfer's argument x: u16_sat_rte(x * 65535)
__device__ __forceinline__ int index_of(float x) { return u16_rte(x * 65535.0f); }

// x ** y for x in (0, 1] before its correction: 2 ** (y * log2 x) by the
// MUFU unit's approximations (normal arguments and results here, so
// flushing denormals changes nothing)
__device__ __forceinline__ float pow_approx(float x, float y) {
  float l, r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(x));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y * l));
  return r;
}

__device__ __forceinline__ float moved(float approx, const signed char* corr, int i) {
  return __int_as_float(__float_as_int(approx) + corr[i]);
}

// l2g, its powf from pow_approx and the index's correction
__device__ __forceinline__ float l2g_corrected(const L2G& g, const signed char* corr, float x) {
  const int i = index_of(x);
  const float fi = static_cast<float>(i) * g.inv_max;
  if (fi < g.beta) return fi * g.delta;
  return g.alpha * moved(pow_approx(fi, g.gamma), corr, i) - g.alpha_m1;
}

// The signed byte that moves an approximation's bits to the exact value's;
// *bad counts the indices whose difference a byte cannot hold
__device__ __forceinline__ signed char correction(float exact, float approx, int* bad) {
  const int diff = __float_as_int(exact) - __float_as_int(approx);
  if (diff >= -128 && diff <= 127) return static_cast<signed char>(diff);
  atomicAdd(bad, 1);
  return 0;
}

__device__ __forceinline__ void decode(const Decode& d, float yf, float uf, float vf,
                                       float rgb[3]) {
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float gam = d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf +
                d.col[4 * c + 3];
    lin[c] = g2l(d.g2l, gam);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] +
             d.gamut[3 * c + 2] * lin[2];
  }
}

// Pixel p (0..5) of a v210 group's four words w: its luma field and the
// fields of its chroma pair p / 2 (the layout of ops/formats/v210.py)
__device__ __forceinline__ void v210_fields(const int4& w, int p, unsigned& y, unsigned& cb,
                                            unsigned& cr) {
  const unsigned w0 = w.x, w1 = w.y, w2 = w.z, w3 = w.w;
  switch (p) {
    case 0: y = w0 >> 10; break;
    case 1: y = w1; break;
    case 2: y = w1 >> 20; break;
    case 3: y = w2 >> 10; break;
    case 4: y = w3; break;
    default: y = w3 >> 20; break;
  }
  switch (p >> 1) {
    case 0: cb = w0; cr = w0 >> 20; break;
    case 1: cb = w1 >> 10; cr = w2; break;
    default: cb = w2 >> 20; cr = w3 >> 10; break;
  }
  y &= kField;
  cb &= kField;
  cr &= kField;
}

// v210_fields for a pixel index p that differs between the lanes of a
// warp: the word and shift of each field come from constants indexed by p
// (luma words 0,1,1,2,3,3 at shifts 10,0,20,10,0,20; Cb of pair k in word
// k at shift 10k; Cr in words 0,2,3 at shifts 20,0,10), so the lanes do not
// diverge into the six cases.  The same fields as v210_fields.
__device__ __forceinline__ unsigned word_of(const int4& w, unsigned i) {
  const unsigned lo = i & 1u ? w.y : w.x, hi = i & 1u ? w.w : w.z;
  return i & 2u ? hi : lo;
}

__device__ __forceinline__ void v210_fields_lane(const int4& w, int p, unsigned& y, unsigned& cb,
                                                 unsigned& cr) {
  const unsigned k = static_cast<unsigned>(p) >> 1;
  y = word_of(w, (0xF94u >> (2 * p)) & 3u) >> ((0x2805500Au >> (5 * p)) & 31u);
  cb = word_of(w, k) >> (10u * k);
  cr = word_of(w, (0x38u >> (2 * k)) & 3u) >> ((0x2814u >> (5 * k)) & 31u);
  y &= kField;
  cb &= kField;
  cr &= kField;
}

// Linear RGB of pixel p of the group whose words are w: the decode every
// v210 kernel runs (K1, the fused v210 program, the packed warp and the
// packed composite)
__device__ __forceinline__ void decode_v210(const Decode& d, const int4& w, int p,
                                            float rgb[3]) {
  unsigned y, cb, cr;
  v210_fields(w, p, y, cb, cr);
  decode(d, static_cast<float>(y), static_cast<float>(cb), static_cast<float>(cr), rgb);
}

// Linear RGB of texel (x, y) of a v210 frame of `groups` groups a row
__device__ __forceinline__ void v210_texel(const int4* __restrict__ words, int groups, int x,
                                           int y, const Decode& d, float rgb[3]) {
  const int4 w = __ldg(words + static_cast<size_t>(y) * groups + x / 6);
  decode_v210(d, w, x % 6, rgb);
}

// ---- asynchronous copies from device memory into shared memory (cp.async):
// a thread issues them, commits them as a group, and waits until at most
// kPending of its groups are in flight; a barrier then shows every
// thread's copies to the block.  16- and 8-byte copies need both addresses
// aligned to their size.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---- persistent kernels: as many blocks as one wave of the device holds
constexpr int kMaxDevices = 16;

// The blocks of `kernel` (threads a block, smem bytes of dynamic shared
// memory) that the current device holds at once, the kernel's dynamic
// shared-memory limit raised to smem: worked out at the first call on a
// device and kept in cache (the caller's own, one slot a device), so a
// launch costs the host no driver queries after the first.  0 on an
// error, which *err then holds.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, int smem, int (&cache)[kMaxDevices],
                           cudaError_t* err) {
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  if (device < kMaxDevices && cache[device] > 0) return cache[device];
  int sms = 0, per_sm = 0;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess) *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (*err != cudaSuccess) return 0;
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (device < kMaxDevices) cache[device] = blocks;
  return blocks;
}

// ---- band forms (a row-sharded channel): a launch writes output rows
// [row0, row0 + rows) of a frame `height` rows tall, and reads its sources
// from windows that hold only the rows its taps reach.  Every coordinate
// stays the frame's own (taps, field parity, the clamp at the frame's
// edges), so an output pixel's arithmetic is that of the full-frame launch.
//
// The frame-row-0 address of a window whose first row is frame row row0,
// rows row_elems elements apart: the kernel indexes it with frame rows and
// only ever reads the window's.  (Integer arithmetic: the address may lie
// before the window's allocation, and is never dereferenced there.)
template <typename T>
inline T* frame_row0(T* window, int row0, size_t row_elems) {
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(window) -
                              static_cast<uintptr_t>(row0) * row_elems * sizeof(T));
}

// The band arguments every band form checks: output rows inside the frame
// and a source window [src_row0, src_row0 + src_rows) inside it too
inline bool band_ok(int height, int row0, int rows, int src_row0, int src_rows) {
  return height > 0 && row0 >= 0 && rows > 0 && row0 + rows <= height && src_row0 >= 0 &&
         src_rows > 0 && src_row0 + src_rows <= height;
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

// The texel coordinate of output index i along one axis (scale m, offset
// off, `size` pixels): (m * (i/size - 0.5) + off + 0.5) * size - 0.5.
// Every step rounds monotonically, so it is monotonic in i.
__device__ __forceinline__ float tap_coord(float m, float off, int i, float size) {
  const float c = static_cast<float>(i) / size - 0.5f;
  return (m * c + off + 0.5f) * size - 0.5f;
}

// One axis of the taps: floor and floor+1 of tap_coord, weight frac
struct AxisTap {
  int i0;
  float f;
  bool v0, v1;
};

__device__ __forceinline__ AxisTap axis_tap(float m, float off, int i, int size) {
  const float p = tap_coord(m, off, i, static_cast<float>(size));
  const float fl = floorf(p);
  AxisTap a;
  a.f = p - fl;
  a.i0 = static_cast<int>(fl);
  a.v0 = a.i0 >= 0 && a.i0 < size;
  a.v1 = a.i0 + 1 >= 0 && a.i0 + 1 < size;
  return a;
}

__device__ __forceinline__ Taps taps_of(const AxisTap& ax, const AxisTap& ay) {
  return Taps{ax.i0, ay.i0, ax.f, ay.f, ax.v0, ax.v1, ay.v0, ay.v1};
}

__device__ __forceinline__ Taps axis_taps(const float* mat, int x, int y, int width,
                                          int height) {
  return taps_of(axis_tap(mat[0], mat[2], x, width), axis_tap(mat[4], mat[5], y, height));
}

// The bilinear value at the taps from the four texel values v00 (x0, y0),
// v01 (x0, y0+1), v10 (x0+1, y0), v11 (x0+1, y0+1): the lerp along rows
// first, then along columns; an invalid tap counts as 0.
__device__ __forceinline__ float bilerp(const Taps& t, float v00, float v01, float v10,
                                        float v11) {
  float c0 = 0.0f, c1 = 0.0f;
  if (t.vx0) {
    const float t0 = t.vy0 ? v00 : 0.0f;
    const float t1 = t.vy1 ? v01 : 0.0f;
    c0 = t0 * (1.0f - t.fy) + t1 * t.fy;
  }
  if (t.vx1) {
    const float t0 = t.vy0 ? v10 : 0.0f;
    const float t1 = t.vy1 ? v11 : 0.0f;
    c1 = t0 * (1.0f - t.fy) + t1 * t.fy;
  }
  return c0 * (1.0f - t.fx) + c1 * t.fx;
}

// One (H, W) float plane at the taps.  Only valid texels are read.
__device__ __forceinline__ float sample(const float* __restrict__ s, int width, const Taps& t) {
  const float* r0 = s + static_cast<ptrdiff_t>(t.y0) * width;
  const float* r1 = r0 + width;
  return bilerp(t, t.vx0 && t.vy0 ? r0[t.x0] : 0.0f, t.vx0 && t.vy1 ? r1[t.x0] : 0.0f,
                t.vx1 && t.vy0 ? r0[t.x0 + 1] : 0.0f, t.vx1 && t.vy1 ? r1[t.x0 + 1] : 0.0f);
}

// Linear RGB of a v210 frame at the taps: each valid tap decoded with
// v210_texel (the value K1 writes for that texel), then bilerp per
// channel, so this equals K1 followed by sample() on its output.
__device__ __forceinline__ void sample_v210(const int4* __restrict__ words, int groups,
                                            const Decode& d, const Taps& t, float out[3]) {
  float v[4][3] = {};
  if (t.vx0 && t.vy0) v210_texel(words, groups, t.x0, t.y0, d, v[0]);
  if (t.vx0 && t.vy1) v210_texel(words, groups, t.x0, t.y0 + 1, d, v[1]);
  if (t.vx1 && t.vy0) v210_texel(words, groups, t.x0 + 1, t.y0, d, v[2]);
  if (t.vx1 && t.vy1) v210_texel(words, groups, t.x0 + 1, t.y0 + 1, d, v[3]);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = bilerp(t, v[0][c], v[1][c], v[2][c], v[3][c]);
}

// ---- source windows: the texels a tile's taps reach, in shared memory
//
// The taps of a tile of output pixels under one axis-aligned matrix reach
// a rectangle of the source.  A block copies (frames) or decodes (v210
// words) the texels that cover it into shared memory once, then samples
// every tap from there, instead of reading (and decoding) each tap where
// it is used (sample, sample_v210).

// Texel columns [c0, c0 + cols) by rows [r0, r0 + rows) of a source, c0
// and cols multiples of the window's alignment (6 for v210 words: whole
// groups; 4 for float32 frames: 16-byte copies); empty (0 texels) when no
// tap of the tile lands inside the frame
struct Window {
  int c0, cols, r0, rows;
  __device__ int texels() const { return cols * rows; }
};

// The window and the inside test of a tile from the floors of its end
// texel coordinates along each axis (xa, xb: its first and last columns';
// ya, yb: its rows'): the window tile_window gives (columns whole
// multiples of align from a multiple of align) and span_inside's answer
// for both axes, on the same floats
struct Span {
  Window win;
  bool inside;
};

__device__ __forceinline__ Span span_of(float xa, float xb, float ya, float yb, int width,
                                        int height, int align) {
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float xf = fmaxf(fminf(xa, xb), 0.0f), xl = fminf(fmaxf(xa, xb) + 1.0f, fw - 1.0f);
  const float yf = fmaxf(fminf(ya, yb), 0.0f), yl = fminf(fmaxf(ya, yb) + 1.0f, fh - 1.0f);
  Span s;
  if (xf <= xl && yf <= yl) {
    const int x0 = static_cast<int>(xf), x1 = static_cast<int>(xl), y0 = static_cast<int>(yf);
    s.win = Window{x0 / align * align, (x1 / align - x0 / align + 1) * align, y0,
                   static_cast<int>(yl) - y0 + 1};
  } else {
    s.win = Window{0, 0, 0, 0};
  }
  s.inside = fminf(xa, xb) >= 0.0f && fmaxf(xa, xb) + 1.0f <= fw - 1.0f && fminf(ya, yb) >= 0.0f &&
             fmaxf(ya, yb) + 1.0f <= fh - 1.0f;
  return s;
}

// The window of output columns [x_lo, x_hi] x rows [y_lo, y_hi] under mat
// (the texels the valid taps reach: tap_coord is monotonic, so the ends
// bound the floors in between; taps are floor and floor + 1, clipped to
// the frame), its columns whole multiples of align from a multiple of
// align
__device__ __forceinline__ Window tile_window(const float* mat, int x_lo, int x_hi, int y_lo,
                                              int y_hi, int width, int height, int align) {
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  return span_of(floorf(tap_coord(mat[0], mat[2], x_lo, fw)), floorf(tap_coord(mat[0], mat[2], x_hi, fw)),
                 floorf(tap_coord(mat[4], mat[5], y_lo, fh)), floorf(tap_coord(mat[4], mat[5], y_hi, fh)),
                 width, height, align)
      .win;
}

// Decode window w (6-aligned) of a v210 source into smem, channel planes
// of w.rows x w.cols floats (group i of the window, row-major, at texels
// 6i .. 6i + 5): each thread takes groups in turn, one 16-byte load and
// its six pixels with decode_v210 (the values K1 writes for them).  A
// group past the frame width decodes its pad, which no valid tap reads.
__device__ __forceinline__ void decode_window(const int4* __restrict__ words, int groups,
                                              const Decode& d, const Window& w,
                                              float* __restrict__ smem) {
  const int plane = w.texels(), wg = w.cols / 6, n = wg * w.rows;
  const int4* first = words + static_cast<size_t>(w.r0) * groups + w.c0 / 6;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / wg;
    const int4 q = __ldg(first + static_cast<size_t>(r) * groups + i - r * wg);
    float* s = smem + 6 * i;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      float rgb[3];
      decode_v210(d, q, p, rgb);
      s[p] = rgb[0];
      s[plane + p] = rgb[1];
      s[2 * plane + p] = rgb[2];
    }
  }
}

// Whether every tap of output indices [lo, hi] along one axis lies inside
// the frame: the floors of the ends at or past 0, their floor + 1 at or
// before size - 1 (tap_coord is monotonic)
__device__ __forceinline__ bool span_inside(float m, float off, int lo, int hi, int size) {
  const float fs = static_cast<float>(size);
  const float a = floorf(tap_coord(m, off, lo, fs)), b = floorf(tap_coord(m, off, hi, fs));
  return fminf(a, b) >= 0.0f && fmaxf(a, b) + 1.0f <= fs - 1.0f;
}

// Linear RGB at the taps from a window that holds every valid tap
// (tile_window of a tile holding the pixel): the same texel values and
// bilerp as sample_v210 and sample.
__device__ __forceinline__ void sample_window(const float* __restrict__ smem, const Window& w,
                                              const Taps& t, float out[3]) {
  const int cols = w.cols, plane = w.texels();
  const int o = (t.y0 - w.r0) * cols + t.x0 - w.c0;
  const bool v00 = t.vx0 && t.vy0, v01 = t.vx0 && t.vy1, v10 = t.vx1 && t.vy0,
             v11 = t.vx1 && t.vy1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* s = smem + c * plane;
    out[c] = bilerp(t, v00 ? s[o] : 0.0f, v01 ? s[o + cols] : 0.0f, v10 ? s[o + 1] : 0.0f,
                    v11 ? s[o + cols + 1] : 0.0f);
  }
}

// Row segments of the kernels that encode one pixel per thread: a block
// of kPixelsPerBlock threads covers kGroupsPerBlock v210 groups of a row.
constexpr int kGroupsPerBlock = 32;
constexpr int kPixelsPerBlock = 6 * kGroupsPerBlock;

// Called by every thread of such a block (blockIdx.x: the segment, row:
// the image row): each thread encodes its pixel x from linear RGB (luma
// for every pixel, chroma for even ones; a pixel past the frame width
// packs as zero) into shared memory, then kGroupsPerBlock threads
// assemble one group's four words each and write them with one 16-byte
// store.  The codes equal ops/kernels.py v210_pack_plain's.
__device__ __forceinline__ void encode_pack_block(const Encode& e, const float rgb[3], int x,
                                                  int width, int row, int groups,
                                                  int4* __restrict__ words) {
  __shared__ unsigned ys[kPixelsPerBlock];
  __shared__ unsigned cb[kPixelsPerBlock / 2];
  __shared__ unsigned cr[kPixelsPerBlock / 2];
  const int t = threadIdx.x;
  unsigned yc = 0, cbc = 0, crc = 0;
  if (x < width) {
    const float rp = l2g(e.g, rgb[0]);
    const float gp = l2g(e.g, rgb[1]);
    const float bp = l2g(e.g, rgb[2]);
    yc = static_cast<unsigned>(encode_row(e, 0, rp, gp, bp)) & kField;
    if ((x & 1) == 0) {
      cbc = static_cast<unsigned>(encode_row(e, 1, rp, gp, bp)) & kField;
      crc = static_cast<unsigned>(encode_row(e, 2, rp, gp, bp)) & kField;
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
  words[static_cast<size_t>(row) * groups + gi] = v210_group(ys + 6 * t, cb + 3 * t, cr + 3 * t);
}

// ---- the planar unpacks (K3/B10, B12): a thread decodes a quad, the four
// pixels x0 = 4j .. 4j + 3 of a row, which share the chroma samples 2j and
// 2j + 1 (the 2x nearest chroma upsample); a warp's 32 quads are 128
// pixels of a row.  A row's pitch (its width rounded up to 8 samples)
// holds every sample of its last quad, so a quad's loads never leave the
// row.
constexpr int kQuadsPerWarp = 32;

struct Quad {
  float y[4], cb[2], cr[2];
};

// kCount (2 or 4) consecutive 8- or 16-bit samples from s: with kVec one
// load of all of them (s aligned to their size), else one load a sample
template <typename T, int kCount, bool kVec>
__device__ __forceinline__ void load_samples(const T* __restrict__ s, float v[kCount]) {
  constexpr int kBits = 8 * sizeof(T);
  constexpr unsigned kMask = (1u << kBits) - 1u;
  if constexpr (kVec && kCount * sizeof(T) == 2) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned short*>(s));
    v[0] = static_cast<float>(w & kMask);
    v[1] = static_cast<float>(w >> kBits);
  } else if constexpr (kVec && kCount * sizeof(T) == 4) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(s));
#pragma unroll
    for (int i = 0; i < kCount; ++i) v[i] = static_cast<float>((w >> (kBits * i)) & kMask);
  } else if constexpr (kVec) {  // four 16-bit samples
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(s));
    v[0] = static_cast<float>(w.x & kMask);
    v[1] = static_cast<float>(w.x >> kBits);
    v[2] = static_cast<float>(w.y & kMask);
    v[3] = static_cast<float>(w.y >> kBits);
  } else {
#pragma unroll
    for (int i = 0; i < kCount; ++i) v[i] = static_cast<float>(__ldg(s + i));
  }
}

// A quad decoded and stored as RGBA with alpha 1 at o, the quad's first
// pixel in a row of out, whose channel planes lie `plane` floats apart:
// with kVec one 16-byte store a plane (o 16-byte aligned, the whole quad
// inside the frame), else the n (1 .. 4) pixels inside the frame one by
// one.  Each plane is so written by consecutive lanes on consecutive
// floats.
template <bool kVec>
__device__ __forceinline__ void decode_quad(const Decode& d, const Quad& q, float* __restrict__ o,
                                            size_t plane, int n) {
  float c[3][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float rgb[3];
    decode(d, q.y[p], q.cb[p >> 1], q.cr[p >> 1], rgb);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k][p] = rgb[k];
  }
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<float4*>(o + k * plane) = make_float4(c[k][0], c[k][1], c[k][2], c[k][3]);
    *reinterpret_cast<float4*>(o + 3 * plane) = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p >= n) break;
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k * plane + p] = c[k][p];
      o[3 * plane + p] = 1.0f;
    }
  }
}

// ---- the planar packs (B11, B13): a thread encodes a quad, the four
// pixels x0 = 4j .. 4j + 3 of a row, whose even pixels give the chroma
// samples 2j and 2j + 1; a warp's 32 quads are 128 pixels of a row.  A
// row's pitch (its width rounded up to 8 samples) is whole quads, so a
// quad's stores never leave the row; a quad past the frame width is pad.
// One persistent block an SM (kPackRows warps) copies the l2g corrections
// into shared memory once, then walks tiles of 32 quads by kPackRows rows,
// each thread's R, G and B staged in shared memory with cp.async
// kPackStages - 1 tiles ahead of the tile it encodes.
constexpr int kPackRows = 32;  // block rows: a block is 32 x kPackRows threads
constexpr int kPackStages = 2;  // tiles in flight: the one encoded and kPackStages - 1 ahead
constexpr int kPackThreads = kQuadsPerWarp * kPackRows;
constexpr int kPackSmemBytes = kTable + kPackStages * 3 * kPackThreads * 16;  // corrections, then stages
static_assert(kPackSmemBytes <= 227 * 1024, "the packs' shared memory exceeds a block's");

// The codes a planar format stores for pixels past the frame width (the
// pitch pad and an odd width's missing pixel: black luma, null chroma,
// yuv422p10.ts:180-182) and the mask to its bit depth, as
// ops/formats/planar.py chroma_null and pallas_kernels.py's code_mask
struct PlanarPad {
  unsigned black, null, mask;
};

inline PlanarPad planar_pad(int num_bits, int luma_black) {
  return PlanarPad{static_cast<unsigned>(luma_black), 128u << (num_bits - 8),
                   (1u << num_bits) - 1u};
}

// u16_sat_rte(x), as an int and as its exact float, without a conversion
// instruction (conversions, like MUFU operations, issue at a quarter of
// the float32 rate): x clamped to [0, 65535] (NaN to 0), then added to
// 1.5 * 2^23, whose ulp is 1, so that the sum rounds to an integer, half
// to even; its low bits are that integer, and the sum less 1.5 * 2^23 is
// its float
struct U16 {
  int i;
  float f;
};

__device__ __forceinline__ U16 u16_rte_alu(float x) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  const float t = fminf(fmaxf(x, 0.0f), 65535.0f) + kMagic;
  return U16{__float_as_int(t) - __float_as_int(kMagic), t - kMagic};
}

// l2g_corrected as a callable, its table index rounded by u16_rte_alu
struct CorrectedL2G {
  L2G g;
  const signed char* corr;
  __device__ __forceinline__ float operator()(float x) const {
    const U16 i = u16_rte_alu(x * 65535.0f);
    const float fi = i.f * g.inv_max;
    if (fi < g.beta) return fi * g.delta;
    return g.alpha * moved(pow_approx(fi, g.gamma), corr, i.i) - g.alpha_m1;
  }
};

// A quad's codes: every pixel's luma and, when `chroma`, the even pixels'
// Cb and Cr, each masked to the bit depth, in the expressions of
// ops/kernels.py _planar_codes_plain (encode_row's, rounded and saturated
// by u16_rte_alu); a pixel past the frame width (p >= n) keeps the pad
// codes
struct QuadCodes {
  unsigned y[4], cb[2], cr[2];
};

__device__ __forceinline__ unsigned quad_code(const Encode& e, int c, float rp, float gp, float bp,
                                              unsigned mask) {
  return static_cast<unsigned>(
             u16_rte_alu(e.col[4 * c] * rp + e.col[4 * c + 1] * gp + e.col[4 * c + 2] * bp + e.col[4 * c + 3]).i) &
         mask;
}

template <class L2GFn>
__device__ __forceinline__ QuadCodes encode_quad(const Encode& e, const L2GFn& l2g_of,
                                                 const float (&rgb)[3][4], int n, bool chroma,
                                                 const PlanarPad& pad) {
  QuadCodes q{{pad.black, pad.black, pad.black, pad.black}, {pad.null, pad.null},
              {pad.null, pad.null}};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p >= n) break;
    const float rp = l2g_of(rgb[0][p]);
    const float gp = l2g_of(rgb[1][p]);
    const float bp = l2g_of(rgb[2][p]);
    q.y[p] = quad_code(e, 0, rp, gp, bp, pad.mask);
    if ((p & 1) == 0 && chroma) {
      q.cb[p >> 1] = quad_code(e, 1, rp, gp, bp, pad.mask);
      q.cr[p >> 1] = quad_code(e, 2, rp, gp, bp, pad.mask);
    }
  }
  return q;
}

// Four 8- or 16-bit codes in one 4- or 8-byte store, two in one 2- or
// 4-byte store (s aligned to the store's size)
template <typename T>
__device__ __forceinline__ void store4(T* s, unsigned a, unsigned b, unsigned c, unsigned d) {
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<unsigned*>(s) = a | (b << 8) | (c << 16) | (d << 24);
  } else {
    *reinterpret_cast<uint2*>(s) = make_uint2(a | (b << 16), c | (d << 16));
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* s, unsigned a, unsigned b) {
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<unsigned short*>(s) = static_cast<unsigned short>(a | (b << 8));
  } else {
    *reinterpret_cast<unsigned*>(s) = a | (b << 16);
  }
}

// The l2g corrections (kTable bytes at corr, 16-byte aligned) copied into
// a block's shared memory with cp.async and committed; the caller waits
// (cp_async_wait, then a barrier) before its first read
__device__ __forceinline__ void copy_corrections(int4* smem, const int4* __restrict__ corr, int tid,
                                                 int threads) {
  for (int i = tid; i < kTable / 16; i += threads) cp_async16(smem + i, corr + i);
  cp_async_commit();
}

// A thread's quad of a tile: column j of `quads`, `row` of `height`;
// false past the pitch or the last row
__device__ __forceinline__ bool pack_quad_of(int tile, int tiles_x, int quads, int height, int& j, int& row) {
  j = (tile % tiles_x) * kQuadsPerWarp + threadIdx.x;
  row = (tile / tiles_x) * kPackRows + threadIdx.y;
  return j < quads && row < height;
}

// Issues the copies of R, G and B of the quad at x0 of a row (row: its R
// samples; planes `plane` floats apart) into the thread's slot of a
// stage (slot: its R float4; G and B kPackThreads float4 further each):
// with kVec one 16-byte copy a plane (row + x0 16-byte aligned, a quad
// inside the frame whole or not at all), else one 4-byte copy a pixel of
// the n inside the frame.
template <bool kVec>
__device__ __forceinline__ void stage_quad(float4* slot, const float* __restrict__ row, size_t plane, int x0,
                                           int n) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* s = row + c * plane + x0;
    if constexpr (kVec) {
      if (n > 0) cp_async16(slot + c * kPackThreads, s);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p < n) cp_async4(reinterpret_cast<float*>(slot + c * kPackThreads) + p, s + p);
    }
  }
}

// The body of a planar pack kernel (a block of 32 x kPackRows threads,
// kPackSmemBytes of dynamic shared memory, at most n_tiles blocks): every
// quad of the pitch of every row of the (C, height, width) frame rgb
// (C >= 3; alpha is not read) encoded with l2g_corrected, chroma on every
// row (chroma_every_row) or on even rows, and handed to store(row, j,
// codes).  The copies keep one commit group a tile, so cp_async_wait
// <kPackStages - 1> finds the tile to encode (and, the first time, the
// corrections) in shared memory; each thread reads only its own slots, so
// one barrier, for the corrections, is all the block needs.
template <bool kVec, class Store>
__device__ __forceinline__ void pack_tiles(const float* __restrict__ rgb, const Encode& e, const PlanarPad& pad,
                                           const int4* __restrict__ corr, int width, int height, int y_pitch,
                                           bool chroma_every_row, const Store& store) {
  extern __shared__ int4 smem[];
  const int tid = threadIdx.y * kQuadsPerWarp + threadIdx.x;
  copy_corrections(smem, corr, tid, kPackThreads);
  const CorrectedL2G l2g_of{e.g, reinterpret_cast<const signed char*>(smem)};
  float4* slots = reinterpret_cast<float4*>(smem + kTable / 16) + tid;  // stage s: slots + 3 s kPackThreads
  const int quads = y_pitch / 4;
  const int tiles_x = (quads + kQuadsPerWarp - 1) / kQuadsPerWarp;
  const int n_tiles = tiles_x * ((height + kPackRows - 1) / kPackRows);
  const size_t plane = static_cast<size_t>(width) * height;
  const auto stage = [&](int tile, int s) {
    int j, row;
    if (tile < n_tiles && pack_quad_of(tile, tiles_x, quads, height, j, row))
      stage_quad<kVec>(slots + 3 * s * kPackThreads, rgb + static_cast<size_t>(row) * width, plane, 4 * j,
                       width - 4 * j);
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kPackStages - 1; ++k) stage(blockIdx.x + k * gridDim.x, k);
  for (int k = 0, tile = blockIdx.x; tile < n_tiles; ++k, tile += gridDim.x) {
    stage(tile + (kPackStages - 1) * gridDim.x, (k + kPackStages - 1) % kPackStages);
    cp_async_wait<kPackStages - 1>();
    if (k == 0) __syncthreads();  // every thread of the block is in its first tile
    int j, row;
    if (!pack_quad_of(tile, tiles_x, quads, height, j, row)) continue;
    const float4* slot = slots + 3 * (k % kPackStages) * kPackThreads;
    float px[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = slot[c * kPackThreads];
      px[c][0] = v.x;
      px[c][1] = v.y;
      px[c][2] = v.z;
      px[c][3] = v.w;
    }
    store(row, j, encode_quad(e, l2g_of, px, width - 4 * j, chroma_every_row || (row & 1) == 0, pad));
  }
}

// The grid of a planar pack: its tiles, at most one wave of the kernel's
// blocks (resident_blocks; cache: the caller's, one slot a device); 0
// with *err set on an error or with nothing to pack
template <typename Kernel>
inline int pack_grid(Kernel kernel, int y_pitch, int height, int (&cache)[kMaxDevices], cudaError_t* err) {
  const int tiles = (y_pitch / 4 + kQuadsPerWarp - 1) / kQuadsPerWarp * ((height + kPackRows - 1) / kPackRows);
  *err = cudaSuccess;
  if (tiles == 0) return 0;
  const int wave = resident_blocks(kernel, kPackThreads, kPackSmemBytes, cache, err);
  return tiles < wave ? tiles : wave;
}

// ---- the v210 packs (K2 v210_pack, B5 combine_pack): one kernel over N
// layers (K2: one), 192-pixel row segments (kGroupsPerBlock v210 groups).
// A warp takes a segment; lane g encodes its group g (pixels x0 + 6g ..
// x0 + 6g + 5) and stores its four words with one 16-byte store.  The
// layers' planes come through shared memory: the warp copies a segment's
// row of each plane (R, G and B, and alpha or wx above layer 0) with
// cp.async, coalesced, one stage ahead of the one it composites.  A stage
// holds every layer of the segment where there are at most two, else one
// layer, so a block holds 15 warps or more whatever the layer count.  One
// persistent block an SM copies the l2g corrections into shared memory
// once; its warps walk the (segment, layers of a stage) units.  The
// expressions are combine_pack_plain's: combine_rgb's 'over' (k = 1 - a,
// then out * k + f; a separable alpha wy[row] * wx[x]) and encode_row's
// (linear->gamma' by CorrectedL2G, codes rounded by u16_rte_alu), term for
// term.
constexpr int kMaxLayers = 8;  // layers a combine_pack launch takes
constexpr int kSegStages = 2;  // stages in flight: the one composited and one ahead
constexpr int kMaxSegWarps = 32;  // warps a block at most
constexpr int kSegSmemLimit = 227 * 1024;  // shared memory a block can have
// the smallest block's (K2's: kMaxSegWarps warps, 3 planes a stage; the
// others hold as many warps as the limit allows) shared memory
static_assert(kTable + kMaxSegWarps * kSegStages * 3 * kPixelsPerBlock * 4 > kSegSmemLimit / 2,
              "a v210 pack block holds its SM alone");

// Layers bottom to top: (4, H, W) RGBA frames (alpha plane 3) or (3, H, W)
// frames whose alpha is wy[row] * wx[x] (wy, wx null for RGBA).  Layer
// 0's alpha is never read, so K2's (C, H, W) frame is one layer.
struct Layers {
  const float* frame[kMaxLayers];
  const float* wy[kMaxLayers];
  const float* wx[kMaxLayers];
  int n_layers;
};

// Layers a stage holds, the planes of its rows (layer 0's three, four a
// layer above it) and the warps a block holds, by layer count
__host__ __device__ constexpr int stage_layers(int n_layers) { return n_layers <= 2 ? n_layers : 1; }

__host__ __device__ constexpr int stage_planes(int n_layers) { return n_layers == 1 ? 3 : n_layers == 2 ? 7 : 4; }

constexpr int segment_warps(int n_layers) {
  const int fit = (kSegSmemLimit - kTable) / (kSegStages * stage_planes(n_layers) * kPixelsPerBlock * 4);
  return fit < kMaxSegWarps ? fit : kMaxSegWarps;
}

// The most warps a block of two or more layers holds (three or more:
// four-plane stages; two: seven-plane stages, fewer): the launch bound of
// B5's instances, whose threads then may use more registers than K2's
constexpr int kLayersSegWarps = segment_warps(3);

// Copies n (> 0) floats of a segment's row of one plane from src into dst
// (kPixelsPerBlock floats) by the warp's 32 lanes: with kVec one 16-byte
// copy a quad (src and dst 16-byte aligned, n a multiple of 4 or at least
// kPixelsPerBlock), else one 4-byte copy a float
template <bool kVec>
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ src, int n, int lane) {
  if constexpr (kVec) {
    for (int i = lane; i < kPixelsPerBlock / 4; i += 32)
      if (4 * i < n) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = lane; i < kPixelsPerBlock; i += 32)
      if (i < n) cp_async4(dst + i, src + i);
  }
}

// Six consecutive floats of a staged row (8-byte aligned)
__device__ __forceinline__ void six_of(const float* s, float (&v)[6]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float2 t = *reinterpret_cast<const float2*>(s + 2 * q);
    v[2 * q] = t.x;
    v[2 * q + 1] = t.y;
  }
}

// The v210 words of a group from its pixels' linear RGB (rgb[c][p]), n of
// them inside the frame: luma of each, chroma of the even ones, each
// masked to 10 bits; a pixel outside codes 0
template <class L2GFn>
__device__ __forceinline__ int4 encode_group(const Encode& e, const L2GFn& l2g_of, const float (&rgb)[3][6], int n) {
  unsigned ys[6] = {0, 0, 0, 0, 0, 0}, cb[3] = {0, 0, 0}, cr[3] = {0, 0, 0};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    if (p >= n) break;
    const float rp = l2g_of(rgb[0][p]);
    const float gp = l2g_of(rgb[1][p]);
    const float bp = l2g_of(rgb[2][p]);
    ys[p] = quad_code(e, 0, rp, gp, bp, kField);
    if ((p & 1) == 0) {
      cb[p / 2] = quad_code(e, 1, rp, gp, bp, kField);
      cr[p / 2] = quad_code(e, 2, rp, gp, bp, kField);
    }
  }
  return v210_group(ys, cb, cr);
}

// A warp's place in its walk over its units: segment s (row, first pixel
// x0 of segs_x segments a row), its layers m .. m + per - 1; next() goes
// on to the next layers, or to layer 0 of the warp's segment s + stride
struct SegmentWalk {
  int s, m, row, x0;
  __device__ __forceinline__ void at(int seg, int segs_x) {
    s = seg;
    row = seg / segs_x;
    x0 = (seg - row * segs_x) * kPixelsPerBlock;
  }
  __device__ __forceinline__ void next(int per, int n_layers, int stride, int segs_x) {
    m += per;
    if (m == n_layers) {
      m = 0;
      at(s + stride, segs_x);
    }
  }
};

// The body of the v210 pack kernel (a block of 32 segment_warps(n_layers)
// threads, kTable + that many warps' kSegStages stages of
// stage_planes(n_layers) rows of dynamic shared memory; kLayers: the
// layer count where it is known when compiled, 0 for L.n_layers): every
// group of the pitch of every row of the layers' (height, width) frames,
// composited, encoded and stored to words (height, groups); fields past
// the frame width pack as 0.  The copies
// keep one commit group a unit, so cp_async_wait<kSegStages - 1> finds
// the unit to composite in shared memory; a lane reads other lanes'
// copies, so the warp meets at __syncwarp before it reads a stage and
// before it copies into one again.
template <int kLayers, bool kVec>
__device__ __forceinline__ void v210_segments(const Layers& L, const Encode& e, const int4* __restrict__ corr,
                                              int4* __restrict__ words, int width, int height, int groups) {
  extern __shared__ int4 smem[];
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  copy_corrections(smem, corr, threadIdx.x, blockDim.x);
  const CorrectedL2G l2g_of{e.g, reinterpret_cast<const signed char*>(smem)};
  const int n_layers = kLayers > 0 ? kLayers : L.n_layers, per = stage_layers(n_layers),
            planes = stage_planes(n_layers);
  float* stages = reinterpret_cast<float*>(smem + kTable / 16) + warp * kSegStages * planes * kPixelsPerBlock;
  const int segs_x = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock, n_segs = segs_x * height;
  const size_t plane = static_cast<size_t>(width) * height;
  const int stride = gridDim.x * warps;
  SegmentWalk copied{0, 0, 0, 0};
  copied.at(blockIdx.x * warps + warp, segs_x);
  SegmentWalk used = copied;
  int n_copies = 0;
  const auto stage = [&]() {  // the next unit's planes into stage n_copies % kSegStages
    if (copied.s < n_segs) {
      float* dst = stages + n_copies % kSegStages * planes * kPixelsPerBlock;
      const size_t at = static_cast<size_t>(copied.row) * width + copied.x0;
      for (int m = copied.m; m < copied.m + per; ++m) {
        for (int ch = 0; ch < (m == 0 ? 3 : 4); ++ch, dst += kPixelsPerBlock) {
          const float* src = ch == 3 && L.wx[m] != nullptr ? L.wx[m] + copied.x0 : L.frame[m] + ch * plane + at;
          stage_row<kVec>(dst, src, width - copied.x0, lane);
        }
      }
      copied.next(per, n_layers, stride, segs_x);
    }
    cp_async_commit();
    ++n_copies;
  };
#pragma unroll
  for (int k = 0; k < kSegStages - 1; ++k) stage();
  cp_async_wait<kSegStages - 1>();  // the corrections
  __syncthreads();
  float rgb[3][6];
  for (int k = 0; used.s < n_segs; ++k) {
    stage();
    cp_async_wait<kSegStages - 1>();
    __syncwarp();
    const float* st = stages + k % kSegStages * planes * kPixelsPerBlock + 6 * lane;
    for (int m = used.m; m < used.m + per; ++m) {
      if (m == 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) six_of(st + ch * kPixelsPerBlock, rgb[ch]);
        st += 3 * kPixelsPerBlock;
        continue;
      }
      const bool separable = L.wx[m] != nullptr;
      const float wy = separable ? __ldg(L.wy[m] + used.row) : 0.0f;
      float a[6], v[6], k_m[6];
      six_of(st + 3 * kPixelsPerBlock, a);
#pragma unroll
      for (int p = 0; p < 6; ++p) k_m[p] = 1.0f - (separable ? wy * a[p] : a[p]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        six_of(st + ch * kPixelsPerBlock, v);
#pragma unroll
        for (int p = 0; p < 6; ++p) rgb[ch][p] = rgb[ch][p] * k_m[p] + v[p];
      }
      st += 4 * kPixelsPerBlock;
    }
    if (used.m + per == n_layers) {
      const int g = used.x0 / 6 + lane;
      if (g < groups)
        words[static_cast<size_t>(used.row) * groups + g] = encode_group(e, l2g_of, rgb, width - (used.x0 + 6 * lane));
    }
    used.next(per, n_layers, stride, segs_x);
    __syncwarp();
  }
}

// Whether the layers take the 16-byte copies: every frame and wx 16-byte
// aligned and a width a multiple of 4 (so every row's quads are)
inline bool quads_aligned(const Layers& L, int width) {
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool ok = width % 4 == 0;
  for (int m = 0; m < L.n_layers; ++m) ok = ok && at16(L.frame[m]) && at16(L.wx[m]);
  return ok;
}

// Launches a v210 pack kernel (kernel: a __global__ wrapper of
// v210_segments) over the layers: segment_warps(n_layers) warps a block,
// at most one wave of blocks (resident_blocks at the shared-memory limit:
// every layer count's block fills its SM alone; cache: the caller's, one
// slot a device).  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for corrections that are null or not 16-byte aligned.
template <typename Kernel>
inline int launch_segments(Kernel kernel, const Layers& L, const Encode& e, const void* corr, void* words,
                           int width, int height, int groups, int (&cache)[kMaxDevices], cudaStream_t s) {
  if (corr == nullptr || reinterpret_cast<uintptr_t>(corr) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_segs = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock * height;
  if (n_segs == 0) return static_cast<int>(cudaSuccess);
  const int warps = segment_warps(L.n_layers);
  const int smem = kTable + warps * kSegStages * stage_planes(L.n_layers) * kPixelsPerBlock * 4;
  cudaError_t err;
  const int wave = resident_blocks(kernel, 32 * warps, kSegSmemLimit, cache, &err);
  if (wave == 0) return static_cast<int>(err);
  const int blocks = (n_segs + warps - 1) / warps;
  const int grid = blocks < wave ? blocks : wave;
  kernel<<<grid, 32 * warps, smem, s>>>(L, e, static_cast<const int4*>(corr), static_cast<int4*>(words), width,
                                        height, groups);
  return static_cast<int>(cudaGetLastError());
}

inline Decode decode_from(const float* coeffs, const float* g2l_table) {
  // coeffs: col[12], gamut[9] (ops/kernels.py _decode_coeffs); the table
  // in device memory
  Decode d;
  for (int i = 0; i < 12; ++i) d.col[i] = coeffs[i];
  for (int i = 0; i < 9; ++i) d.gamut[i] = coeffs[12 + i];
  d.g2l = g2l_table;
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
