// Yadif deinterlace over a 3-frame ring (prev, cur, next) of (C, H, W)
// float32 frames, C = 3 or 4, in two entry points:
//
//   phn_yadif_ring  one parity, read from device memory.  Replaces
//                   phaneron_tpu/ops/pallas_yadif.py:_make_kernel (reached
//                   through make_yadif_ring_program).
//   phn_yadif_pair  both parities from one pass over the ring.  Replaces
//                   pallas_yadif.py:_make_pair_kernel (make_yadif_pair_program)
//                   and _make_pair_split_kernel, the same function on a
//                   channel-split grid.
//
// Rows y % 2 == parity copy cur; the other rows get the edge-directed
// spatial prediction (taps x-3..x+3 on rows y-1 and y+1 of cur) clamped
// by the temporal predictor (rows y-2..y+2 of prev/cur/next), with
// clamp-to-edge on both axes (yadifCl.ts:34-167).  The arithmetic is
// only + - abs /2 min max and compares, written in the order of the
// plain version (phaneron_tpu_torch/ops/yadif.py, itself the JAX
// package's _yadif_full), so the kernel equals it bit for bit.  Alpha
// (C = 4) is cur's on every row, or the constant 1 with `opaque`.
//
// Bound: device-memory bytes.  At one parity the function reads all of
// cur, the kept field of prev and next and the predicted field of one
// of them (2.5 frames) and writes one frame: 87 MB for a 3-channel
// 1920x1080 ring, 26 us at 3.35 TB/s.  The pair reads the three frames
// and writes two: 124 MB, 37 us.  The arithmetic (~70 flops per
// predicted sample) is far below the card's float32 rate.
//
// Design: one thread per output pixel gathers its taps directly with
// clamped row and column indices.  The TPU kernel's field-planar lane
// slices, window DMAs and pl.when edge strips exist for VMEM; here the
// first and last rows, where the clamp crosses field planes, are just
// clamped indices.  Neighbouring threads read neighbouring columns, so
// the 14 spatial and 12 temporal taps of a warp come from a few cached
// lines, and each ring plane reaches device memory about once per row
// band.  The pair kernel writes a kept row to one output and a predicted
// row to the other, so one ring read serves both field ticks.
#include "phn_common.cuh"

namespace {

__device__ __forceinline__ const float* row_of(const float* plane, int y, int height,
                                               int width) {
  return plane + static_cast<size_t>(min(max(y, 0), height - 1)) * width;
}

__device__ __forceinline__ int col_of(int x, int width) { return min(max(x, 0), width - 1); }

// _spatial_from_taps: a..g are the line-above taps at x-3..x+3, h..n the
// line below (yadifCl.ts:34-62)
__device__ __forceinline__ float spatial_pred(const float* up, const float* dn, int x,
                                              int width) {
  const float a = up[col_of(x - 3, width)], b = up[col_of(x - 2, width)];
  const float c = up[col_of(x - 1, width)], d = up[x], e = up[col_of(x + 1, width)];
  const float f = up[col_of(x + 2, width)], g = up[col_of(x + 3, width)];
  const float h = dn[col_of(x - 3, width)], i = dn[col_of(x - 2, width)];
  const float j = dn[col_of(x - 1, width)], k = dn[x], l = dn[col_of(x + 1, width)];
  const float m = dn[col_of(x + 2, width)], n = dn[col_of(x + 3, width)];

  float pred = (d + k) / 2.0f;
  float score = fabsf(c - j) + fabsf(d - k) + fabsf(e - l);

  const float s1 = fabsf(b - k) + fabsf(c - l) + fabsf(d - m);
  const bool cmp1 = s1 < score;
  pred = cmp1 ? (c + l) / 2.0f : pred;
  score = cmp1 ? s1 : score;
  float s2 = fabsf(a - l) + fabsf(b - m) + fabsf(c - n);
  s2 = cmp1 ? s2 : s1;
  const bool cmp2 = cmp1 && (s2 < score);
  pred = cmp2 ? (b + m) / 2.0f : pred;
  score = cmp2 ? s2 : score;

  const float s3 = fabsf(d - i) + fabsf(e - j) + fabsf(f - k);
  const bool cmp3 = s3 < score;
  pred = cmp3 ? (e + j) / 2.0f : pred;
  score = cmp3 ? s3 : score;
  float s4 = fabsf(e - h) + fabsf(f - i) + fabsf(g - j);
  s4 = cmp3 ? s4 : s3;
  const bool cmp4 = cmp3 && (s4 < score);
  pred = cmp4 ? (f + i) / 2.0f : pred;
  return pred;
}

// _temporal_clamp (yadifCl.ts:72-103)
__device__ __forceinline__ float temporal_clamp(float A, float B, float C, float D, float E,
                                                float F, float G, float H, float I, float J,
                                                float K, float L, float spatial,
                                                bool skip_spatial) {
  const float p0 = (C + H) / 2.0f;
  const float p1 = F;
  const float p2 = (D + I) / 2.0f;
  const float p3 = G;
  const float p4 = (E + J) / 2.0f;

  const float tdiff0 = fabsf(D - I);
  const float tdiff1 = (fabsf(A - F) + fabsf(B - G)) / 2.0f;
  const float tdiff2 = (fabsf(K - F) + fabsf(G - L)) / 2.0f;
  float diff = fmaxf(fmaxf(tdiff0, tdiff1), tdiff2);

  if (!skip_spatial) {
    const float p2mp3 = p2 - p3;
    const float p2mp1 = p2 - p1;
    const float p0mp1 = p0 - p1;
    const float p4mp3 = p4 - p3;
    const float maxi = fmaxf(fmaxf(p2mp3, p2mp1), fminf(p0mp1, p4mp3));
    const float mini = fminf(fminf(p2mp3, p2mp1), fmaxf(p0mp1, p4mp3));
    diff = fmaxf(fmaxf(diff, mini), -maxi);
  }

  float pred = spatial > p2 + diff ? p2 + diff : spatial;
  pred = pred < p2 - diff ? p2 - diff : pred;
  return pred;
}

// The predicted value of one channel plane at (x, y).  is_second picks
// which frames feed C/D/E and H/I/J (yadifCl.ts:144-150).
__device__ __forceinline__ float predict(const float* prev, const float* cur,
                                         const float* next, int x, int y, int height,
                                         int width, bool is_second, bool skip_spatial) {
  const float* cu = row_of(cur, y - 1, height, width);
  const float* cd = row_of(cur, y + 1, height, width);
  const float spatial = spatial_pred(cu, cd, x, width);
  const float* cde = is_second ? cur : prev;
  const float* hij = is_second ? next : cur;
  return temporal_clamp(
      row_of(prev, y - 1, height, width)[x], row_of(prev, y + 1, height, width)[x],
      row_of(cde, y - 2, height, width)[x], row_of(cde, y, height, width)[x],
      row_of(cde, y + 2, height, width)[x], cu[x], cd[x],
      row_of(hij, y - 2, height, width)[x], row_of(hij, y, height, width)[x],
      row_of(hij, y + 2, height, width)[x], row_of(next, y - 1, height, width)[x],
      row_of(next, y + 1, height, width)[x], spatial, skip_spatial);
}

struct Frame {
  int channels, height, width;
  bool skip_spatial, opaque;
};

// Writes pixel (x, y) of every channel of `out`: cur where `keep`, else
// the prediction at the parity whose is_second flag is given
__device__ __forceinline__ void yadif_pixel(const float* __restrict__ prev,
                                            const float* __restrict__ cur,
                                            const float* __restrict__ next,
                                            float* __restrict__ out, const Frame& f, int x,
                                            int y, bool keep, bool is_second) {
  const size_t plane = static_cast<size_t>(f.width) * f.height;
  const size_t o = static_cast<size_t>(y) * f.width + x;
  for (int c = 0; c < 3; ++c) {
    const size_t off = c * plane;
    out[off + o] = keep ? cur[off + o]
                        : predict(prev + off, cur + off, next + off, x, y, f.height, f.width,
                                  is_second, f.skip_spatial);
  }
  if (f.channels == 4) out[3 * plane + o] = f.opaque ? 1.0f : cur[3 * plane + o];
}

__global__ void yadif_ring_kernel(const float* __restrict__ prev,
                                  const float* __restrict__ cur,
                                  const float* __restrict__ next,
                                  const int* __restrict__ parity, float* __restrict__ out,
                                  Frame f, int tff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= f.width || y >= f.height) return;
  const int par = *parity;
  yadif_pixel(prev, cur, next, out, f, x, y, (y % 2) == par, (par ^ tff) == 0);
}

__global__ void yadif_pair_kernel(const float* __restrict__ prev,
                                  const float* __restrict__ cur,
                                  const float* __restrict__ next, float* __restrict__ out0,
                                  float* __restrict__ out1, Frame f, int tff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= f.width || y >= f.height) return;
  // row y is kept at parity y % 2 and predicted at the other parity
  const int kept = y % 2, predicted = 1 - kept;
  yadif_pixel(prev, cur, next, kept ? out1 : out0, f, x, y, true, false);
  yadif_pixel(prev, cur, next, kept ? out0 : out1, f, x, y, false, (predicted ^ tff) == 0);
}

const dim3 kBlock(32, 8);

dim3 grid_of(int height, int width) {
  return dim3((width + kBlock.x - 1) / kBlock.x, (height + kBlock.y - 1) / kBlock.y);
}

bool valid(int channels, int height, int width) {
  return (channels == 3 || channels == 4) && height > 0 && width > 0;
}

}  // namespace

// prev, cur, next, out: (channels, height, width) float32; parity: one
// int32 in device memory.  Returns cudaGetLastError().
extern "C" int phn_yadif_ring(const void* prev, const void* cur, const void* next,
                              const void* parity, void* out, int channels, int height,
                              int width, int tff, int skip_spatial, int opaque, void* stream) {
  if (!valid(channels, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  const Frame f{channels, height, width, skip_spatial != 0, opaque != 0};
  yadif_ring_kernel<<<grid_of(height, width), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur),
      static_cast<const float*>(next), static_cast<const int*>(parity),
      static_cast<float*>(out), f, tff != 0);
  return static_cast<int>(cudaGetLastError());
}

// out0, out1: the parity-0 and parity-1 results, like cur.
extern "C" int phn_yadif_pair(const void* prev, const void* cur, const void* next, void* out0,
                              void* out1, int channels, int height, int width, int tff,
                              int skip_spatial, int opaque, void* stream) {
  if (!valid(channels, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  const Frame f{channels, height, width, skip_spatial != 0, opaque != 0};
  yadif_pair_kernel<<<grid_of(height, width), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur),
      static_cast<const float*>(next), static_cast<float*>(out0), static_cast<float*>(out1), f,
      tff != 0);
  return static_cast<int>(cudaGetLastError());
}
