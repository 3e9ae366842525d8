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
// Design.  The ring kernel: one thread per output pixel gathers its taps
// straight from device memory with clamped row and column indices (26
// taps a channel, each a clamp and a 64-bit address).  The pair kernel,
// the default load's (32 launches a 1080i50 period of four channels),
// stages tiles instead: a block copies the ring rows and columns its
// taps reach into shared memory once, clamping at the frame's edges as it
// copies, and each thread walks down one column keeping the rows its next
// output row reuses in registers, so a tap is a shared-memory read at a
// constant offset (see the pair kernel below).  The TPU kernel's
// field-planar lane slices, window DMAs and pl.when edge strips exist for
// VMEM; here the staged rows' clamp plays their part.  The pair writes a
// kept row to one output and a predicted row to the other, so one ring
// read serves both field ticks.
#include "phn_common.cuh"

namespace {

__device__ __forceinline__ const float* row_of(const float* plane, int y, int height,
                                               int width) {
  return plane + static_cast<size_t>(min(max(y, 0), height - 1)) * width;
}

__device__ __forceinline__ int col_of(int x, int width) { return min(max(x, 0), width - 1); }

// _spatial_from_taps: a..g are the line-above taps at x-3..x+3, h..n the
// line below (yadifCl.ts:34-62)
__device__ __forceinline__ float spatial_from_taps(float a, float b, float c, float d, float e,
                                                   float f, float g, float h, float i, float j,
                                                   float k, float l, float m, float n) {
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

// The spatial prediction at column x from the clamped taps of the rows
// above (up) and below (dn)
__device__ __forceinline__ float spatial_pred(const float* up, const float* dn, int x,
                                              int width) {
  return spatial_from_taps(up[col_of(x - 3, width)], up[col_of(x - 2, width)],
                           up[col_of(x - 1, width)], up[x], up[col_of(x + 1, width)],
                           up[col_of(x + 2, width)], up[col_of(x + 3, width)],
                           dn[col_of(x - 3, width)], dn[col_of(x - 2, width)],
                           dn[col_of(x - 1, width)], dn[x], dn[col_of(x + 1, width)],
                           dn[col_of(x + 2, width)], dn[col_of(x + 3, width)]);
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

// ---- the pair kernel: staged tiles
//
// A block owns kPairCols columns x kPairRows rows of both outputs.  For one
// channel plane at a time it stages into shared memory the ring rows its
// taps reach, y_lo-2 .. y_lo+kPairRows+1, each clamped to the frame once as
// it is copied: cur with kHalo columns on each side (its taps reach
// x-3..x+3, clamped at the frame's side edges as they are copied), prev and
// next at the tile's own columns.  The copies are cp.async, 16 bytes a
// thread where the row is 16-byte aligned and the 4 columns lie inside the
// frame, else 4 bytes a column; the next plane's copy goes into the second
// buffer while this plane is computed.  Each thread then walks kPairWalk
// rows of one column, keeping the taps of rows y-2..y+2 in registers (seven
// columns of cur, one of prev and of next), and reads one new row of each
// from shared memory a step.  Alpha (C = 4) is copied from device memory.
constexpr int kPairCols = 64;
constexpr int kPairRowGroups = 4;
constexpr int kPairWalk = 8;
constexpr int kPairBlocksPerSm = 3;
constexpr int kPairThreads = kPairCols * kPairRowGroups;
constexpr int kPairRows = kPairRowGroups * kPairWalk;
constexpr int kHalo = 4;  // 3 taps, rounded up to 16 bytes
constexpr int kCurCols = kPairCols + 2 * kHalo;
constexpr int kStageRows = kPairRows + 4;
constexpr int kCurFloats = kStageRows * kCurCols;
constexpr int kSideFloats = kStageRows * kPairCols;  // prev's, and next's
constexpr int kPlaneFloats = kCurFloats + 2 * kSideFloats;
constexpr int kPairSmemBytes = 2 * kPlaneFloats * static_cast<int>(sizeof(float));

// Copy rows y_lo-2 .. y_lo+kPairRows+1 of one channel plane of the ring
// into buf: cur (kStageRows x kCurCols from column x_lo-kHalo), then prev
// and next (kStageRows x kPairCols from x_lo).  vec: every row starts
// 16-byte aligned.
__device__ __forceinline__ void stage_plane(const float* prev, const float* cur,
                                            const float* next, float* buf, int x_lo, int y_lo,
                                            int width, int height, bool vec) {
  constexpr int kCurChunks = kCurCols / 4, kSideChunks = kPairCols / 4;
  constexpr int kRowChunks = kCurChunks + 2 * kSideChunks;
  const int tid = threadIdx.y * kPairCols + threadIdx.x;
  for (int i = tid; i < kStageRows * kRowChunks; i += kPairThreads) {
    const int r = i / kRowChunks;
    int k = i - r * kRowChunks;
    const float* src = cur;
    float* dst = buf + r * kCurCols + 4 * k;
    int x = x_lo - kHalo + 4 * k;
    if (k >= kCurChunks) {
      k -= kCurChunks;
      const bool nx = k >= kSideChunks;
      k -= nx ? kSideChunks : 0;
      src = nx ? next : prev;
      dst = buf + kCurFloats + (nx ? kSideFloats : 0) + r * kPairCols + 4 * k;
      x = x_lo + 4 * k;
    }
    const float* row = src + static_cast<size_t>(min(max(y_lo - 2 + r, 0), height - 1)) * width;
    if (vec && x >= 0 && x + 4 <= width) {
      phn::cp_async16(dst, row + x);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) phn::cp_async4(dst + e, row + col_of(x + e, width));
    }
  }
}

// Both outputs of one channel plane (at offset off) for this thread's
// column x and rows y0 .. y0+kPairWalk-1, from the staged plane in buf
__device__ __forceinline__ void pair_plane(const float* buf, float* __restrict__ out0,
                                           float* __restrict__ out1, size_t off, int x, int y0,
                                           const Frame& f, int tff) {
  // local row 0 of this thread is frame row y0 - 2
  const float* cs = buf + threadIdx.y * kPairWalk * kCurCols + kHalo + threadIdx.x;
  const float* ps = buf + kCurFloats + threadIdx.y * kPairWalk * kPairCols + threadIdx.x;
  const float* ns = ps + kSideFloats;
  float c[5][7], p[5], n[5];  // rows y-2..y+2; cur's at x-3..x+3
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int d = 0; d < 7; ++d) c[r + 1][d] = cs[r * kCurCols + d - 3];
    p[r + 1] = ps[r * kPairCols];
    n[r + 1] = ns[r * kPairCols];
  }
#pragma unroll
  for (int s = 0; s < kPairWalk; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int d = 0; d < 7; ++d) c[r][d] = c[r + 1][d];
      p[r] = p[r + 1];
      n[r] = n[r + 1];
    }
#pragma unroll
    for (int d = 0; d < 7; ++d) c[4][d] = cs[(s + 4) * kCurCols + d - 3];
    p[4] = ps[(s + 4) * kPairCols];
    n[4] = ns[(s + 4) * kPairCols];
    const int y = y0 + s;
    if (x >= f.width || y >= f.height) continue;
    const float spatial = spatial_from_taps(c[1][0], c[1][1], c[1][2], c[1][3], c[1][4], c[1][5],
                                            c[1][6], c[3][0], c[3][1], c[3][2], c[3][3], c[3][4],
                                            c[3][5], c[3][6]);
    // row y is kept at parity y % 2 and predicted at the other parity
    const int kept = y & 1;
    const bool is_second = ((1 - kept) ^ tff) == 0;
    const float pred = temporal_clamp(
        p[1], p[3], is_second ? c[0][3] : p[0], is_second ? c[2][3] : p[2],
        is_second ? c[4][3] : p[4], c[1][3], c[3][3], is_second ? n[0] : c[0][3],
        is_second ? n[2] : c[2][3], is_second ? n[4] : c[4][3], n[1], n[3], spatial,
        f.skip_spatial);
    const size_t o = off + static_cast<size_t>(y) * f.width + x;
    (kept ? out1 : out0)[o] = c[2][3];
    (kept ? out0 : out1)[o] = pred;
  }
}

__global__ void __launch_bounds__(kPairThreads, kPairBlocksPerSm)
    yadif_pair_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                      const float* __restrict__ next, float* __restrict__ out0,
                      float* __restrict__ out1, Frame f, int tff, int vec) {
  extern __shared__ __align__(16) float stage[];  // two planes' buffers
  const int x_lo = blockIdx.x * kPairCols, y_lo = blockIdx.y * kPairRows;
  const int x = x_lo + threadIdx.x, y0 = y_lo + threadIdx.y * kPairWalk;
  const size_t plane = static_cast<size_t>(f.width) * f.height;
  stage_plane(prev, cur, next, stage, x_lo, y_lo, f.width, f.height, vec);
  phn::cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    if (c < 2) {
      const size_t o = (c + 1) * plane;
      stage_plane(prev + o, cur + o, next + o, stage + ((c + 1) & 1) * kPlaneFloats, x_lo, y_lo,
                  f.width, f.height, vec);
      phn::cp_async_commit();
      phn::cp_async_wait<1>();
    } else {
      phn::cp_async_wait<0>();
    }
    __syncthreads();  // plane c is staged
    pair_plane(stage + (c & 1) * kPlaneFloats, out0, out1, c * plane, x, y0, f, tff);
    __syncthreads();  // its buffer is free for plane c + 2
  }
  if (f.channels == 4 && x < f.width) {
    for (int s = 0; s < kPairWalk && y0 + s < f.height; ++s) {
      const size_t o = 3 * plane + static_cast<size_t>(y0 + s) * f.width + x;
      const float a = f.opaque ? 1.0f : cur[o];
      out0[o] = a;
      out1[o] = a;
    }
  }
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
  const cudaError_t attr = cudaFuncSetAttribute(
      yadif_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPairSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Frame f{channels, height, width, skip_spatial != 0, opaque != 0};
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = width % 4 == 0 && aligned(prev) && aligned(cur) && aligned(next);
  const dim3 grid((width + kPairCols - 1) / kPairCols, (height + kPairRows - 1) / kPairRows);
  yadif_pair_kernel<<<grid, dim3(kPairCols, kPairRowGroups), kPairSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur),
      static_cast<const float*>(next), static_cast<float*>(out0), static_cast<float*>(out1), f,
      tff != 0, vec);
  return static_cast<int>(cudaGetLastError());
}
