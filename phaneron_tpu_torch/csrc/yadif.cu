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
// Design.  Both kernels stage tiles: a block copies the ring rows and
// columns its taps reach into shared memory once, a channel plane at a
// time with the next plane's copy in flight, clamping at the frame's edges
// as it copies, and each thread walks down one column keeping the rows
// its next output row reuses in registers, so a tap is a shared-memory
// read at a constant offset.  The ring kernel (its earlier mapping, one
// thread a pixel gathering its 26 taps a channel from device memory, is
// kept in tools/yadif_variants.cu) stages only the rows one parity reads and
// writes each output row once: its predicted rows from the walk, its kept
// rows from the staged cur with 16-byte stores.  The pair kernel, the
// default load's (32 launches a 1080i50 period of four channels), stages
// every ring row of its tile and writes a kept row to one output and a
// predicted row to the other, so one ring read serves both field ticks.
// The TPU kernel's field-planar lane slices, window DMAs and pl.when edge
// strips exist for VMEM; here the staged rows' clamp plays their part.
#include "phn_common.cuh"

namespace {

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

struct Frame {
  int channels, height, width;
  bool skip_spatial, opaque;
};

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

// ---- the ring kernel: one parity from staged tiles
//
// A block owns kRingCols columns x kRingRows rows of the output, kRingRows
// even and its first row y_lo even, so each of its kRingPairs row pairs
// holds one kept row (y % 2 == parity) and one predicted row.  The parity,
// read once, fixes which rows are predicted (q = 1 - parity) and is_second
// which frames feed the taps C/D/E (cur, else prev) and H/I/J (next, else
// cur); both are uniform over the launch.  A predicted row y reads rows
// y-1 and y+1 (the kept field) of cur (columns x-3..x+3), prev and next,
// and rows y-2, y and y+2 (the predicted field) of cur and of one more
// frame: prev where is_second is false, next where it is true ("full").
// So for one channel plane the block stages, every second row from
// b = y_lo - 2 + q, each row clamped to the frame as it is copied:
//   the kept field, rows b+1, b+3, ... (kKeptRows): cur with kHalo columns
//     on each side (clamped at the frame's sides), prev and next;
//   the predicted field, rows b, b+2, ... (kPredRows): cur and full;
// 2.5 frames' rows, the function's own reads, copied with cp.async as the
// pair's are.  Each thread walks kRingSteps row pairs of one column, keeping
// the taps of rows y-2..y+2 in registers and reading one new row of each
// staged field a step, and stores the predicted row; the block then stores
// its kept rows from the staged cur, 16 bytes a thread where the rows are
// 16-byte aligned.  Alpha (C = 4) is copied the same way from device
// memory, each row once.  The tile shape was chosen on the card
// (tools/kernel_variants.py --only yadif): 64x32 tiles of two row groups
// walking 8 row pairs keep the walk's taps in 114 registers without
// spilling, at four 128-thread blocks an SM (45,632 bytes of buffers
// each); 256-thread blocks at four an SM spill under their 64-register
// cap, and wider, taller or narrower tiles were no faster.
constexpr int kRingCols = 64;
constexpr int kRingRowGroups = 2;
constexpr int kRingSteps = 8;
constexpr int kRingBlocksPerSm = 4;
constexpr int kRingThreads = kRingCols * kRingRowGroups;
constexpr int kRingPairs = kRingRowGroups * kRingSteps;
constexpr int kRingRows = 2 * kRingPairs;
constexpr int kKeptRows = kRingPairs + 1;
constexpr int kPredRows = kRingPairs + 2;
constexpr int kRingCurCols = kRingCols + 2 * kHalo;
constexpr int kCurKeptFloats = kKeptRows * kRingCurCols;
constexpr int kSideKeptFloats = kKeptRows * kRingCols;  // prev's, and next's
constexpr int kPredFloats = kPredRows * kRingCols;      // cur's, and full's
constexpr int kRingPlaneFloats = kCurKeptFloats + 2 * kSideKeptFloats + 2 * kPredFloats;
constexpr int kRingSmemBytes = 2 * kRingPlaneFloats * static_cast<int>(sizeof(float));
constexpr int kRingChunks = kRingCols / 4;  // 16-byte chunks of a tile row
static_assert(kRingCols % 4 == 0 && kRingPlaneFloats % 4 == 0, "16-byte staged rows");

// Copy `rows` rows of one channel plane, frame rows y0, y0+2, ... each
// clamped to rows [lo, hi] (the frame's, or a band's source window, which
// holds every row the band's outputs reach), columns x0 .. x0+kCols-1
// clamped at its sides, into dst (rows x kCols).  vec: every row starts
// 16-byte aligned.
template <int kCols>
__device__ __forceinline__ void stage_field(const float* src, float* dst, int y0, int rows, int x0,
                                            int width, int lo, int hi, bool vec) {
  constexpr int kChunks = kCols / 4;
  for (int i = threadIdx.y * kRingCols + threadIdx.x; i < rows * kChunks; i += kRingThreads) {
    const int r = i / kChunks, k = i - r * kChunks;
    const int x = x0 + 4 * k;
    const float* row = src + static_cast<size_t>(min(max(y0 + 2 * r, lo), hi)) * width;
    float* d = dst + r * kCols + 4 * k;
    if (vec && x >= 0 && x + 4 <= width) {
      phn::cp_async16(d, row + x);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) phn::cp_async4(d + e, row + col_of(x + e, width));
    }
  }
}

// The rows one parity reads of one channel plane into buf (the layout
// above: cur's kept rows, prev's, next's, then cur's and full's predicted
// rows), from frame row b
__device__ __forceinline__ void stage_ring_plane(const float* prev, const float* cur,
                                                 const float* next, float* buf, int x_lo, int b,
                                                 bool is_second, int width, int lo, int hi,
                                                 bool vec) {
  stage_field<kRingCurCols>(cur, buf, b + 1, kKeptRows, x_lo - kHalo, width, lo, hi, vec);
  buf += kCurKeptFloats;
  stage_field<kRingCols>(prev, buf, b + 1, kKeptRows, x_lo, width, lo, hi, vec);
  buf += kSideKeptFloats;
  stage_field<kRingCols>(next, buf, b + 1, kKeptRows, x_lo, width, lo, hi, vec);
  buf += kSideKeptFloats;
  stage_field<kRingCols>(cur, buf, b, kPredRows, x_lo, width, lo, hi, vec);
  buf += kPredFloats;
  stage_field<kRingCols>(is_second ? next : prev, buf, b, kPredRows, x_lo, width, lo, hi, vec);
}

// A ring launch's rows: it writes frame rows [row0, row_end) of out (the
// whole frame, or a band), reads ring rows clamped to [lo, hi] (the frame's
// [0, height - 1], or the band's window), and each ring frame's channel
// planes lie plane floats apart (out's out_plane)
struct RingRows {
  int row0, row_end, lo, hi;
  size_t plane, out_plane;
};

// The predicted rows of one channel plane (out at its offset) for this
// thread's column x and row pairs s0 .. s0+kRingSteps-1, from the staged
// plane in buf
__device__ __forceinline__ void ring_predicted(const float* buf, float* __restrict__ out, int x,
                                               int y_lo, int q, bool is_second, const Frame& f,
                                               const RingRows& rr) {
  const int s0 = threadIdx.y * kRingSteps;
  // kept row s0 is row y-1 of the thread's first predicted row y, and
  // predicted row s0 its row y-2
  const float* cs = buf + s0 * kRingCurCols + kHalo + threadIdx.x;
  const float* ps = buf + kCurKeptFloats + s0 * kRingCols + threadIdx.x;
  const float* ns = ps + kSideKeptFloats;
  const float* cur_pred = ns + kSideKeptFloats;
  const float* full_pred = cur_pred + kPredFloats;
  const float* cde_s = is_second ? cur_pred : full_pred;
  const float* hij_s = is_second ? full_pred : cur_pred;
  float c[2][7], p[2], n[2], cde[3], hij[3];  // kept rows y-1, y+1; predicted y-2, y, y+2
#pragma unroll
  for (int d = 0; d < 7; ++d) c[1][d] = cs[d - 3];
  p[1] = ps[0];
  n[1] = ns[0];
  cde[1] = cde_s[0];
  cde[2] = cde_s[kRingCols];
  hij[1] = hij_s[0];
  hij[2] = hij_s[kRingCols];
#pragma unroll
  for (int s = 0; s < kRingSteps; ++s) {
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      c[0][d] = c[1][d];
      c[1][d] = cs[(s + 1) * kRingCurCols + d - 3];
    }
    p[0] = p[1];
    p[1] = ps[(s + 1) * kRingCols];
    n[0] = n[1];
    n[1] = ns[(s + 1) * kRingCols];
    cde[0] = cde[1];
    cde[1] = cde[2];
    cde[2] = cde_s[(s + 2) * kRingCols];
    hij[0] = hij[1];
    hij[1] = hij[2];
    hij[2] = hij_s[(s + 2) * kRingCols];
    const int y = y_lo + 2 * (s0 + s) + q;
    if (x >= f.width || y < rr.row0 || y >= rr.row_end) continue;
    const float spatial = spatial_from_taps(c[0][0], c[0][1], c[0][2], c[0][3], c[0][4], c[0][5],
                                            c[0][6], c[1][0], c[1][1], c[1][2], c[1][3], c[1][4],
                                            c[1][5], c[1][6]);
    out[static_cast<size_t>(y) * f.width + x] =
        temporal_clamp(p[0], p[1], cde[0], cde[1], cde[2], c[0][3], c[1][3], hij[0], hij[1],
                       hij[2], n[0], n[1], spatial, f.skip_spatial);
  }
}

// The kept rows y_lo + 2s + par of one channel plane (out at its offset):
// cur's staged kept row s + par, 16 bytes a thread where vec
__device__ __forceinline__ void ring_kept(const float* buf, float* __restrict__ out, int x_lo,
                                          int y_lo, int par, const Frame& f, const RingRows& rr,
                                          bool vec) {
  for (int i = threadIdx.y * kRingCols + threadIdx.x; i < kRingPairs * kRingChunks;
       i += kRingThreads) {
    const int s = i / kRingChunks, k = i - s * kRingChunks;
    const int y = y_lo + 2 * s + par, x = x_lo + 4 * k;
    if (y < rr.row0 || y >= rr.row_end || x >= f.width) continue;
    const float* src = buf + (s + par) * kRingCurCols + kHalo + 4 * k;
    float* dst = out + static_cast<size_t>(y) * f.width + x;
    if (vec && x + 4 <= f.width) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; e < 4 && x + e < f.width; ++e) dst[e] = src[e];
    }
  }
}

__global__ void __launch_bounds__(kRingThreads, kRingBlocksPerSm)
    yadif_ring_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                      const float* __restrict__ next, const int* __restrict__ parity,
                      float* __restrict__ out, Frame f, RingRows rr, int tff, int vec) {
  extern __shared__ __align__(16) float stage[];  // two planes' buffers
  const int par = __ldg(parity) & 1;
  const int q = 1 - par;
  const bool is_second = (par ^ tff) == 0;
  // tiles start at an even frame row (a band's first row rounded down), so
  // a row's parity is its frame row's
  const int x_lo = blockIdx.x * kRingCols, y_lo = (rr.row0 & ~1) + blockIdx.y * kRingRows;
  const int b = y_lo - 2 + q;
  const int x = x_lo + threadIdx.x;
  const size_t plane = rr.plane;
  stage_ring_plane(prev, cur, next, stage, x_lo, b, is_second, f.width, rr.lo, rr.hi, vec);
  phn::cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < 3; ++c) {
    if (c < 2) {
      const size_t o = (c + 1) * plane;
      stage_ring_plane(prev + o, cur + o, next + o, stage + ((c + 1) & 1) * kRingPlaneFloats,
                       x_lo, b, is_second, f.width, rr.lo, rr.hi, vec);
      phn::cp_async_commit();
      phn::cp_async_wait<1>();
    } else {
      phn::cp_async_wait<0>();
    }
    __syncthreads();  // plane c is staged
    const float* buf = stage + (c & 1) * kRingPlaneFloats;
    ring_predicted(buf, out + c * rr.out_plane, x, y_lo, q, is_second, f, rr);
    ring_kept(buf, out + c * rr.out_plane, x_lo, y_lo, par, f, rr, vec);
    __syncthreads();  // its buffer is free for plane c + 2
  }
  if (f.channels == 4) {
    for (int i = threadIdx.y * kRingCols + threadIdx.x; i < kRingRows * kRingChunks;
         i += kRingThreads) {
      const int r = i / kRingChunks, k = i - r * kRingChunks;
      const int y = y_lo + r, xa = x_lo + 4 * k;
      if (y < rr.row0 || y >= rr.row_end || xa >= f.width) continue;
      const size_t at = static_cast<size_t>(y) * f.width + xa;
      float* o = out + 3 * rr.out_plane + at;
      const float* a = cur + 3 * plane + at;
      if (vec && xa + 4 <= f.width) {
        *reinterpret_cast<float4*>(o) =
            f.opaque ? make_float4(1.0f, 1.0f, 1.0f, 1.0f) : __ldg(reinterpret_cast<const float4*>(a));
      } else {
        for (int e = 0; e < 4 && xa + e < f.width; ++e) o[e] = f.opaque ? 1.0f : a[e];
      }
    }
  }
}

bool valid(int channels, int height, int width) {
  return (channels == 3 || channels == 4) && height > 0 && width > 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// prev, cur, next: windows of frame rows src_row0 .. src_row0 + src_rows - 1
// of the (channels, height, width) float32 ring, rows `width` floats apart
// and channel planes prev_plane, cur_plane and next_plane floats apart;
// parity: one int32 in device memory, 0 or 1 (its low bit is read); out:
// (channels, rows, width), frame rows row0 .. row0 + rows - 1 of the
// result.  A band's window holds its rows and two more each side, where
// the frame has them: rows are clamped to the frame's edges, never the
// band's.  A full-frame launch: row0 0, rows height, src_row0 0, src_rows
// height, planes width * height.  Returns cudaGetLastError().
extern "C" int phn_yadif_ring(const void* prev, const void* cur, const void* next,
                              const void* parity, void* out, int channels, int height,
                              int width, int row0, int rows, int src_row0, int src_rows,
                              long long prev_plane, long long cur_plane, long long next_plane,
                              int tff, int skip_spatial, int opaque, void* stream) {
  if (!valid(channels, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  if (!phn::band_ok(height, row0, rows, src_row0, src_rows)) return static_cast<int>(cudaErrorInvalidValue);
  // the window must hold every row the band reads, as far as the frame has it
  const int need_lo = row0 >= 2 ? row0 - 2 : 0;
  const int need_hi = row0 + rows + 2 <= height ? row0 + rows + 2 : height;
  if (src_row0 > need_lo || src_row0 + src_rows < need_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel walks the three frames with one plane stride: they must agree
  if (prev_plane != cur_plane || next_plane != cur_plane) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      yadif_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Frame f{channels, height, width, skip_spatial != 0, opaque != 0};
  const RingRows rr{row0, row0 + rows, src_row0, src_row0 + src_rows - 1,
                    static_cast<size_t>(cur_plane), static_cast<size_t>(width) * rows};
  // the windows and the output addressed by frame row
  const float* p = phn::frame_row0(static_cast<const float*>(prev), src_row0, width);
  const float* c = phn::frame_row0(static_cast<const float*>(cur), src_row0, width);
  const float* n = phn::frame_row0(static_cast<const float*>(next), src_row0, width);
  float* o = phn::frame_row0(static_cast<float*>(out), row0, width);
  const int vec = width % 4 == 0 && cur_plane % 4 == 0 && aligned16(prev) && aligned16(cur) &&
                  aligned16(next) && aligned16(out);
  const int y_base = row0 & ~1;
  const dim3 grid((width + kRingCols - 1) / kRingCols, (row0 + rows - y_base + kRingRows - 1) / kRingRows);
  yadif_ring_kernel<<<grid, dim3(kRingCols, kRingRowGroups), kRingSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(p, c, n, static_cast<const int*>(parity), o,
                                                           f, rr, tff != 0, vec);
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
  const int vec = width % 4 == 0 && aligned16(prev) && aligned16(cur) && aligned16(next);
  const dim3 grid((width + kPairCols - 1) / kPairCols, (height + kPairRows - 1) / kPairRows);
  yadif_pair_kernel<<<grid, dim3(kPairCols, kPairRowGroups), kPairSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prev), static_cast<const float*>(cur),
      static_cast<const float*>(next), static_cast<float*>(out0), static_cast<float*>(out1), f,
      tff != 0, vec);
  return static_cast<int>(cudaGetLastError());
}
