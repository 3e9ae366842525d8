// B14 rotate: the general affine DVE warp (MIXER ROTATION at any angle, and
// any shear or scale) of (C, H, W) float32 frames, a single source, a
// dissolve pair or a wipe pair, each pair under one shared matrix or two.
//
// Replaces phaneron_tpu/ops/pallas_rotate.py:_make_pass, reached through
// make_rotate_program (a quarter turn plus two shear passes, one kernel
// launch per pass and source, then an XLA mix).  That design exists only
// because Mosaic has no gather; it approximates the direct bilinear gather
// and differs from it at content step edges.  This kernel computes what it
// approximates, ops/geometry.py warp_affine: output pixel (x, y) samples
// the source at
//   px = m00 * ix + m01 * iy + m02 + 0.5,  ix = x / W - 0.5
//   py = m10 * ix + m11 * iy + m12 + 0.5,  iy = y / H - 0.5
// in texel coordinates u = px * W - 0.5, v = py * H - 0.5, taps floor and
// floor + 1 with weight frac, border zero, lerping along x first and then
// along y (warp_affine's _sample_bilinear; phn::sample lerps y first, as
// the axis-aligned warp does).  With -fmad=false each product and sum
// rounds as in the plain version, so the kernel equals it to the bit up to
// the sign of zero.  It takes any matrix, so the TPU's quarter-turn and
// shear-bucket codes (rot_bucket, rot_bucket_b) are not read.
//
// Pair modes mix after the warps, as the plain path does:
//   dissolve  out = warp(a, mat) * mix + warp(b, mat_b) * (1 - mix)
//   wipe      out = warp(b, mat_b) * m + warp(a, mat) * (1 - m)
// with m the (H, W) mask plane read in output space.  A rotated transition
// is one launch.
//
// Bound: device-memory bytes.  Each output pixel reads four taps of each
// source channel and writes 4 bytes per channel; device memory need see
// only one read of each source texel the matrix reaches.  The first design
// gathered every tap from device memory with one thread a pixel and a warp
// a run of 32 pixels of one output row: under a rotation near 90 degrees
// those 32 pixels' taps run down a source column, so each of a pixel's 16
// tap loads touched 32 cache lines a warp (tools/kernel_variants.py
// rotate; PERF.md).  Design: persistent blocks walk output tiles of 32
// columns by kTileH rows (kPairTileH for a pair, whose tiles hold two
// windows).  affine_taps rounds monotonically in x for fixed y and in y
// for fixed x, so the taps of a tile's four corner pixels bound every tap
// floor in it: the window of source texels they span, clipped to the
// frame, holds every valid tap of the tile (ops/rotate.py affine_window is
// its plain version).  A block copies each source's window, every channel
// plane, into shared memory with cp.async, texel pairs where frame rows
// allow (a single warp while it samples the tile before; a pair, whose two
// windows take twice the memory, after it, in one buffer and so with more
// blocks an SM), then samples every tap of the tile from there; each window's row pitch keeps the lanes of a warp,
// which walk down a window column under a rotation near 90 degrees, in
// distinct banks.  A window larger than the launch's window texels (a
// strong minify, a shear) leaves its source to the direct gather for that
// tile, in the same launch; a source whose taps all fall outside the
// frame in a tile is +0 there and is not sampled.  Matrices, mix and mask
// are read from device memory, so animating them needs no host
// synchronisation.
//
// Band form (a row-sharded channel, parallel/bands.py): the launch writes
// output rows [row0, row0 + rows) from source windows that hold frame rows
// [src_row0, src_row0 + src_rows), the rows every valid tap of the band
// reaches (graph/pipeline.py band_windows: ops/rotate.py affine_window of
// the band as one tile).  Its persistent blocks walk the
// band's tiles only, from row0.  Taps are taken at the frame's rows and
// height; a tap row is valid inside the window, and each tile's window is
// clipped to it, so no read leaves the window and every output pixel
// equals the full-frame launch's.  The full-frame launch is a template of
// its own with no band arithmetic in its code.
#include "phn_common.cuh"

// The tile and window sizes, which ops/rotate.py owns (TILE_H,
// WINDOW_TEXELS, COPY_TEXELS) and ops/_build.py passes as defines
#if !defined(PHN_ROTATE_TILE_H) || !defined(PHN_ROTATE_PAIR_TILE_H) || \
    !defined(PHN_ROTATE_WINDOW_TEXELS) || !defined(PHN_ROTATE_PAIR_WINDOW_TEXELS) || \
    !defined(PHN_ROTATE_COPY_TEXELS)
#error "build with ops/_build.py nvcc_flags(): the PHN_ROTATE_* defines come from ops/rotate.py"
#endif

namespace {

constexpr int kTileW = 32;  // output tile columns: a warp's row (ops/rotate.py TILE_W)
constexpr int kThreadRows = 8;  // block rows; a thread takes its column's pixels kThreadRows apart
constexpr int kThreads = kTileW * kThreadRows;
constexpr int kTileH = PHN_ROTATE_TILE_H;  // output tile rows of a single warp
constexpr int kWindowTexels = PHN_ROTATE_WINDOW_TEXELS;  // shared-memory texels of a single warp's window a channel
constexpr int kPairTileH = PHN_ROTATE_PAIR_TILE_H;  // the same for a pair, whose tiles hold two windows
constexpr int kPairWindowTexels = PHN_ROTATE_PAIR_WINDOW_TEXELS;
constexpr int kPairBuffers = 1;  // 2: copy the next tile's windows while sampling; 1: after (pairs)
constexpr int kSingleBuffers = 2;  // the same for a single warp
constexpr int kCopyTexels = PHN_ROTATE_COPY_TEXELS;  // texels a copy moves where frame rows allow (8-byte cp.async), else 1
static_assert(kCopyTexels == 1 || kCopyTexels == 2, "a copy moves one texel or a pair");
static_assert(kTileW == 32 && kTileH % kThreadRows == 0 && kPairTileH % kThreadRows == 0,
              "a warp is one row of a tile");

// The tile rows and window texels of a launch: a single warp or a pair
template <bool kPair>
struct Shape {
  static constexpr int kH = kPair ? kPairTileH : kTileH;
  static constexpr int kTexels = kPair ? kPairWindowTexels : kWindowTexels;
  static constexpr int kSources = kPair ? 2 : 1;
  static constexpr int kBuffers = kPair ? kPairBuffers : kSingleBuffers;
};

// The band of a launch: output rows [row0, row0 + rows), the sources'
// rows [src_lo, src_hi), their planes src_plane floats apart.  A
// full-frame launch (kBand false) reads none of it.
struct Band {
  int row0, rows, src_lo, src_hi;
  size_t src_plane;
};

// One matrix's rows as the kernel reads them, kept in registers
struct Mat {
  float m00, m01, m02, m10, m11, m12;
};

__device__ __forceinline__ Mat load_mat(const float* m) {
  return Mat{__ldg(m), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3), __ldg(m + 4), __ldg(m + 5)};
}

// Taps of the output pixel at ix = x / W - 0.5, iy = y / H - 0.5 under the
// affine matrix m.  The tap index is clamped to [-2, size] before the
// integer conversion, which keeps every validity flag and keeps the
// conversion defined for positions far off the frame.
__device__ __forceinline__ phn::Taps affine_taps(const Mat& m, float ix, float iy, int width,
                                                 int height) {
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float px = m.m00 * ix + m.m01 * iy + m.m02 + 0.5f;
  const float py = m.m10 * ix + m.m11 * iy + m.m12 + 0.5f;
  const float u = px * fw - 0.5f;
  const float v = py * fh - 0.5f;
  const float flx = floorf(u), fly = floorf(v);
  phn::Taps t;
  t.fx = u - flx;
  t.fy = v - fly;
  t.x0 = static_cast<int>(fminf(fmaxf(flx, -2.0f), fw));
  t.y0 = static_cast<int>(fminf(fmaxf(fly, -2.0f), fh));
  t.vx0 = t.x0 >= 0 && t.x0 < width;
  t.vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < width;
  t.vy0 = t.y0 >= 0 && t.y0 < height;
  t.vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < height;
  return t;
}

// A band's taps: a tap row is valid inside the rows [s_lo, s_hi) its
// sources hold (inside the frame's, so this replaces the frame's test)
__device__ __forceinline__ void clip_rows(phn::Taps& t, int s_lo, int s_hi) {
  t.vy0 = t.y0 >= s_lo && t.y0 < s_hi;
  t.vy1 = t.y0 + 1 >= s_lo && t.y0 + 1 < s_hi;
}

// x / size - 0.5: the centred coordinate of output index i
__device__ __forceinline__ float centred(int i, int size) {
  return static_cast<float>(i) / static_cast<float>(size) - 0.5f;
}

// The bilinear value from the four texels of the taps, reading only valid
// ones: s[o] the texel (x0, y0), s[o + pitch] the texel (x0, y0 + 1) (in
// the frame or its window); lerp along x (top and bottom rows), then y.
__device__ __forceinline__ float lerp_taps(const float* __restrict__ s, int o, int pitch,
                                           const phn::Taps& t) {
  const float v00 = t.vx0 && t.vy0 ? s[o] : 0.0f;
  const float v10 = t.vx1 && t.vy0 ? s[o + 1] : 0.0f;
  const float v01 = t.vx0 && t.vy1 ? s[o + pitch] : 0.0f;
  const float v11 = t.vx1 && t.vy1 ? s[o + pitch + 1] : 0.0f;
  const float top = v00 * (1.0f - t.fx) + v10 * t.fx;
  const float bot = v01 * (1.0f - t.fx) + v11 * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

// A source's window in a tile: texel columns [c0, c0 + cols) by rows
// [r0, r0 + rows) at row pitch `pitch`, copied `unit` texels at a time,
// and whether it fits in the launch's window texels (else the tile samples
// the source from device memory); empty (rows 0) when no tap of the tile
// lands inside the frame, and then zero when every texel coordinate of
// the tile is finite: each sample is 0 * (1 - f) + 0 * f = +0 exactly, so
// the tile skips it.  magic: ceil(2^32 / (cols / unit)), which divides a
// copy's index in the window by the copies a row.
//
// Where frame rows have an even width, a window starts at an even column,
// has an even width and pitch, and copies texel pairs with 8-byte copies;
// its pitch is 2 more than a multiple of 4, so that lanes walking down a
// window column fall in 16 banks at least.  Otherwise it copies single
// texels and its pitch is odd (32 banks).
struct Window {
  int c0, r0, cols, rows, pitch, unit, fits, zero;
  unsigned long long magic;
};

// The source windows of the tile (x_lo, y_lo) of kH rows (its last row
// before y_end, the frame's or the band's end), for warp 0 of the block:
// lanes 0-3 take the taps of the tile's four corner pixels under ma, lanes
// 4-7 under mb, whose floors bound every tap floor in the tile (each step
// of affine_taps rounds monotonically in x for fixed y and in y for fixed
// x); a window spans them and their floors + 1, clipped to the frame's
// columns and to the rows [s_lo, s_hi) the sources hold (ops/rotate.py
// affine_window).  It fits when its rows times its pitch are at most
// kTexels (ops/rotate.py window_counts).  Lane 0 returns source a's
// window, lane 4 source b's.
template <int kH, int kTexels>
__device__ __forceinline__ Window tile_window(const Mat& ma, const Mat& mb, int x_lo, int y_lo,
                                              int y_end, int s_lo, int s_hi, int width,
                                              int height) {
  const int lane = threadIdx.x;
  const int x_hi = min(x_lo + kTileW, width) - 1, y_hi = min(y_lo + kH, y_end) - 1;
  const bool b = lane & 4;
  const phn::Taps t = affine_taps(b ? mb : ma, centred(lane & 1 ? x_hi : x_lo, width),
                                  centred(lane & 2 ? y_hi : y_lo, height), width, height);
  int x_min = t.x0, x_max = t.x0, y_min = t.y0, y_max = t.y0;
  // the corners' coordinates finite: then every pixel's, between them, is
  const unsigned finite = __ballot_sync(0xffffffffu, isfinite(t.fx) && isfinite(t.fy));
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1) {  // over the four corner lanes of a source
    x_min = min(x_min, __shfl_xor_sync(0xffffffffu, x_min, k));
    x_max = max(x_max, __shfl_xor_sync(0xffffffffu, x_max, k));
    y_min = min(y_min, __shfl_xor_sync(0xffffffffu, y_min, k));
    y_max = max(y_max, __shfl_xor_sync(0xffffffffu, y_max, k));
  }
  const int x_first = max(x_min, 0), x_last = min(x_max + 1, width - 1);
  const int y_first = max(y_min, s_lo), y_last = min(y_max + 1, s_hi - 1);
  if (x_first > x_last || y_first > y_last)
    return Window{0, 0, 1, 0, 1, 1, 1, ((finite >> (lane & 4)) & 15u) == 15u, 1ull << 32};
  const int unit = kCopyTexels == 2 && (width & 1) == 0 ? 2 : 1;
  const int c0 = unit == 2 ? x_first & ~1 : x_first;
  const int cols = unit == 2 ? (x_last + 2 - c0) & ~1 : x_last - x_first + 1;
  const int pitch = unit == 2 ? (cols & 2 ? cols : cols + 2) : cols | 1;
  const int rows = y_last - y_first + 1;
  // ceil(2^32 / copies a row) from above, within 2^-23 of it: exact
  // division of indices below 2^23 (a window has fewer)
  const float magic = __fdiv_ru(4294967296.0f, static_cast<float>(cols / unit));
  return Window{c0, y_first, cols, rows, pitch, unit, rows * pitch <= kTexels, 0,
                static_cast<unsigned long long>(magic)};
}

// Issue the copies of window w of every channel plane of src (planes
// `plane` floats apart, rows addressed by frame row) into smem (plane c at
// c * kTexels): the block's threads take its copies (w.unit texels each)
// in row-major order, a copy's channels one after another
template <int kCh, int kTexels>
__device__ __forceinline__ void copy_window(const float* __restrict__ src, const Window& w,
                                            float* __restrict__ smem, int width, size_t plane) {
  if (!w.fits) return;
  const int per_row = w.cols / w.unit, n = w.rows * per_row;
  for (int e = threadIdx.y * kTileW + threadIdx.x; e < n; e += kThreads) {
    const int r = static_cast<int>((static_cast<unsigned long long>(e) * w.magic) >> 32);
    const int c = (e - r * per_row) * w.unit;
    const float* g = src + static_cast<size_t>(w.r0 + r) * width + w.c0 + c;
    float* d = smem + r * w.pitch + c;
    if (w.unit == 2) {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) phn::cp_async8(d + ch * kTexels, g + ch * plane);
    } else {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) phn::cp_async4(d + ch * kTexels, g + ch * plane);
    }
  }
}

// Channel c of a source at the taps, from its window (kWin) or from the
// frame in device memory
template <bool kWin, int kTexels>
__device__ __forceinline__ float sample(const float* __restrict__ src,
                                        const float* __restrict__ smem, const Window& w, int c,
                                        int width, size_t plane, const phn::Taps& t) {
  if (kWin)
    return lerp_taps(smem + c * kTexels, (t.y0 - w.r0) * w.pitch + t.x0 - w.c0, w.pitch, t);
  return lerp_taps(src + c * plane, t.y0 * width + t.x0, width, t);
}

// A thread's pixels of the tile (x_lo, y_lo): column x_lo + threadIdx.x,
// rows y_lo + threadIdx.y + kThreadRows * r before y_end, written at
// output row y - out_row0 (planes `plane` floats apart); a source sampled
// from its window (kWinA, kWinB) or from the frame (planes `splane`
// floats apart; kBand: tap rows valid in [s_lo, s_hi))
template <int kCh, bool kPair, bool kBand, bool kWinA, bool kWinB>
__device__ __forceinline__ void sample_tile(const float* __restrict__ a, const float* __restrict__ b,
                                            const float* __restrict__ mix,
                                            const float* __restrict__ mask, float* __restrict__ out,
                                            int height, int width, const Mat& ma, const Mat& mb,
                                            bool same_mat, const float* __restrict__ win_a,
                                            const float* __restrict__ win_b, const Window& wa,
                                            const Window& wb, int x_lo, int y_lo, int y_end,
                                            int out_row0, size_t plane, size_t splane, int s_lo,
                                            int s_hi) {
  using S = Shape<kPair>;
  const int x = x_lo + threadIdx.x;
  if (x >= width) return;
  const float ix = centred(x, width);
#pragma unroll
  for (int r = 0; r < S::kH / kThreadRows; ++r) {
    const int y = y_lo + threadIdx.y + kThreadRows * r;
    if (y >= y_end) break;
    const float iy = centred(y, height);
    const size_t o = static_cast<size_t>(y - out_row0) * width + x;
    if (!kPair) {
      if (wa.zero) {
#pragma unroll
        for (int c = 0; c < kCh; ++c) out[c * plane + o] = 0.0f;
        continue;
      }
      phn::Taps ta = affine_taps(ma, ix, iy, width, height);
      if (kBand) clip_rows(ta, s_lo, s_hi);
#pragma unroll
      for (int c = 0; c < kCh; ++c)
        out[c * plane + o] = sample<kWinA, S::kTexels>(a, win_a, wa, c, width, splane, ta);
      continue;
    }
    phn::Taps ta{}, tb{};
    if (!wa.zero) ta = affine_taps(ma, ix, iy, width, height);
    if (!wb.zero) tb = same_mat ? ta : affine_taps(mb, ix, iy, width, height);
    if (kBand) {  // a source whose window is empty (zero) reads no tap
      clip_rows(ta, s_lo, s_hi);
      clip_rows(tb, s_lo, s_hi);
    }
    const float m = mask != nullptr ? mask[o] : *mix;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float v = wa.zero ? 0.0f : sample<kWinA, S::kTexels>(a, win_a, wa, c, width, splane, ta);
      const float vb = wb.zero ? 0.0f : sample<kWinB, S::kTexels>(b, win_b, wb, c, width, splane, tb);
      out[c * plane + o] = mask != nullptr ? vb * m + v * (1.0f - m) : v * m + vb * (1.0f - m);
    }
  }
}

// Persistent blocks, each walking the output tiles blockIdx.x, blockIdx.x
// + gridDim.x, ...; with two buffers a tile's windows are copied while the
// block samples the tile before it, with one after that tile is sampled
// (a second barrier); warp 0 works out the windows of the tile after next
// (three descriptor slots).  b null: a single warp
// (kPair false); mat_b == mat: a pair under one matrix.  branches (may be
// null): window[0] and direct[1] counts, one per tile and source.  kBand:
// the band's tiles, from sources addressed by frame row (`band`); else
// the frame's, `band` unread.
template <int kCh, bool kPair, bool kBand>
__global__ void __launch_bounds__(kThreads)
    rotate_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ mat, const float* __restrict__ mat_b,
                  const float* __restrict__ mix, const float* __restrict__ mask,
                  float* __restrict__ out, int height, int width,
                  unsigned long long* __restrict__ branches, Band band) {
  using S = Shape<kPair>;
  extern __shared__ float windows[];  // [buffer][source][channel][S::kTexels]
  __shared__ Window desc[3][2];  // [tile slot][source]
  const int row0 = kBand ? band.row0 : 0, n_rows = kBand ? band.rows : height, y_end = row0 + n_rows;
  const int s_lo = kBand ? band.src_lo : 0, s_hi = kBand ? band.src_hi : height;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int n_tiles = tiles_x * ((n_rows + S::kH - 1) / S::kH);
  constexpr int kBuffer = S::kSources * kCh * S::kTexels;
  const size_t plane = static_cast<size_t>(width) * n_rows;
  const size_t splane = kBand ? band.src_plane : plane;
  const bool same_mat = mat_b == mat;
  const Mat ma = load_mat(mat), mb = load_mat(mat_b);

  // warp 0: the windows of the k-th tile of this block into its slot
  auto describe = [&](int k) {
    const int tile = blockIdx.x + k * gridDim.x;
    if (threadIdx.y != 0 || tile >= n_tiles) return;
    const Window w = tile_window<S::kH, S::kTexels>(ma, mb, (tile % tiles_x) * kTileW,
                                                    row0 + (tile / tiles_x) * S::kH, y_end, s_lo, s_hi,
                                                    width, height);
    if (threadIdx.x == 0 || (kPair && threadIdx.x == 4)) {
      desc[k % 3][threadIdx.x >> 2] = w;
      if (branches != nullptr) atomicAdd(branches + (w.fits ? 0 : 1), 1ull);
    }
  };
  // every thread: its share of the k-th tile's window copies
  auto copy = [&](int k) {
    if (blockIdx.x + k * gridDim.x >= n_tiles) return;
    float* buf = windows + (k % S::kBuffers) * kBuffer;
    copy_window<kCh, S::kTexels>(a, desc[k % 3][0], buf, width, splane);
    if (kPair) copy_window<kCh, S::kTexels>(b, desc[k % 3][1], buf + kCh * S::kTexels, width, splane);
  };

  describe(0);
  describe(1);
  __syncthreads();
  copy(0);
  phn::cp_async_commit();
  for (int k = 0;; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    if (tile >= n_tiles) break;
    phn::cp_async_wait<0>();
    __syncthreads();  // tile k's windows are in, tile k - 1 is sampled, slot k + 1 is described
    if (S::kBuffers == 2) {
      copy(k + 1);
      phn::cp_async_commit();
    }
    describe(k + 2);
    const Window wa = desc[k % 3][0], wb = desc[k % 3][kPair ? 1 : 0];
    const float* sa = windows + (k % S::kBuffers) * kBuffer;
    const float* sb = sa + kCh * S::kTexels;
    const int x_lo = (tile % tiles_x) * kTileW, y_lo = row0 + (tile / tiles_x) * S::kH;
    if (wa.fits && (!kPair || wb.fits)) {
      sample_tile<kCh, kPair, kBand, true, true>(a, b, mix, mask, out, height, width, ma, mb, same_mat, sa, sb,
                                          wa, wb, x_lo, y_lo, y_end, row0, plane, splane, s_lo, s_hi);
    } else if (wa.fits) {
      sample_tile<kCh, kPair, kBand, true, false>(a, b, mix, mask, out, height, width, ma, mb, same_mat, sa, sb,
                                           wa, wb, x_lo, y_lo, y_end, row0, plane, splane, s_lo, s_hi);
    } else if (kPair && wb.fits) {
      sample_tile<kCh, kPair, kBand, false, true>(a, b, mix, mask, out, height, width, ma, mb, same_mat, sa, sb,
                                           wa, wb, x_lo, y_lo, y_end, row0, plane, splane, s_lo, s_hi);
    } else {
      sample_tile<kCh, kPair, kBand, false, false>(a, b, mix, mask, out, height, width, ma, mb, same_mat, sa,
                                            sb, wa, wb, x_lo, y_lo, y_end, row0, plane, splane, s_lo, s_hi);
    }
    if (S::kBuffers == 1) {  // the one buffer is free once every warp has sampled it
      __syncthreads();
      copy(k + 1);
      phn::cp_async_commit();
    }
  }
}

template <int kCh, bool kPair, bool kBand>
int launch(const float* a, const float* b, const float* mat, const float* mat_b, const float* mix,
           const float* mask, float* out, int height, int width, unsigned long long* branches,
           const Band& band, cudaStream_t st) {
  using S = Shape<kPair>;
  const int smem = S::kBuffers * S::kSources * kCh * S::kTexels * static_cast<int>(sizeof(float));
  const auto kernel = rotate_kernel<kCh, kPair, kBand>;
  static int resident[phn::kMaxDevices];
  cudaError_t err;
  const int wave = phn::resident_blocks(kernel, kThreads, smem, resident, &err);
  if (wave == 0) return static_cast<int>(err);
  const int n_tiles = ((width + kTileW - 1) / kTileW) * ((band.rows + S::kH - 1) / S::kH);
  const int blocks = min(n_tiles, wave);
  kernel<<<blocks, dim3(kTileW, kThreadRows), smem, st>>>(a, b, mat, mat_b, mix, mask, out, height, width,
                                                          branches, band);
  return static_cast<int>(cudaGetLastError());
}

template <int kCh, bool kPair>
int launch_band(bool band_form, const float* a, const float* b, const float* mat, const float* mat_b,
                const float* mix, const float* mask, float* out, int height, int width,
                unsigned long long* branches, const Band& band, cudaStream_t st) {
  return band_form ? launch<kCh, kPair, true>(a, b, mat, mat_b, mix, mask, out, height, width, branches, band, st)
                   : launch<kCh, kPair, false>(a, b, mat, mat_b, mix, mask, out, height, width, branches, band, st);
}

}  // namespace

// a, b: the source windows, `channels` planes of src_rows rows by `width`
// columns, frame rows src_row0 .. src_row0 + src_rows - 1, each row
// `width` floats after the last and the planes of both src_plane floats
// apart (b null for a single warp); mat, mat_b: (3, 3) float32 (mat_b
// null: b under mat); mix: one float32 (dissolve); mask: (rows, width)
// float32 (wipe; null for a dissolve); out: (channels, rows, width), frame
// rows row0 .. row0 + rows - 1 of the (channels, height, width) result;
// branches: null, or two uint64 in device memory to which the (tile,
// source) pairs sampled from a window and straight from device memory are
// added.  A full-frame launch is row0 0, rows height, src_row0 0, src_rows
// height, src_plane width * height.  Returns cudaGetLastError().
extern "C" int phn_rotate(const void* a, const void* b, const void* mat, const void* mat_b,
                          const void* mix, const void* mask, void* out, int channels,
                          int height, int width, int row0, int rows, int src_row0, int src_rows,
                          int src_plane, void* branches, void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels != 3 && channels != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (!phn::band_ok(height, row0, rows, src_row0, src_rows) || width <= 0 ||
      src_plane < src_rows * width)
    return static_cast<int>(cudaErrorInvalidValue);
  // the windows addressed by frame row
  const auto fa = phn::frame_row0(static_cast<const float*>(a), src_row0, width);
  const auto fb = b != nullptr ? phn::frame_row0(static_cast<const float*>(b), src_row0, width) : nullptr;
  const auto fm = static_cast<const float*>(mat);
  const auto fmb = mat_b != nullptr ? static_cast<const float*>(mat_b) : fm;
  const auto fmix = static_cast<const float*>(mix), fmask = static_cast<const float*>(mask);
  const auto o = static_cast<float*>(out);
  const auto br = static_cast<unsigned long long*>(branches);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Band band{row0, rows, src_row0, src_row0 + src_rows, static_cast<size_t>(src_plane)};
  const bool bf = !(row0 == 0 && rows == height && src_row0 == 0 && src_rows == height &&
                    static_cast<long long>(src_plane) == static_cast<long long>(width) * height);
  if (b != nullptr) {
    return channels == 4 ? launch_band<4, true>(bf, fa, fb, fm, fmb, fmix, fmask, o, height, width, br, band, st)
                         : launch_band<3, true>(bf, fa, fb, fm, fmb, fmix, fmask, o, height, width, br, band, st);
  }
  return channels == 4 ? launch_band<4, false>(bf, fa, fb, fm, fmb, fmix, fmask, o, height, width, br, band, st)
                       : launch_band<3, false>(bf, fa, fb, fm, fmb, fmix, fmask, o, height, width, br, band, st);
}
