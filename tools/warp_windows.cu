// K4's windowed design, kept beside the built kernel for comparison
// (tools/kernel_variants.py k4): measured on the H100, it lost to the
// one-thread-a-pixel kernel with channels and mode as template constants
// (csrc/warp.cu) at every shape timed, the UHD wipe included (PERF.md),
// so the simpler kernel is built.  Same function, same plain version
// (ops/warp.py warp_plain), max |delta| 0.
//
// Persistent blocks walk output tiles of 32 columns by kTileH rows; the
// channel count and the mode are template constants.  Under an
// axis-aligned matrix the taps are separable: the block works out each
// tile's column and row taps once, in shared memory and three tiles
// ahead, and from the taps of the tile's end columns and rows the window
// of source texels they reach (phn::span_of, 4-texel aligned).  Each
// source's window, every channel plane, is copied into shared memory with
// cp.async, 16 bytes a copy where frame rows allow (else a texel a copy),
// both sources of a pair under one matrix in one pass: a tile ahead when
// this tile's windows and the next one's each fit in half the buffer
// (scales near 1), else after the tile is sampled.  Every tap is then
// sampled from there, without bilerp's selects where every tap of the tile
// lies inside the frame.  A window larger than the window texels (a strong
// minify) leaves its source to the gather from device memory for that
// tile, in the same launch, counted in branches[1]; a source whose taps
// all fall outside the frame in a tile is +0 there and is not sampled.
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

// the tile and window sizes as they were measured
#define PHN_WARP_TILE_H 16
#define PHN_WARP_PAIR_TILE_H 16
#define PHN_WARP_WINDOW_TEXELS 2176
#define PHN_WARP_PAIR_WINDOW_TEXELS 2176

namespace {

constexpr int kTileW = 32;  // output tile columns: a warp's row
constexpr int kThreadRows = 8;  // block rows; a thread takes its column's pixels kThreadRows apart
constexpr int kThreads = kTileW * kThreadRows;
constexpr int kTileH = PHN_WARP_TILE_H;  // output tile rows of a single warp
constexpr int kWindowTexels = PHN_WARP_WINDOW_TEXELS;  // shared-memory texels of a single warp's window a channel
constexpr int kPairTileH = PHN_WARP_PAIR_TILE_H;  // the same for a pair, whose tiles hold two windows
constexpr int kPairWindowTexels = PHN_WARP_PAIR_WINDOW_TEXELS;
constexpr int kAlign = 4;  // window columns: 16-byte copies
constexpr int kBlocksPerSm = 3;  // registers for three blocks an SM
static_assert(kTileH % kThreadRows == 0 && kPairTileH % kThreadRows == 0, "a warp is one row of a tile");
static_assert(kWindowTexels % (2 * kAlign) == 0 && kPairWindowTexels % (2 * kAlign) == 0,
              "window planes, whole or halved, stay 16-byte aligned");

constexpr int kSingle = 0, kDissolve = 1, kWipe = 2;  // modes

// The tile rows and window texels of a launch: a single warp or a pair
template <int kMode>
struct Shape {
  static constexpr bool kPair = kMode != kSingle;
  static constexpr int kH = kPair ? kPairTileH : kTileH;
  static constexpr int kTexels = kPair ? kPairWindowTexels : kWindowTexels;
  static constexpr int kSources = kPair ? 2 : 1;
};
constexpr int kMaxTaps = kTileW + (kTileH > kPairTileH ? kTileH : kPairTileH);

// A source in a tile: its window (phn::Window; rows 0: no tap of the tile
// lands inside the frame), whether the window fits in the launch's window
// texels (else the tile samples the source from device memory), whether
// every tap of the tile lies inside the frame, and whether the source is
// +0 in the tile: its window is empty and the tile's end coordinates are
// finite, so every coordinate is and each sample is 0 * (1 - f) + 0 * f.
struct Source {
  phn::Window win;
  int fits, inside, zero;
};

// A tile's sources and where their windows lie in the block's buffer:
// both halves' worth of planes from 0 (plane stride kTexels), or, when
// every copied window of the tile fits in half a plane, the half the
// tile's parity picks (plane stride kTexels / 2), so that two tiles in a
// row whose windows are small use different halves
struct Tile {
  Source src[2];
  int half, base, stride;
};
// A tile's taps in shared memory, columns [0, kTileW) then rows: the
// floor of each texel coordinate (phn::tap_coord) and its fraction, as
// phn::axis_tap computes them
struct TapTable {
  float fl[2][kMaxTaps];
  float f[2][kMaxTaps];
};

// The taps of output indices [lo, lo + n) along one axis into the table
// from entry j0: thread tid (from 0; a negative tid takes none) the
// entries tid, tid + stride, ...
__device__ __forceinline__ void fill_taps(TapTable& tt, int s, int j0, int n, float m, float off,
                                          int lo, float size, int tid, int stride) {
  if (tid < 0) return;
  for (int j = tid; j < n; j += stride) {
    const float p = phn::tap_coord(m, off, lo + j, size);
    const float fl = floorf(p);
    tt.fl[s][j0 + j] = fl;
    tt.f[s][j0 + j] = p - fl;
  }
}

// Source s of the tile from its taps: the ends of each axis bound every
// floor between them (tap_coord is monotonic), so phn::span_of on their
// floors gives tile_window's window and span_inside's answer, and the
// source is +0 when its window is empty and the ends' coordinates are
// finite (xn, yn: the tile's columns and rows inside the frame)
template <int kTexels>
__device__ __forceinline__ Source source_of(const TapTable& tt, int s, int xn, int yn, int width,
                                            int height) {
  const phn::Span sp = phn::span_of(tt.fl[s][0], tt.fl[s][xn - 1], tt.fl[s][kTileW],
                                    tt.fl[s][kTileW + yn - 1], width, height, kAlign);
  Source src;
  src.win = sp.win;
  src.fits = sp.win.texels() <= kTexels;
  src.inside = sp.inside;
  src.zero = sp.win.texels() == 0 && isfinite(tt.f[s][0]) && isfinite(tt.f[s][xn - 1]) &&
             isfinite(tt.f[s][kTileW]) && isfinite(tt.f[s][kTileW + yn - 1]);
  return src;
}

// Issue the copies of a source's window, every channel plane of src into
// smem (plane c at c * stride, row pitch win.cols), and with src_b (a
// second source with the same window, a pair under one matrix) its planes
// after them: the block's threads take the copies in row-major order, a
// copy's channels one after another; 16-byte copies where vec, else a
// texel a copy inside the frame.  A copy's row in the window is its index
// times ceil(2^32 / copies a row), shifted down by 32: exact below 2^23.
template <int kCh>
__device__ __forceinline__ void copy_window(const float* __restrict__ src,
                                            const float* __restrict__ src_b, const Source& s,
                                            float* __restrict__ smem, int stride, int width,
                                            size_t plane, bool vec) {
  if (!s.fits || s.zero) return;
  const phn::Window& w = s.win;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int unit = vec ? kAlign : 1, per_row = w.cols / unit, n = w.rows * per_row;
  const unsigned long long magic =
      static_cast<unsigned long long>(__fdiv_ru(4294967296.0f, static_cast<float>(per_row)));
  for (int e = tid; e < n; e += kThreads) {
    const int r = static_cast<int>((static_cast<unsigned long long>(e) * magic) >> 32);
    const int c = (e - r * per_row) * unit;
    const size_t at = static_cast<size_t>(w.r0 + r) * width + w.c0 + c;
    float* d = smem + r * w.cols + c;
    if (vec) {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) phn::cp_async16(d + ch * stride, src + at + ch * plane);
      if (src_b != nullptr) {
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) phn::cp_async16(d + (kCh + ch) * stride, src_b + at + ch * plane);
      }
    } else if (w.c0 + c < width) {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) phn::cp_async4(d + ch * stride, src + at + ch * plane);
      if (src_b != nullptr) {
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) phn::cp_async4(d + (kCh + ch) * stride, src_b + at + ch * plane);
      }
    }
  }
}

// Every channel of a source at the taps t: +0 (zero), from its window
// (without bilerp's selects when every tap of the tile is inside), or from
// the frame in device memory; the same values and lerps as phn::sample.
template <int kCh>
__device__ __forceinline__ void sample_source(const float* __restrict__ src,
                                              const float* __restrict__ smem, int stride,
                                              const Source& s, const phn::Taps& t, int width,
                                              size_t plane, float v[kCh]) {
  if (s.zero) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) v[c] = 0.0f;
  } else if (s.fits) {
    const int cols = s.win.cols;
    const float* p = smem + (t.y0 - s.win.r0) * cols + t.x0 - s.win.c0;
    if (s.inside) {
      float q[kCh][4];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        q[c][0] = p[c * stride];
        q[c][1] = p[c * stride + cols];
        q[c][2] = p[c * stride + 1];
        q[c][3] = p[c * stride + cols + 1];
      }
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const float c0 = q[c][0] * (1.0f - t.fy) + q[c][1] * t.fy;
        const float c1 = q[c][2] * (1.0f - t.fy) + q[c][3] * t.fy;
        v[c] = c0 * (1.0f - t.fx) + c1 * t.fx;
      }
    } else {
      const bool v00 = t.vx0 && t.vy0, v01 = t.vx0 && t.vy1, v10 = t.vx1 && t.vy0,
                 v11 = t.vx1 && t.vy1;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const float* q = p + c * stride;
        v[c] = phn::bilerp(t, v00 ? q[0] : 0.0f, v01 ? q[cols] : 0.0f, v10 ? q[1] : 0.0f,
                           v11 ? q[cols + 1] : 0.0f);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCh; ++c) v[c] = phn::sample(src + c * plane, width, t);
  }
}

// One axis's tap from the tile's table entry j
__device__ __forceinline__ void tap_of(const TapTable& tt, int s, int j, int size, int& i0,
                                       float& f, bool& v0, bool& v1) {
  i0 = static_cast<int>(tt.fl[s][j]);
  f = tt.f[s][j];
  v0 = i0 >= 0 && i0 < size;
  v1 = i0 + 1 >= 0 && i0 + 1 < size;
}

// Persistent blocks, each walking the output tiles blockIdx.x, blockIdx.x
// + gridDim.x, ...  Tile k + 1's windows are copied while the block
// samples tile k when both tiles' windows fit in half the buffer (Tile),
// else after tile k is sampled (a second barrier).  While it samples tile
// k the block works out the taps of tile k + 3 (every thread its share,
// four table slots) and, from the taps of tile k + 2, its sources (thread
// 0, three slots), so no warp holds up a barrier with a tile's geometry.
// b null: a single warp (kMode kSingle); mat_b == mat: a pair under one
// matrix.  vec: 16-byte copies.  branches (may be null): window[0] and
// direct[1] counts, one per tile and source.
template <int kCh, int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ mat, const float* __restrict__ mat_b,
                const float* __restrict__ mix, const float* __restrict__ mask,
                float* __restrict__ out, int height, int width, int vec,
                unsigned long long* __restrict__ branches) {
  using S = Shape<kMode>;
  extern __shared__ __align__(16) float windows[];  // [source][channel][S::kTexels], or two halves of it
  __shared__ TapTable taps[4];  // [tile slot]
  __shared__ Tile desc[3];  // [tile slot]
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int n_tiles = tiles_x * ((height + S::kH - 1) / S::kH);
  constexpr int kHalf = S::kSources * kCh * S::kTexels / 2;
  const size_t plane = static_cast<size_t>(width) * height;
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const bool same_mat = mat_b == mat;
  const int sb = S::kPair && !same_mat ? 1 : 0;  // source b's taps
  const float mx = kMode == kDissolve ? *mix : 0.0f;
  const float ma[4] = {__ldg(mat), __ldg(mat + 2), __ldg(mat + 4), __ldg(mat + 5)};
  const float mb[4] = {__ldg(mat_b), __ldg(mat_b + 2), __ldg(mat_b + 4), __ldg(mat_b + 5)};
  const auto tile_xy = [&](int k, int& x_lo, int& y_lo) {
    const int tile = blockIdx.x + k * gridDim.x;
    x_lo = (tile % tiles_x) * kTileW;
    y_lo = (tile / tiles_x) * S::kH;
    return tile < n_tiles;
  };

  // every thread: its share of the taps of the k-th tile of this block
  auto describe_taps = [&](int k) {
    int x_lo, y_lo;
    if (!tile_xy(k, x_lo, y_lo)) return;
    TapTable& tt = taps[k % 4];
    fill_taps(tt, 0, 0, kTileW, ma[0], ma[1], x_lo, fw, tid, kThreads);
    fill_taps(tt, 0, kTileW, S::kH, ma[2], ma[3], y_lo, fh, tid - kTileW, kThreads);
    if (sb) {
      fill_taps(tt, 1, 0, kTileW, mb[0], mb[1], x_lo, fw, tid - kTileW - S::kH, kThreads);
      fill_taps(tt, 1, kTileW, S::kH, mb[2], mb[3], y_lo, fh, tid - 2 * kTileW - S::kH, kThreads);
    }
  };
  // thread 0: the k-th tile's sources from its taps, and its place in the buffer
  auto describe_sources = [&](int k) {
    int x_lo, y_lo;
    if (tid != 0 || !tile_xy(k, x_lo, y_lo)) return;
    Tile t;
    bool half = true;
#pragma unroll
    for (int s = 0; s < S::kSources; ++s) {
      t.src[s] = source_of<S::kTexels>(taps[k % 4], s ? sb : 0, min(kTileW, width - x_lo),
                                       min(S::kH, height - y_lo), width, height);
      half = half && (!t.src[s].fits || t.src[s].zero || 2 * t.src[s].win.texels() <= S::kTexels);
      if (branches != nullptr) atomicAdd(branches + (t.src[s].fits ? 0 : 1), 1ull);
    }
    t.half = half;
    t.base = half && (k & 1) ? kHalf : 0;
    t.stride = half ? S::kTexels / 2 : S::kTexels;
    desc[k % 3] = t;
  };
  // every thread: its share of the k-th tile's window copies
  auto copy = [&](int k) {
    if (blockIdx.x + k * gridDim.x >= n_tiles) return;
    const Tile& t = desc[k % 3];
    float* buf = windows + t.base;
    if (S::kPair && !sb) {  // one window: both sources' copies in one pass
      copy_window<kCh>(a, b, t.src[0], buf, t.stride, width, plane, vec);
      return;
    }
    copy_window<kCh>(a, nullptr, t.src[0], buf, t.stride, width, plane, vec);
    if (S::kPair) copy_window<kCh>(b, nullptr, t.src[1], buf + kCh * t.stride, t.stride, width, plane, vec);
  };

  describe_taps(0);
  describe_taps(1);
  __syncthreads();
  describe_sources(0);
  describe_sources(1);
  describe_taps(2);
  __syncthreads();
  copy(0);
  phn::cp_async_commit();
  for (int k = 0;; ++k) {
    int x_lo, y_lo;
    if (!tile_xy(k, x_lo, y_lo)) break;
    phn::cp_async_wait<0>();
    __syncthreads();  // tile k's windows are in, tile k - 1 is sampled, slot k + 1 is described
    const bool ahead = desc[k % 3].half && desc[(k + 1) % 3].half;  // tile k + 1 in the other half
    if (ahead) {
      copy(k + 1);
      phn::cp_async_commit();
    }
    describe_taps(k + 3);
    describe_sources(k + 2);
    const Tile& tile = desc[k % 3];
    const Source sa = tile.src[0], sbd = tile.src[S::kPair ? 1 : 0];
    const int stride = tile.stride;
    const TapTable& tt = taps[k % 4];
    const float* win_a = windows + tile.base;
    const float* win_b = win_a + kCh * stride;
    const int x = x_lo + threadIdx.x;
    if (x < width) {
      phn::Taps ta, tb;
      tap_of(tt, 0, threadIdx.x, width, ta.x0, ta.fx, ta.vx0, ta.vx1);
      tap_of(tt, sb, threadIdx.x, width, tb.x0, tb.fx, tb.vx0, tb.vx1);
#pragma unroll
      for (int r = 0; r < S::kH / kThreadRows; ++r) {
        const int j = threadIdx.y + kThreadRows * r, y = y_lo + j;
        if (y >= height) break;
        const size_t o = static_cast<size_t>(y) * width + x;
        tap_of(tt, 0, kTileW + j, height, ta.y0, ta.fy, ta.vy0, ta.vy1);
        float v[kCh];
        sample_source<kCh>(a, win_a, stride, sa, ta, width, plane, v);
        if (!S::kPair) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) out[c * plane + o] = v[c];
          continue;
        }
        tap_of(tt, sb, kTileW + j, height, tb.y0, tb.fy, tb.vy0, tb.vy1);
        float vb[kCh];
        sample_source<kCh>(b, win_b, stride, sbd, tb, width, plane, vb);
        const float m = kMode == kWipe ? mask[o] : mx;
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          out[c * plane + o] = kMode == kWipe ? vb[c] * m + v[c] * (1.0f - m) : v[c] * m + vb[c] * (1.0f - m);
      }
    }
    if (!ahead) {  // the buffer is free once every warp has sampled tile k
      __syncthreads();
      copy(k + 1);
      phn::cp_async_commit();
    }
  }
}

template <int kCh, int kMode>
int launch(const float* a, const float* b, const float* mat, const float* mat_b, const float* mix,
           const float* mask, float* out, int height, int width, unsigned long long* branches,
           cudaStream_t st) {
  using S = Shape<kMode>;
  const int smem = S::kSources * kCh * S::kTexels * static_cast<int>(sizeof(float));
  const auto kernel = warp_kernel<kCh, kMode>;
  static int resident[phn::kMaxDevices];
  cudaError_t err;
  const int wave = phn::resident_blocks(kernel, kThreads, smem, resident, &err);
  if (wave == 0) return static_cast<int>(err);
  const int n_tiles = ((width + kTileW - 1) / kTileW) * ((height + S::kH - 1) / S::kH);
  const int blocks = min(n_tiles, wave);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = (width % kAlign) == 0 && aligned(a) && (b == nullptr || aligned(b));
  kernel<<<blocks, dim3(kTileW, kThreadRows), smem, st>>>(a, b, mat, mat_b, mix, mask, out, height, width, vec,
                                                          branches);
  return static_cast<int>(cudaGetLastError());
}

template <int kCh>
int launch_mode(const float* a, const float* b, const float* mat, const float* mat_b, const float* mix,
                const float* mask, float* out, int height, int width, unsigned long long* branches,
                cudaStream_t st) {
  if (b == nullptr) return launch<kCh, kSingle>(a, b, mat, mat_b, mix, mask, out, height, width, branches, st);
  if (mask != nullptr) return launch<kCh, kWipe>(a, b, mat, mat_b, mix, mask, out, height, width, branches, st);
  return launch<kCh, kDissolve>(a, b, mat, mat_b, mix, mask, out, height, width, branches, st);
}

}  // namespace

// a, b: (channels, height, width) float32 (b null for a single warp);
// mat, mat_b: (3, 3) float32 (mat_b null: b under mat); mix: one float32
// (dissolve); mask: (height, width) float32 (wipe; null for a dissolve);
// out: like a; branches: null, or two uint64 in device memory to which the
// (tile, source) pairs sampled from a window and straight from device
// memory are added.  Returns cudaGetLastError().
extern "C" int warp_windows(const void* a, const void* b, const void* mat, const void* mat_b,
                            const void* mix, const void* mask, void* out, int channels, int height,
                            int width, void* branches, void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels != 3 && channels != 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto fa = static_cast<const float*>(a), fb = static_cast<const float*>(b);
  const auto fm = static_cast<const float*>(mat);
  const auto fmb = mat_b != nullptr ? static_cast<const float*>(mat_b) : fm;
  const auto fmix = static_cast<const float*>(mix), fmask = static_cast<const float*>(mask);
  const auto o = static_cast<float*>(out);
  const auto br = static_cast<unsigned long long*>(branches);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return channels == 4 ? launch_mode<4>(fa, fb, fm, fmb, fmix, fmask, o, height, width, br, st)
                       : launch_mode<3>(fa, fb, fm, fmb, fmix, fmask, o, height, width, br, st);
}
