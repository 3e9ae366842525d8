// B6 packed_warp: the axis-aligned DVE warp of one v210 source, or of a
// dissolve pair under one shared or two distinct matrices, with the v210
// decode of every texel the taps reach, -> linear RGBA (4, H, W) float32.
//
// Replaces phaneron_tpu/ops/pallas_packed_warp.py:_make_program (reached
// through make_packed_warp_program and make_packed_warp_pair_program, n_mat
// 1 or 2): a v210 DVE layer that is not part of a whole-stack packed
// composite never writes its decoded RGBA frame to device memory.
//
// Output pixel (x, y) takes the taps of phn::axis_tap (the order of the
// plain version, ops/geometry.py warp_axis_aligned); each valid tap's
// texel is decoded by phn::decode_v210 (the decode K1 runs) and the lerps
// are those of phn::bilerp, so the kernel equals K1 (4 ch) -> K4 on the
// card to the bit, and its plain version (v210_unpack_plain ->
// warp_axis_aligned -> mix_frames) likewise.  Alpha is the warp of the
// constant-1 plane, bilerp(t, 1, 1, 1, 1), and a pair mixes after the
// warp, warp(a) * mix + warp(b) * (1 - mix), per channel alpha included,
// as the staged path does (the TPU kernel premixes a shared-matrix pair
// before one warp).
//
// Bound: device-memory bytes.  Each source word the matrices reach is
// read once and 16 bytes of RGBA are written per pixel.  The first design
// (tools/b6_variants.cu) gave each thread one output pixel and decoded
// every valid tap where it was used: four decodes a source and pixel,
// each with three gathers from the 256 KB gamma'->linear table.  Design,
// after K5's words kind (csrc/packed_composite.cu words_kernel): a block of
// kTileW x kThreadRows threads covers a tile of kTileW columns (32 groups)
// by kTileRows rows, each thread the rows of its column kThreadRows apart.
// From each matrix, read from device memory so animating it needs no host
// synchronisation, the block's warps work out the tile's end coordinates
// together and from them the window of groups and rows the taps reach
// (phn::span_of, whole groups) and whether every tap lies inside the
// frame; the block decodes a pair's two windows in one pass over all its
// threads into shared memory (one 16-byte load and six decodes a group
// of phn::decode_v210, about 1.26 decodes a source and output pixel at the
// entry frame's scale 0.95), then samples every tap from there, without
// bilerp's selects where every tap of the tile is inside, and stores each
// of the four planes coalesced.  A window larger than kWindowTexels (a box
// below about scale 0.8) is sampled straight from the words in the same
// launch, each tap decoded where it is used (phn::sample_v210;
// ops/packed_warp.py warp_window_counts); a source whose taps all lie
// outside the frame in the tile is +0 there and nothing of it is decoded.
// On the H100 the decode's gathers take about a third of the time and the
// sampling and stores most of the rest (tools/kernel_variants.py b6;
// PERF.md).
//
// Band form (a row-sharded channel, parallel/bands.py): the tiles start
// at the band's first output row and the words are a window of the rows
// its taps reach; every tap, tile window and inside test is worked out at
// the frame's own rows and height (ops/packed_warp.py warp_window_counts
// counts a band's tiles the same way).
#include "phn_common.cuh"

// The tile rows and window size, which ops/packed_warp.py owns
// (WARP_TILE_ROWS, WARP_WINDOW_TEXELS) and ops/_build.py passes as defines
#if !defined(PHN_PACKED_WARP_TILE_ROWS) || !defined(PHN_PACKED_WARP_WINDOW_TEXELS)
#error "build with ops/_build.py nvcc_flags(): the PHN_PACKED_WARP_* defines come from ops/packed_warp.py"
#endif

namespace {

constexpr int kTileW = phn::kPixelsPerBlock;  // output columns a tile (32 groups; ops/packed_warp.py WARP_TILE_W)
constexpr int kTileRows = PHN_PACKED_WARP_TILE_ROWS;  // output rows a tile
constexpr int kWindowTexels = PHN_PACKED_WARP_WINDOW_TEXELS;  // decoded texels a window may hold (3 planes)
constexpr int kThreadRows = 2;  // block rows; a thread takes its column's rows kThreadRows apart
constexpr int kThreads = kTileW * kThreadRows;
constexpr int kBlocksPerSm = 3;
// a pair's two windows, three float32 planes each
constexpr int kSmemBytes = 2 * 3 * kWindowTexels * static_cast<int>(sizeof(float));
static_assert(kTileRows % kThreadRows == 0, "a thread takes whole rows of a tile");

// A source in a tile: its window, whether it fits (else the tile samples
// the words), whether every tap of the tile lies inside the frame, and
// whether it is +0 (no tap inside the frame, every coordinate finite: each
// sample is 0 * (1 - f) + 0 * f)
struct Source {
  phn::Window win;
  bool fits, inside, zero;
};

// The sources of the tile under mat_a and mat_b (sb: 1 a second matrix,
// else a's), computed by every warp together: lane l < 8 works out the
// texel coordinate of end l % 4 (first and last column, first and last
// row) under matrix l / 4, and every lane takes them from there with
// shuffles, so a thread runs one division for the tile's geometry
__device__ __forceinline__ void sources_of(const float* mat_a, const float* mat_b, int sb, int x_lo,
                                           int x_hi, int y_lo, int y_hi, int width, int height,
                                           Source src[2]) {
  const int lane = threadIdx.x & 31;
  const float* m = lane & 4 && sb ? mat_b : mat_a;
  const bool col = (lane & 2) == 0;
  const float p = col ? phn::tap_coord(m[0], m[2], lane & 1 ? x_hi : x_lo, static_cast<float>(width))
                      : phn::tap_coord(m[4], m[5], lane & 1 ? y_hi : y_lo, static_cast<float>(height));
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __shfl_sync(0xffffffffu, p, 4 * s + k);
    if (s > sb) break;
    const phn::Span sp = phn::span_of(floorf(e[0]), floorf(e[1]), floorf(e[2]), floorf(e[3]), width, height, 6);
    src[s].win = sp.win;
    src[s].fits = sp.win.texels() <= kWindowTexels;
    src[s].inside = sp.inside;
    src[s].zero = sp.win.texels() == 0 && isfinite(e[0]) && isfinite(e[1]) && isfinite(e[2]) && isfinite(e[3]);
  }
  if (sb == 0) src[1] = src[0];
}

// Decode the windows of the tile's sources that are sampled from shared
// memory, both together: the block's threads take the groups of a's
// window, then b's, in turn (phn::decode_window's order and values)
__device__ __forceinline__ void decode_windows(const int4* __restrict__ a, const int4* __restrict__ b,
                                               int groups, const phn::Decode& d, const Source src[2],
                                               float* __restrict__ windows, int tid) {
  const bool da = src[0].fits && !src[0].zero, db = b != nullptr && src[1].fits && !src[1].zero;
  const int na = da ? src[0].win.texels() / 6 : 0, n = na + (db ? src[1].win.texels() / 6 : 0);
  for (int i = tid; i < n; i += kThreads) {
    const int s = i >= na ? 1 : 0, g = i - s * na;
    const phn::Window& w = src[s].win;
    const int wg = w.cols / 6, r = g / wg, plane = w.texels();
    const int4 q = __ldg((s ? b : a) + static_cast<size_t>(w.r0 + r) * groups + w.c0 / 6 + g - r * wg);
    float* o = windows + s * 3 * kWindowTexels + 6 * g;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      float rgb[3];
      phn::decode_v210(d, q, p, rgb);
      o[p] = rgb[0];
      o[plane + p] = rgb[1];
      o[2 * plane + p] = rgb[2];
    }
  }
}

// RGBA of a source at the taps: +0, from its decoded window (without
// bilerp's selects when every tap of the tile is inside the frame), or
// decoded at each tap from the words; alpha the warp of the constant-1
// plane, bilerp(t, 1, 1, 1, 1)
__device__ __forceinline__ void sample_rgba(const int4* __restrict__ words, int groups,
                                            const phn::Decode& d, const Source& s,
                                            const float* __restrict__ smem, const phn::Taps& t,
                                            float v[4]) {
  if (s.zero) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = 0.0f;
    return;
  }
  if (s.fits && s.inside) {
    const int cols = s.win.cols, plane = s.win.texels();
    const float* p = smem + (t.y0 - s.win.r0) * cols + t.x0 - s.win.c0;
    float q[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c][0] = p[c * plane];
      q[c][1] = p[c * plane + cols];
      q[c][2] = p[c * plane + 1];
      q[c][3] = p[c * plane + cols + 1];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float c0 = q[c][0] * (1.0f - t.fy) + q[c][1] * t.fy;
      const float c1 = q[c][2] * (1.0f - t.fy) + q[c][3] * t.fy;
      v[c] = c0 * (1.0f - t.fx) + c1 * t.fx;
    }
    const float one = 1.0f * (1.0f - t.fy) + 1.0f * t.fy;
    v[3] = one * (1.0f - t.fx) + one * t.fx;
    return;
  }
  if (s.fits) {
    phn::sample_window(smem, s.win, t, v);
  } else {
    phn::sample_v210(words, groups, d, t, v);
  }
  v[3] = phn::bilerp(t, 1.0f, 1.0f, 1.0f, 1.0f);
}

// b null: a single warp; mat_b == mat_a: a pair under one matrix.  A
// block of kTileW x kThreadRows threads covers a tile of kTileW x
// kTileRows output pixels, each thread the rows of its column kThreadRows
// apart.  branches (may be null): window[0] and direct[1] counts, one per
// tile and source.  An SM keeps kBlocksPerSm blocks.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    packed_warp_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                       const float* __restrict__ mat_a, const float* __restrict__ mat_b,
                       const float* __restrict__ mix, float* __restrict__ out,
                       const __grid_constant__ phn::Decode d, int width, int height, int groups,
                       int row0, int nrows, unsigned long long* __restrict__ branches) {
  extern __shared__ float windows[];  // source a's window, then b's: 3 planes of kWindowTexels each
  __shared__ phn::AxisTap row_taps[2][kTileRows];  // the tile's row taps under each matrix
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x_lo = blockIdx.x * kTileW;
  const int x = x_lo + threadIdx.x;
  const int y_lo = row0 + blockIdx.y * kTileRows;
  const int rows = min(kTileRows, row0 + nrows - y_lo);
  const int x_hi = min(x_lo + kTileW, width) - 1, y_hi = y_lo + rows - 1;
  const bool pair = b != nullptr;
  const int nb = pair && mat_b != mat_a ? 1 : 0;  // source b's taps
  // one decision a source for the whole block, from the tile's geometry
  Source src[2];
  sources_of(mat_a, mat_b, nb, x_lo, x_hi, y_lo, y_hi, width, height, src);
  const Source sa = src[0], sb = src[1];
  if (branches != nullptr && tid == 0) {
    atomicAdd(branches + (sa.fits ? 0 : 1), 1ull);
    if (pair) atomicAdd(branches + (sb.fits ? 0 : 1), 1ull);
  }
  if (tid < (nb + 1) * rows) {
    const int s = tid / rows, r = tid - s * rows;
    const float* m = s ? mat_b : mat_a;
    row_taps[s][r] = phn::axis_tap(m[4], m[5], y_lo + r, height);
  }
  float* win_b = windows + 3 * kWindowTexels;
  decode_windows(a, b, groups, d, src, windows, tid);
  __syncthreads();
  if (x >= width) return;
  const phn::AxisTap txa = phn::axis_tap(mat_a[0], mat_a[2], x, width);
  const phn::AxisTap txb = nb ? phn::axis_tap(mat_b[0], mat_b[2], x, width) : txa;
  const float mx = pair ? *mix : 0.0f;
  const size_t plane = static_cast<size_t>(width) * nrows;
#pragma unroll
  for (int i = 0; i < kTileRows / kThreadRows; ++i) {
    const int r = threadIdx.y + kThreadRows * i;
    if (r >= rows) break;
    const phn::Taps ta = phn::taps_of(txa, row_taps[0][r]);
    float v[4];
    sample_rgba(a, groups, d, sa, windows, ta, v);
    if (pair) {
      const phn::Taps tb = nb ? phn::taps_of(txb, row_taps[1][r]) : ta;
      float vb[4];
      sample_rgba(b, groups, d, sb, win_b, tb, vb);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = v[c] * mx + vb[c] * (1.0f - mx);
    }
    const size_t o = static_cast<size_t>(y_lo + r - row0) * width + x;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane + o] = v[c];
  }
}

}  // namespace

// a, b: v210 words, frame rows src_row0 .. src_row0 + src_rows - 1 of a
// (height, groups*4) int32 frame (b null for a single warp); mat_a, mat_b:
// (3, 3) float32 (mat_b == mat_a for a shared-matrix pair); mix: one
// float32 (ignored without b); out: (4, rows, width) float32, frame rows
// row0 .. row0 + rows - 1 of the (4, height, width) result (a full-frame
// launch: row0 0, rows height, src_row0 0, src_rows height).  coeffs:
// col[12], gamut[9]; g2l: the gamma'->linear table in device memory.
// branches: null, or two uint64 in device memory to which the (tile,
// source) pairs sampled from a decoded window [0] and straight from the
// words [1] are added.  Returns the first CUDA error.
extern "C" int phn_packed_warp(const void* a, const void* b, const void* mat_a,
                               const void* mat_b, const void* mix, void* out, int width,
                               int height, int groups, int row0, int rows, int src_row0,
                               int src_rows, const float* coeffs, const float* g2l,
                               void* branches, void* stream) {
  if (b != nullptr && (mat_b == nullptr || mix == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!phn::band_ok(height, row0, rows, src_row0, src_rows) || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int resident[phn::kMaxDevices];  // the shared-memory limit raised once a device
  cudaError_t err;
  if (phn::resident_blocks(packed_warp_kernel, kThreads, kSmemBytes, resident, &err) == 0)
    return static_cast<int>(err);
  // the windows addressed by frame row (a band's tiles start at row0; a
  // tile that straddles the band's last row is clipped to it)
  const int4* wa = phn::frame_row0(static_cast<const int4*>(a), src_row0, groups);
  const int4* wb = b != nullptr ? phn::frame_row0(static_cast<const int4*>(b), src_row0, groups) : nullptr;
  const dim3 grid((width + kTileW - 1) / kTileW, (rows + kTileRows - 1) / kTileRows);
  packed_warp_kernel<<<grid, dim3(kTileW, kThreadRows), kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      wa, wb, static_cast<const float*>(mat_a), static_cast<const float*>(mat_b),
      static_cast<const float*>(mix), static_cast<float*>(out),
      phn::decode_from(coeffs, g2l), width, height, groups, row0, rows,
      static_cast<unsigned long long*>(branches));
  return static_cast<int>(cudaGetLastError());
}
