// K5 packed_composite: a run of DVE layers, each a cut or a dissolve pair
// under one axis-aligned matrix, 'over' composited bottom to top, in one
// launch, emitting v210 words ('packed'), the composited frame ('rgba') or
// both.  Sources are opaque (3, H, W) float32 frames (kind rgb3), v210
// words (kind packed), or (4, H, W) float32 RGBA frames that carry their
// own alpha (kind rgba).
//
// Replaces three TPU kernels:
// - phaneron_tpu/ops/pallas_packed_warp.py:make_packed_composite_program
//   in all its emits, with src_kind 'rgb3' (the tick of an interlaced
//   channel: deinterlaced fields -> premixed warps -> 'over' -> encode ->
//   v210) and src_kind 'packed' (the progressive multi-layer v210
//   channel: the whole frame from source words to output words);
// - phaneron_tpu/ops/pallas_composite.py:make_composite_program (B15:
//   every layer's v210 words decoded, warped, dissolved, 'over' black,
//   alpha the top layer's separable warp alpha): kind packed, alpha top;
// - phaneron_tpu/ops/pallas_warp.py:make_layers_combine_program (B16:
//   every layer's (4, H, W) RGBA warped with its own alpha, the pair
//   mixed, 'over', alpha the top layer's): kind rgba, alpha top.
//
// Per output pixel and layer m the kernel computes, in the operation order
// of the staged plain path (ops/packed_warp.py packed_composite_plain =
// [v210_unpack_plain, 3 channels,] warp_plain, warp_alpha_vectors,
// combine_rgb, coverage, v210_pack_plain):
//   v_m = warp(a) * mix + warp(b) * (1 - mix)       (phn::sample_window, or
//                                                    phn::sample / sample_v210
//                                                    on the direct branch; for
//                                                    rgba phn::sample, all four
//                                                    channels)
//   alpha_m = wy[y] * wx[x]                         (the separable warp alpha of
//                                                    an opaque source), or
//   alpha_m = v_m.a                                 (kind rgba)
//   out = v_0.rgb;  out = out * (1 - alpha_m) + v_m.rgb  for m >= 1
//   cover = alpha_0;  cover = cover * (1 - alpha_m) + alpha_m
// then the v210 encode and packing of K2 (csrc/combine_pack.cu), and/or the
// (4, H, W) frame: (out, cover), the run's coverage alpha, which a layer
// above or below composites with (a run that spans part of the stack), or
// with top_alpha (a run that is the whole stack) (out, alpha_top), the
// top layer's alpha that the reference emits (combine.ts:47-59).  The
// bottom layer is written as it is: over black, 0 * k + v == v.  With
// -fmad=false it equals [K1 (3 ch) +] K4 + combine_rgb + K2 on the card
// to the bit, and the plain version up to the pack's powf rounding.  The
// TPU kernels premix the two sources before one warp and run the warp as
// bf16 hi/lo products (~2^-17), with a polynomial gamma in the decode;
// the port keeps the staged order and the exact decode, which its plain
// version and tests share.
//
// Bound: for v210 words, float32 operations (the decode of each source
// texel the matrices reach, about 50 operations, and three gamma'->linear
// gathers, which the operation count takes as loads); for frames,
// device-memory bytes (each source texel read once, 16/6 bytes of words
// or 16 bytes of frame written per pixel).  No intermediate frame, alpha
// plane or composite touches device memory.  On the H100 the v210 kind
// runs far from that bound: with no decode at all it keeps about 58 % of
// its time (sampling four taps of eight sources from the windows,
// compositing, encoding), and the decode's gathers from the 256 KB table,
// through an L1 that shares the SM's 256 KB with shared memory, are the
// largest part of the rest (tools/kernel_variants.py; PERF.md).
//
// Design.  Kinds packed and rgb3: a block covers a tile of
// kPixelsPerBlock columns (32 groups) by a few rows, each thread a
// column's composites in registers while the layers go by, and each
// source is brought into shared memory once a tile, as the TPU kernel
// brings its VMEM row window in once a block (pallas_packed_warp.py
// decode_window): from the layer's matrix, read from device memory so
// animating it needs no host synchronisation, the texels and rows the
// taps reach (phn::tile_window), a layer's one or two sources together;
// every tap is then sampled from there.
// - v210 words (words_kernel): the block decodes its tile's window (one
//   16-byte load and six decodes a group): at the progressive frame's
//   scale-0.9 matrices about 2 decodes per source and output pixel, where
//   decoding each tap took 4.  Tiles of 4 rows, four blocks an SM and 37
//   KB of windows a block measured faster than taller tiles, which decode
//   less but keep fewer blocks and leave L1 less room for the table.
// - rgb3 frames (frame_tile_kernel, below): 192 x 6 tiles, the window
//   copied with cp.async, 16 bytes a lane (a window starts on a multiple
//   of 4 texels), the next layer's while this one is sampled; a tile whose
//   taps all lie inside the frame samples without bilerp's selects.
// A window larger than the kind's limit (a box below about scale 0.8, m00
// above 1.2; at scale 0.5 and below every tap reads texels of its own, so
// a window would save nothing) is sampled straight from device memory in
// the same launch, each tap read (and decoded) where it is used: the
// choice is keyed on the tile's geometry.
// Kind rgba (frames_kernel): one thread a pixel of one row, each tap read
// from device memory.
// Then the v210 encode packs each output row (phn::encode_pack_block, or
// frame_tile_kernel's encode_pack_tile for a whole tile).
//
// Band form (a row-sharded channel, parallel/bands.py): the tiles (192x4
// over words, 192x6 over rgb3 frames, a row a block over rgba frames)
// start at the band's first output row, not at a multiple of the tile
// height, and each source is a window of the rows its layer's taps reach,
// with its own first row; taps, tile windows and alphas are worked out at
// the frame's own rows and height, so every output pixel equals the
// full-frame launch's.
#include "phn_common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxSrcs = 2 * kMaxLayers;
// v210 words: output rows per tile, the decoded texels a window may hold
// (3 float32 planes), and the blocks an SM keeps (registers and shared
// memory for four, the rest of the SM's 256 KB left to L1, where the
// gamma'->linear table's gathers hit)
constexpr int kTileRows = 4;
constexpr int kWindowTexels = 1536;
constexpr int kBlocksPerSm = 4;
// two windows (a dissolve pair's), three float32 planes each, within the
// 48 KB a block gets without raising its limit (the static encode buffers
// and row taps come on top)
constexpr int kSmemBytes = 2 * 3 * kWindowTexels * static_cast<int>(sizeof(float));
static_assert(kSmemBytes <= 44 * 1024, "the windows need cudaFuncAttributeMaxDynamicSharedMemorySize");
// rgb3 frames: the block's rows of threads, the rows of a tile each thread
// composites, the texels a window may hold (3 float32 planes), and the
// blocks an SM keeps
constexpr int kFrameThreadRows = 2;
constexpr int kFrameRowsPerThread = 3;
constexpr int kFrameWindowTexels = 1792;
constexpr int kFrameBlocksPerSm = 2;

struct Layers {
  const void* src[kMaxSrcs];  // bottom..top, n_src per layer, addressed by frame row
  const float* mat[kMaxLayers];  // (3, 3) each
  const float* mix[kMaxLayers];  // one float each; null for a cut
  int n_src[kMaxLayers];  // 1 cut, 2 dissolve pair
  int n_layers;
  size_t plane[kMaxSrcs];  // frames: floats between a source's channel planes
};

// Source kinds (ops/packed_warp.py _KINDS)
constexpr int kRgb3 = 0;
constexpr int kPacked = 1;
constexpr int kRgba = 2;

// One frame's linear RGB (kind rgba: RGBA) at the taps, its channel
// planes `plane` floats apart
template <int kKind>
__device__ __forceinline__ void sample_planes(const void* src, size_t plane, const phn::Taps& tp,
                                              int width, float v[4]) {
  const float* s = static_cast<const float*>(src);
#pragma unroll
  for (int c = 0; c < (kKind == kRgba ? 4 : 3); ++c) v[c] = phn::sample(s + c * plane, width, tp);
}

// A whole frame's (width * height apart)
template <int kKind>
__device__ __forceinline__ void sample_frame(const void* src, const phn::Taps& tp, int width,
                                             int height, float v[4]) {
  sample_planes<kKind>(src, static_cast<size_t>(width) * height, tp, width, v);
}

// The separable alpha of an opaque source's warp at the taps, warp(ones):
// (row-weight sum) x (column-weight sum), ops/warp.py warp_alpha_vectors
__device__ __forceinline__ float warp_alpha(const phn::AxisTap& tx, const phn::AxisTap& ty) {
  const float wy = (ty.v0 ? 1.0f - ty.f : 0.0f) + (ty.v1 ? ty.f : 0.0f);
  const float wx = (tx.v0 ? 1.0f - tx.f : 0.0f) + (tx.v1 ? tx.f : 0.0f);
  return wy * wx;
}

// Frames (kinds rgb3, rgba): one thread a pixel of one row, each tap read
// from device memory.  kBand false: a full-frame launch (row0 0, nrows
// height, every source whole, its planes width * height apart), with no
// band arithmetic in its code.
template <int kKind, bool kBand>
__global__ void frames_kernel(Layers L, int4* __restrict__ words, float* __restrict__ rgba,
                              phn::Encode e, int width, int height, int groups, int row0,
                              int nrows, int top_alpha) {
  constexpr int kCh = kKind == kRgba ? 4 : 3;
  const int band_row = blockIdx.y;  // the row in the output (the band)
  const int row = kBand ? row0 + band_row : band_row;  // the frame's row
  const int x = blockIdx.x * phn::kPixelsPerBlock + threadIdx.x;
  float out[3] = {0.0f, 0.0f, 0.0f};
  float cover = 0.0f, a = 0.0f;
  if (x < width) {
    int s = 0;
    for (int m = 0; m < L.n_layers; ++m) {
      const phn::Taps tp = phn::axis_taps(L.mat[m], x, row, width, height);
      float v[4];
      if constexpr (kBand) {
        sample_planes<kKind>(L.src[s], L.plane[s], tp, width, v);
      } else {
        sample_frame<kKind>(L.src[s], tp, width, height, v);
      }
      if (L.n_src[m] == 2) {
        const float mx = *L.mix[m];
        float vb[4];
        if constexpr (kBand) {
          sample_planes<kKind>(L.src[s + 1], L.plane[s + 1], tp, width, vb);
        } else {
          sample_frame<kKind>(L.src[s + 1], tp, width, height, vb);
        }
#pragma unroll
        for (int c = 0; c < kCh; ++c) v[c] = v[c] * mx + vb[c] * (1.0f - mx);
      }
      if (kKind == kRgba) {
        a = v[3];
      } else {
        const float wy = (tp.vy0 ? 1.0f - tp.fy : 0.0f) + (tp.vy1 ? tp.fy : 0.0f);
        const float wx = (tp.vx0 ? 1.0f - tp.fx : 0.0f) + (tp.vx1 ? tp.fx : 0.0f);
        a = wy * wx;
      }
      const float k = 1.0f - a;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = m == 0 ? v[c] : out[c] * k + v[c];
      cover = m == 0 ? a : cover * k + a;
      s += L.n_src[m];
    }
    if (rgba != nullptr) {
      const size_t plane = static_cast<size_t>(width) * (kBand ? nrows : height);
      const size_t o = static_cast<size_t>(band_row) * width + x;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgba[c * plane + o] = out[c];
      rgba[3 * plane + o] = top_alpha ? a : cover;
    }
  }
  if (words != nullptr) phn::encode_pack_block(e, out, x, width, band_row, groups, words);
}

// v210 words (kind packed): a tile of kPixelsPerBlock columns by kTileRows
// rows a block, each thread one column's composite of the tile's rows.
// A layer's sources (a cut's one, a dissolve pair's two) are decoded
// together, each into its window when the windows fit (sampled straight
// from the words otherwise); then each row samples them, mixes and
// composites.  branches (may be null): window[0] and direct[1] counts, one
// per tile and source.  An SM keeps kBlocksPerSm blocks.
__global__ void __launch_bounds__(phn::kPixelsPerBlock, kBlocksPerSm)
    words_kernel(const __grid_constant__ Layers L, int4* __restrict__ words,
                 float* __restrict__ rgba, const __grid_constant__ phn::Decode d,
                 const __grid_constant__ phn::Encode e, int width, int height, int groups,
                 int row0, int nrows, int top_alpha, unsigned long long* branches) {
  extern __shared__ float windows[];  // a layer's two windows, kWindowTexels x 3 planes each
  __shared__ phn::AxisTap row_taps[kTileRows];  // the layer's taps of the tile's rows
  const int x_lo = blockIdx.x * phn::kPixelsPerBlock;
  const int x = x_lo + threadIdx.x;
  const int y_lo = row0 + blockIdx.y * kTileRows;
  const int rows = min(kTileRows, row0 + nrows - y_lo);
  const bool col = x < width;
  float out[kTileRows][3] = {}, cover[kTileRows] = {};
  phn::AxisTap tx{};
  int s = 0;
  for (int m = 0; m < L.n_layers; ++m) {
    const float* mat = L.mat[m];
    const int n = L.n_src[m];
    const int4* a = static_cast<const int4*>(L.src[s]);
    const int4* b = static_cast<const int4*>(L.src[s + n - 1]);
    s += n;
    tx = phn::axis_tap(mat[0], mat[2], x, width);
    // one decision for the whole block, from the tile's geometry
    const phn::Window win = phn::tile_window(mat, x_lo, min(x_lo + phn::kPixelsPerBlock, width) - 1,
                                             y_lo, y_lo + rows - 1, width, height, 6);
    const bool windowed = win.texels() <= kWindowTexels;
    if (branches != nullptr && threadIdx.x == 0)
      atomicAdd(branches + (windowed ? 0 : 1), static_cast<unsigned long long>(n));
    float* win_b = windows + 3 * kWindowTexels;
    __syncthreads();  // the previous layer's windows and row taps are read
    if (threadIdx.x < rows)
      row_taps[threadIdx.x] = phn::axis_tap(mat[4], mat[5], y_lo + threadIdx.x, height);
    if (windowed) {
      phn::decode_window(a, groups, d, win, windows);
      if (n == 2) phn::decode_window(b, groups, d, win, win_b);
    }
    __syncthreads();
    const float mx = n == 2 ? *L.mix[m] : 0.0f;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      if (r >= rows || !col) continue;
      const phn::Taps tp = phn::taps_of(tx, row_taps[r]);
      float v[3];
      if (windowed) {
        phn::sample_window(windows, win, tp, v);
      } else {
        phn::sample_v210(a, groups, d, tp, v);
      }
      if (n == 2) {
        float vb[3];
        if (windowed) {
          phn::sample_window(win_b, win, tp, vb);
        } else {
          phn::sample_v210(b, groups, d, tp, vb);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = v[c] * mx + vb[c] * (1.0f - mx);
      }
      const float al = warp_alpha(tx, row_taps[r]);
      const float k = 1.0f - al;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[r][c] = m == 0 ? v[c] : out[r][c] * k + v[c];
      cover[r] = m == 0 ? al : cover[r] * k + al;
    }
  }
  // tx and the row taps are the top layer's
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (r >= rows) break;
    const int row = y_lo + r;
    if (rgba != nullptr && col) {
      const size_t plane = static_cast<size_t>(width) * nrows;
      const size_t o = static_cast<size_t>(row - row0) * width + x;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgba[c * plane + o] = out[r][c];
      rgba[3 * plane + o] = top_alpha ? warp_alpha(tx, row_taps[r]) : cover[r];
    }
    if (words != nullptr) {
      if (r > 0) __syncthreads();  // the previous row's codes are packed
      phn::encode_pack_block(e, out[r], x, width, row - row0, groups, words);
    }
  }
}

// rgb3 frames (frame_tile_kernel): a block of kPixelsPerBlock x
// kFrameThreadRows threads covers a tile of kFrameRowsPerThread times as
// many rows, each thread the pixels of its column (their x taps shared),
// so the layer loop keeps a few composites in registers and its code
// small.  The block works out every layer's window and row taps once a
// tile, copies a layer's one or two sources into shared memory together
// with cp.async (16 bytes a lane; each warp one source, one plane and
// every other window row) while it samples the layer before, passes one
// barrier a layer, and encodes its rows behind one more.  Shapes that
// measured slower on the H100 (tools/kernel_variants.py, PERF.md): a
// 192-thread block unrolled over 4 rows (its loop, 2,576 instructions
// with the three sampling paths, ten times the row kernel's), a window a
// warp, one block walking a column of tiles, one row a thread, and
// copies two layers ahead.  What is left of its time is the copies' L2
// traffic beside the sampling, the encode, and the layer loop's own work.
constexpr int kFrameThreads = phn::kPixelsPerBlock * kFrameThreadRows;
constexpr int kFrameTileRows = kFrameThreadRows * kFrameRowsPerThread;
constexpr int kLayerFloats = 2 * 3 * kFrameWindowTexels;  // a layer's two windows
constexpr int kFrameSmemBytes = 2 * kLayerFloats * static_cast<int>(sizeof(float));
static_assert(kFrameThreads == 2 * 3 * 2 * 32 && kFrameTileRows * phn::kGroupsPerBlock <= kFrameThreads,
              "frame_tile_kernel gives each warp a source, a plane and a row parity to copy");

// A layer's window in a tile: where its taps land, whether it fits in
// shared memory, whether every tap of the tile lies inside the frame, and
// the window's first texel in a frame plane
struct TileLayer {
  phn::Window win;
  bool windowed, inside;
  size_t first;
  float m00, m02, mix;  // the layer's x scale and offset, and its mix (0 for a cut)
};

// A tile row's taps under one layer, and its offset in the layer's window
struct TileRow {
  phn::AxisTap ty;
  int off;  // (ty.i0 - win.r0) * win.cols
};

// The v210 words of the tile's rows (phn::encode_pack_block for a tile of
// kFrameTileRows rows): each thread encodes its pixels (a pixel past the
// frame width packs as zero) into the code buffers, one barrier, then
// kGroupsPerBlock threads a row write its groups' words.
__device__ __forceinline__ void encode_pack_tile(const phn::Encode& e,
                                                 const float (&rgb)[kFrameRowsPerThread][3], int x,
                                                 int width, int y_lo, int r_lo, int row0,
                                                 int row_end, int groups, int4* __restrict__ words) {
  __shared__ unsigned ys[kFrameTileRows][phn::kPixelsPerBlock];
  __shared__ unsigned cb[kFrameTileRows][phn::kPixelsPerBlock / 2];
  __shared__ unsigned cr[kFrameTileRows][phn::kPixelsPerBlock / 2];
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kFrameRowsPerThread; ++j) {
    unsigned yc = 0, cbc = 0, crc = 0;
    if (x < width && y_lo + r_lo + j < row_end) {
      const float rp = phn::l2g(e.g, rgb[j][0]);
      const float gp = phn::l2g(e.g, rgb[j][1]);
      const float bp = phn::l2g(e.g, rgb[j][2]);
      yc = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
      if ((x & 1) == 0) {
        cbc = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
        crc = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
      }
    }
    ys[r_lo + j][t] = yc;
    if ((t & 1) == 0) {
      cb[r_lo + j][t / 2] = cbc;
      cr[r_lo + j][t / 2] = crc;
    }
  }
  __syncthreads();
  const int tid = threadIdx.y * phn::kPixelsPerBlock + t;
  const int r = tid / phn::kGroupsPerBlock, g = tid - r * phn::kGroupsPerBlock;
  const int gi = blockIdx.x * phn::kGroupsPerBlock + g;
  if (r >= kFrameTileRows || gi >= groups || y_lo + r >= row_end) return;
  words[static_cast<size_t>(y_lo + r - row0) * groups + gi] =
      phn::v210_group(ys[r] + 6 * g, cb[r] + 3 * g, cr[r] + 3 * g);
}

// One plane at taps that all lie in the window, s at the (x0, y0) texel:
// bilerp's expressions without its selects
__device__ __forceinline__ float lerp_inside(const float* __restrict__ s, int cols, float fx,
                                             float fy) {
  const float c0 = s[0] * (1.0f - fy) + s[cols] * fy;
  const float c1 = s[1] * (1.0f - fy) + s[cols + 1] * fy;
  return c0 * (1.0f - fx) + c1 * fx;
}

// rgb3 frames: see above.  A layer's windows are sampled when they fit,
// without bilerp's selects when every tap of the tile lies inside the
// frame; a tile whose window does not fit samples straight from the
// frames.  branches (may be null): window[0] and direct[1] counts, one per
// tile and source.
__global__ void __launch_bounds__(kFrameThreads, kFrameBlocksPerSm)
    frame_tile_kernel(const __grid_constant__ Layers L, int4* __restrict__ words,
                      float* __restrict__ rgba, const __grid_constant__ phn::Encode e, int width,
                      int height, int groups, int row0, int nrows, int top_alpha,
                      unsigned long long* branches) {
  extern __shared__ __align__(16) float windows[];  // two layers' windows
  __shared__ TileLayer layers[kMaxLayers];
  __shared__ TileRow tile_rows[kMaxLayers][kFrameTileRows];
  const int tid = threadIdx.y * phn::kPixelsPerBlock + threadIdx.x;
  const int x_lo = blockIdx.x * phn::kPixelsPerBlock, x = x_lo + threadIdx.x;
  const int row_end = row0 + nrows;
  const int y_lo = row0 + blockIdx.y * kFrameTileRows;
  const int r_lo = threadIdx.y * kFrameRowsPerThread;  // this thread's first row in the tile
  const int x_hi = min(x_lo + phn::kPixelsPerBlock, width) - 1;
  const int y_hi = min(y_lo + kFrameTileRows, row_end) - 1;
  // every layer's window and row offsets, once for the block
  if (tid < L.n_layers) {
    const float* mat = L.mat[tid];
    TileLayer t;
    t.win = phn::tile_window(mat, x_lo, x_hi, y_lo, y_hi, width, height, 4);
    t.windowed = t.win.texels() <= kFrameWindowTexels;
    t.inside = phn::span_inside(mat[0], mat[2], x_lo, x_hi, width) &&
               phn::span_inside(mat[4], mat[5], y_lo, y_hi, height);
    t.first = static_cast<size_t>(t.win.r0) * width + t.win.c0;
    t.m00 = mat[0];
    t.m02 = mat[2];
    t.mix = L.n_src[tid] == 2 ? *L.mix[tid] : 0.0f;
    layers[tid] = t;
    if (branches != nullptr)
      atomicAdd(branches + (t.windowed ? 0 : 1), static_cast<unsigned long long>(L.n_src[tid]));
  }
  __syncthreads();
  if (tid < L.n_layers * kFrameTileRows) {
    const int m = tid / kFrameTileRows, r = tid - m * kFrameTileRows;
    TileRow tr;
    tr.ty = phn::axis_tap(L.mat[m][4], L.mat[m][5], y_lo + r, height);
    tr.off = (tr.ty.i0 - layers[m].win.r0) * layers[m].win.cols;
    tile_rows[m][r] = tr;
  }
  // this warp's share of every copy: a source, a plane, every other row,
  // 16 bytes a lane from column 4 * lane (a frame whose rows are not
  // 16-byte aligned is copied a texel a lane)
  const int warp = tid >> 5, lane4 = 4 * (tid & 31);
  const int copy_src = warp / 6, copy_c = (warp >> 1) % 3, copy_r = warp & 1;
  const size_t row_step = 2 * static_cast<size_t>(width);
  const auto copy = [&](int m, int s, float* buf) {
    const TileLayer t = layers[m];
    if (t.windowed && copy_src < L.n_src[m]) {
      const float* src = static_cast<const float*>(L.src[s + copy_src]);
      const size_t plane = L.plane[s + copy_src];
      const float* g = src + copy_c * plane + t.first + copy_r * static_cast<size_t>(width);
      float* d = buf + copy_src * 3 * kFrameWindowTexels + copy_c * t.win.texels() + copy_r * t.win.cols;
      if ((width & 3) == 0 && (plane & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int chunks = (t.win.cols - lane4 + 127) >> 7;  // this lane's 16-byte chunks a row
        g += lane4;
        d += lane4;
#pragma unroll 1
        for (int r = copy_r; r < t.win.rows; r += 2, g += row_step, d += 2 * t.win.cols) {
#pragma unroll 1
          for (int k = 0; k < chunks; ++k) phn::cp_async16(d + 128 * k, g + 128 * k);
        }
      } else {
        for (int r = copy_r; r < t.win.rows; r += 2, g += row_step, d += 2 * t.win.cols) {
          for (int k = lane4 / 4; k < t.win.cols && t.win.c0 + k < width; k += 32) phn::cp_async4(d + k, g + k);
        }
      }
    }
    phn::cp_async_commit();
  };
  copy(0, 0, windows);
  float out[kFrameRowsPerThread][3] = {}, cover[kFrameRowsPerThread] = {};
  phn::AxisTap tx{};
  int s = 0;
  for (int m = 0; m < L.n_layers; ++m) {
    const int n = L.n_src[m];
    phn::cp_async_wait<0>();
    // layer m's windows are in, and every thread is done with layer m - 1's
    __syncthreads();
    if (m + 1 < L.n_layers) {
      copy(m + 1, s + n, windows + ((m + 1) & 1) * kLayerFloats);
    }
    const TileLayer t = layers[m];
    tx = phn::axis_tap(t.m00, t.m02, x, width);
    const float* win_a = windows + (m & 1) * kLayerFloats;
    const float* win_b = win_a + 3 * kFrameWindowTexels;
    const float mx = t.mix;
#pragma unroll
    for (int j = 0; j < kFrameRowsPerThread; ++j) {
      if (x >= width || y_lo + r_lo + j >= row_end) continue;
      const TileRow tr = tile_rows[m][r_lo + j];
      const phn::Taps tp = phn::taps_of(tx, tr.ty);
      float v[3], vb[3];
      if (t.inside && t.windowed) {
        const int o = tr.off + tx.i0 - t.win.c0, plane = t.win.texels(), cols = t.win.cols;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = lerp_inside(win_a + c * plane + o, cols, tx.f, tr.ty.f);
        if (n == 2) {
#pragma unroll
          for (int c = 0; c < 3; ++c) vb[c] = lerp_inside(win_b + c * plane + o, cols, tx.f, tr.ty.f);
        }
      } else if (t.windowed) {
        phn::sample_window(win_a, t.win, tp, v);
        if (n == 2) phn::sample_window(win_b, t.win, tp, vb);
      } else {
        float v4[4];
        sample_planes<kRgb3>(L.src[s], L.plane[s], tp, width, v4);
        for (int c = 0; c < 3; ++c) v[c] = v4[c];
        if (n == 2) {
          sample_planes<kRgb3>(L.src[s + 1], L.plane[s + 1], tp, width, v4);
          for (int c = 0; c < 3; ++c) vb[c] = v4[c];
        }
      }
      if (n == 2) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = v[c] * mx + vb[c] * (1.0f - mx);
      }
      const float al = warp_alpha(tx, tr.ty);
      const float k = 1.0f - al;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[j][c] = m == 0 ? v[c] : out[j][c] * k + v[c];
      cover[j] = m == 0 ? al : cover[j] * k + al;
    }
    s += n;
  }
  // tx and the row taps are the top layer's
#pragma unroll
  for (int j = 0; j < kFrameRowsPerThread; ++j) {
    const int row = y_lo + r_lo + j;
    if (rgba != nullptr && x < width && row < row_end) {
      const size_t plane = static_cast<size_t>(width) * nrows;
      const size_t o = static_cast<size_t>(row - row0) * width + x;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgba[c * plane + o] = out[j][c];
      rgba[3 * plane + o] = top_alpha ? warp_alpha(tx, tile_rows[L.n_layers - 1][r_lo + j].ty) : cover[j];
    }
  }
  if (words != nullptr) encode_pack_tile(e, out, x, width, y_lo, r_lo, row0, row_end, groups, words);
}

}  // namespace

// srcs: n_srcs sources, bottom..top: (3, height, width) float32 frames
// (kind 0, rgb3), (height, groups*4) int32 v210 words (kind 1, packed) or
// (4, height, width) float32 RGBA frames (kind 2, rgba), each a window of
// frame rows from src_row0s[s] on (rows `width` floats or `groups` int4
// apart; a frame's channel planes src_planes[s] floats apart); mats:
// n_layers (3, 3) float32; mixes: n_layers pointers to one float32 (null
// for a cut); n_src: n_layers entries of 1 or 2 summing to n_srcs.
// Outputs, at least one, frame rows row0 .. row0 + rows - 1: words (rows,
// groups*4) int32 (emit 'packed'), rgba (4, rows, width) float32 (emit
// 'rgba'); both for emit 'both'.  A full-frame launch: row0 0, rows
// height, every src_row0 0.
// top_alpha: the frame's alpha is the top layer's (1) or the run's
// coverage (0).  dec_coeffs: col[12], gamut[9] and g2l, the gamma'->linear
// table in device memory (read for kind 1 only); enc_coeffs: col[12],
// l2g[6].  branches: null, or two uint64 in device memory to which kind 1
// adds the (tile, source) pairs sampled from a shared-memory window [0]
// and straight from the words [1].  Returns the first CUDA error.
extern "C" int phn_packed_composite(const void* const* srcs, const void* const* mats,
                                    const void* const* mixes, const int* n_src, int n_layers,
                                    int kind, void* words, void* rgba, int width, int height,
                                    int groups, int row0, int rows, const int* src_row0s,
                                    const long long* src_planes, const float* dec_coeffs,
                                    const float* g2l, const float* enc_coeffs, int top_alpha,
                                    void* branches, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  if (kind != kRgb3 && kind != kPacked && kind != kRgba)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kPacked && (dec_coeffs == nullptr || g2l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (words == nullptr && rgba == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!phn::band_ok(height, row0, rows, 0, height) || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers L{};
  L.n_layers = n_layers;
  int s = 0;
  for (int m = 0; m < n_layers; ++m) {
    if (n_src[m] != 1 && n_src[m] != 2) return static_cast<int>(cudaErrorInvalidValue);
    if (n_src[m] == 2 && mixes[m] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    L.n_src[m] = n_src[m];
    L.mat[m] = static_cast<const float*>(mats[m]);
    L.mix[m] = static_cast<const float*>(mixes[m]);
    for (int r = 0; r < n_src[m]; ++r, ++s) {
      if (src_row0s[s] < 0 || src_row0s[s] >= height) return static_cast<int>(cudaErrorInvalidValue);
      // each source's window addressed by frame row
      if (kind == kPacked) {
        L.src[s] = phn::frame_row0(static_cast<const int4*>(srcs[s]), src_row0s[s], groups);
      } else {
        L.src[s] = phn::frame_row0(static_cast<const float*>(srcs[s]), src_row0s[s], width);
        L.plane[s] = static_cast<size_t>(src_planes[s]);
      }
    }
  }
  const phn::Encode e = phn::encode_from(enc_coeffs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* w = static_cast<int4*>(words);
  float* f = static_cast<float*>(rgba);
  const dim3 block(phn::kPixelsPerBlock);
  const int blocks_x = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock;
  if (kind == kPacked) {
    words_kernel<<<dim3(blocks_x, (rows + kTileRows - 1) / kTileRows), block, kSmemBytes, st>>>(
        L, w, f, phn::decode_from(dec_coeffs, g2l), e, width, height, groups, row0, rows, top_alpha,
        static_cast<unsigned long long*>(branches));
  } else if (kind == kRgba) {
    bool band = row0 != 0 || rows != height;
    for (int k = 0; k < s; ++k) band = band || src_row0s[k] != 0 || src_planes[k] != static_cast<long long>(width) * height;
    if (band) {
      frames_kernel<kRgba, true><<<dim3(blocks_x, rows), block, 0, st>>>(L, w, f, e, width, height, groups,
                                                                       row0, rows, top_alpha);
    } else {
      frames_kernel<kRgba, false><<<dim3(blocks_x, rows), block, 0, st>>>(L, w, f, e, width, height, groups,
                                                                        row0, rows, top_alpha);
    }
  } else {
    const cudaError_t attr = cudaFuncSetAttribute(
        frame_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFrameSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    frame_tile_kernel<<<dim3(blocks_x, (rows + kFrameTileRows - 1) / kFrameTileRows),
                        dim3(phn::kPixelsPerBlock, kFrameThreadRows), kFrameSmemBytes, st>>>(
        L, w, f, e, width, height, groups, row0, rows, top_alpha,
        static_cast<unsigned long long*>(branches));
  }
  return static_cast<int>(cudaGetLastError());
}
