// The v210 packs' suspects told apart (tools/kernel_variants.py v210packs):
// K2 (v210_pack) and B5 (combine_pack) in their first design, and the
// mappings measured for their redesign around one encoder.
//   v210_old: the kernels before the redesign, verbatim (K2's
//     v210_pack_kernel: one thread a 6-pixel group, 128-thread blocks, a
//     row a grid row, a loop over its pixels that breaks at the frame
//     width; B5's combine_pack_kernel: a 192-thread block a row segment, a
//     thread a pixel, phn::encode_pack_block), three full-precision powf a
//     pixel.  part 0: whole; 1: stores only (constant codes, no loads);
//     2: no powf (the linear segment fi * delta for every index); 3: loads
//     with trivial arithmetic (the codes from the bits of the loaded, for
//     B5 composited, values).
//   v210_mapping: the other designs, linear->gamma' by two MUFU operations
//     and the l2g correction bytes in shared memory (phn::CorrectedL2G),
//     persistent blocks that copy the 64 KB once:
//     0 (a) the first B5 mapping kept: 192 threads a row segment, a thread
//       a pixel (one load a pixel and plane), codes exchanged in shared
//       memory behind a 192-thread named barrier (two buffers), one warp
//       assembling and storing the segment's 32 groups with 16-byte
//       stores; kBlockParts segments a 960-thread block;
//     1 a warp a segment, its loads in registers: a lane three pixel pairs
//       of every layer (one 8-byte load a plane where every frame and wx is
//       8-byte aligned and the width even; a layer's loads all issued
//       before its arithmetic), their codes exchanged through the warp's
//       shared memory, lane g assembling and storing group g; 32 warps a
//       block;
//     2 variant 1 asking L2 for the planes of the warp's next segment
//       (cp.async.bulk.prefetch) before each segment;
//     3 (b) staged as the built kernel (phn::v210_segments) but every
//       layer in one stage, so fewer warps a block as layers are added.
// Layers as phn_combine_pack takes them (K2: one layer, its frame).
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

// ---- the first design, verbatim but for kPart
template <int kPart>
__device__ __forceinline__ float old_l2g(const phn::L2G& g, float x) {
  if (kPart == 2) return static_cast<float>(phn::u16_sat_rte(x * 65535.0f)) * g.inv_max * g.delta;
  return phn::l2g(g, x);
}

template <int kPart>
__global__ void old_v210_pack_kernel(const float* __restrict__ rgb, int4* __restrict__ words,
                                     phn::Encode e, int width, int height, int groups) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (gi >= groups) return;

  const size_t plane = static_cast<size_t>(width) * height;
  const float* in = rgb + static_cast<size_t>(row) * width;
  unsigned ys[6] = {0, 0, 0, 0, 0, 0};
  unsigned cb[3] = {0, 0, 0};
  unsigned cr[3] = {0, 0, 0};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int x = gi * 6 + p;
    if (x >= width) break;
    if (kPart == 1) {
      ys[p] = 64u + p;
      if ((p & 1) == 0) {
        cb[p / 2] = 512u;
        cr[p / 2] = 384u + p;
      }
      continue;
    }
    if (kPart == 3) {
      const unsigned bits = __float_as_uint(in[x]) ^ __float_as_uint(in[plane + x]) ^
                            __float_as_uint(in[2 * plane + x]);
      ys[p] = bits & phn::kField;
      if ((p & 1) == 0) {
        cb[p / 2] = (bits >> 10) & phn::kField;
        cr[p / 2] = (bits >> 20) & phn::kField;
      }
      continue;
    }
    const float rp = old_l2g<kPart>(e.g, in[x]);
    const float gp = old_l2g<kPart>(e.g, in[plane + x]);
    const float bp = old_l2g<kPart>(e.g, in[2 * plane + x]);
    ys[p] = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
    if ((p & 1) == 0) {
      cb[p / 2] = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
      cr[p / 2] = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
    }
  }
  words[static_cast<size_t>(row) * groups + gi] = phn::v210_group(ys, cb, cr);
}

// phn::encode_pack_block (the first B5's block encode) with kPart's change
template <int kPart>
__device__ __forceinline__ void old_encode_pack_block(const phn::Encode& e, const float rgb[3], int x, int width,
                                                      int row, int groups, int4* __restrict__ words) {
  if (kPart == 0) {
    phn::encode_pack_block(e, rgb, x, width, row, groups, words);
    return;
  }
  __shared__ unsigned ys[phn::kPixelsPerBlock];
  __shared__ unsigned cb[phn::kPixelsPerBlock / 2];
  __shared__ unsigned cr[phn::kPixelsPerBlock / 2];
  const int t = threadIdx.x;
  unsigned yc = 0, cbc = 0, crc = 0;
  if (x < width) {
    if (kPart == 1) {
      yc = 64u + (x & 7);
      cbc = 512u;
      crc = 384u;
    } else if (kPart == 3) {
      const unsigned bits = __float_as_uint(rgb[0]) ^ __float_as_uint(rgb[1]) ^ __float_as_uint(rgb[2]);
      yc = bits & phn::kField;
      cbc = (bits >> 10) & phn::kField;
      crc = (bits >> 20) & phn::kField;
    } else {
      const float rp = old_l2g<kPart>(e.g, rgb[0]);
      const float gp = old_l2g<kPart>(e.g, rgb[1]);
      const float bp = old_l2g<kPart>(e.g, rgb[2]);
      yc = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & phn::kField;
      if ((x & 1) == 0) {
        cbc = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & phn::kField;
        crc = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & phn::kField;
      }
    }
  }
  ys[t] = yc;
  if ((t & 1) == 0) {
    cb[t / 2] = cbc;
    cr[t / 2] = crc;
  }
  __syncthreads();
  const int gi = blockIdx.x * phn::kGroupsPerBlock + t;
  if (t >= phn::kGroupsPerBlock || gi >= groups) return;
  words[static_cast<size_t>(row) * groups + gi] = phn::v210_group(ys + 6 * t, cb + 3 * t, cr + 3 * t);
}

template <int kPart>
__global__ void old_combine_pack_kernel(phn::Layers L, int4* __restrict__ words, phn::Encode e, int width,
                                        int height, int groups) {
  const int row = blockIdx.y;
  const int x = blockIdx.x * phn::kPixelsPerBlock + threadIdx.x;
  float out[3] = {0.0f, 0.0f, 0.0f};
  if (x < width && kPart != 1) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t o = static_cast<size_t>(row) * width + x;
    for (int m = 0; m < L.n_layers; ++m) {
      const float* f = L.frame[m];
      if (m == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[c] = f[c * plane + o];
        continue;
      }
      const float a = L.wy[m] != nullptr ? L.wy[m][row] * L.wx[m][x] : f[3 * plane + o];
      const float k = 1.0f - a;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = out[c] * k + f[c * plane + o];
    }
  }
  old_encode_pack_block<kPart>(e, out, x, width, row, groups, words);
}

template <int kPart>
int launch_old(int kernel, const phn::Layers& L, void* words, int width, int height, int groups,
               const phn::Encode& e, cudaStream_t st) {
  if (kernel == 0) {
    const dim3 block(128);
    const dim3 grid((groups + block.x - 1) / block.x, height);
    old_v210_pack_kernel<kPart><<<grid, block, 0, st>>>(L.frame[0], static_cast<int4*>(words), e, width, height,
                                                        groups);
  } else {
    const dim3 grid((groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock, height);
    old_combine_pack_kernel<kPart><<<grid, phn::kPixelsPerBlock, 0, st>>>(L, static_cast<int4*>(words), e, width,
                                                                           height, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- (a): 192 threads a segment, a thread a pixel
constexpr int kBlockParts = 5;
constexpr int kBlockThreads = kBlockParts * phn::kPixelsPerBlock;
constexpr int kBlockSmemBytes = phn::kTable + kBlockParts * 2 * 384 * 4;  // corrections, two code buffers a part

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    block_kernel(const __grid_constant__ phn::Layers L, const __grid_constant__ phn::Encode e,
                 const int4* __restrict__ corr, int4* __restrict__ words, int width, int height, int groups) {
  extern __shared__ int4 smem[];
  phn::copy_corrections(smem, corr, threadIdx.x, kBlockThreads);
  const phn::CorrectedL2G l2g_of{e.g, reinterpret_cast<const signed char*>(smem)};
  const int part = threadIdx.x / phn::kPixelsPerBlock, t = threadIdx.x % phn::kPixelsPerBlock;
  unsigned* bufs = reinterpret_cast<unsigned*>(smem + phn::kTable / 16) + part * 2 * 384;
  const int segs_x = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock;
  const int n_segs = segs_x * height;
  const size_t plane = static_cast<size_t>(width) * height;
  phn::cp_async_wait<0>();
  __syncthreads();
  int k = 0;
  for (int s = blockIdx.x * kBlockParts + part; s < n_segs; s += gridDim.x * kBlockParts, ++k) {
    const int row = s / segs_x, sx = s - row * segs_x;
    const int x = sx * phn::kPixelsPerBlock + t;
    unsigned yc = 0, cbc = 0, crc = 0;
    if (x < width) {
      float out[3];
      const size_t o = static_cast<size_t>(row) * width + x;
      for (int m = 0; m < L.n_layers; ++m) {
        const float* f = L.frame[m];
        if (m == 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) out[c] = __ldg(f + c * plane + o);
          continue;
        }
        const float a = L.wy[m] != nullptr ? __ldg(L.wy[m] + row) * __ldg(L.wx[m] + x) : __ldg(f + 3 * plane + o);
        const float kk = 1.0f - a;
#pragma unroll
        for (int c = 0; c < 3; ++c) out[c] = out[c] * kk + __ldg(f + c * plane + o);
      }
      const float rp = l2g_of(out[0]), gp = l2g_of(out[1]), bp = l2g_of(out[2]);
      yc = phn::quad_code(e, 0, rp, gp, bp, phn::kField);
      if ((x & 1) == 0) {
        cbc = phn::quad_code(e, 1, rp, gp, bp, phn::kField);
        crc = phn::quad_code(e, 2, rp, gp, bp, phn::kField);
      }
    }
    unsigned* b = bufs + (k & 1) * 384;  // ys[192], cb[96], cr[96]
    b[t] = yc;
    if ((t & 1) == 0) {
      b[192 + t / 2] = cbc;
      b[288 + t / 2] = crc;
    }
    named_barrier(1 + part, phn::kPixelsPerBlock);
    const int gi = sx * phn::kGroupsPerBlock + t;
    if (t < phn::kGroupsPerBlock && gi < groups)
      words[static_cast<size_t>(row) * groups + gi] = phn::v210_group(b + 6 * t, b + 192 + 3 * t, b + 288 + 3 * t);
  }
}

// ---- (b): a thread a group, each warp's segment staged with cp.async
constexpr int kStages = 2;

__device__ __forceinline__ int staged_planes(const phn::Layers& L) { return 3 + 4 * (L.n_layers - 1); }

template <bool kVec>
__global__ void __launch_bounds__(1024, 1)
    staged_kernel(const __grid_constant__ phn::Layers L, const __grid_constant__ phn::Encode e,
                  const int4* __restrict__ corr, int4* __restrict__ words, int width, int height, int groups) {
  extern __shared__ int4 smem[];
  constexpr int kSeg = phn::kPixelsPerBlock;
  phn::copy_corrections(smem, corr, threadIdx.x, blockDim.x);
  const phn::CorrectedL2G l2g_of{e.g, reinterpret_cast<const signed char*>(smem)};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_planes = staged_planes(L);
  float* mine = reinterpret_cast<float*>(smem + phn::kTable / 16) + warp * kStages * n_planes * kSeg;
  const int segs_x = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock;
  const int n_segs = segs_x * height;
  const size_t plane = static_cast<size_t>(width) * height;
  const int stride = gridDim.x * warps;
  const auto stage = [&](int s, int buf) {
    if (s < n_segs) {
      const int row = s / segs_x, x0 = (s - row * segs_x) * kSeg;
      float* dst = mine + buf * n_planes * kSeg;
      for (int m = 0; m < L.n_layers; ++m) {
        for (int c = 0; c < (m == 0 ? 3 : 4); ++c, dst += kSeg) {
          const float* src = c == 3 && L.wx[m] != nullptr ? L.wx[m] + x0
                                                           : L.frame[m] + c * plane + static_cast<size_t>(row) * width + x0;
          if constexpr (kVec) {
            for (int i = lane; i < kSeg / 4; i += 32)
              if (x0 + 4 * i < width) phn::cp_async16(dst + 4 * i, src + 4 * i);
          } else {
            for (int i = lane; i < kSeg; i += 32)
              if (x0 + i < width) phn::cp_async4(dst + i, src + i);
          }
        }
      }
    }
    phn::cp_async_commit();
  };
  const int first = blockIdx.x * warps + warp;
  stage(first, 0);
  phn::cp_async_wait<1>();
  __syncthreads();  // the corrections
  int buf = 0;
  for (int s = first; s < n_segs; s += stride, buf ^= 1) {
    stage(s + stride, buf ^ 1);
    phn::cp_async_wait<1>();
    __syncwarp();
    const int row = s / segs_x, x0 = (s - row * segs_x) * kSeg;
    const float* st = mine + buf * n_planes * kSeg + 6 * lane;
    float rgb[3][6];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(st + c * kSeg + 2 * q);
        rgb[c][2 * q] = v.x;
        rgb[c][2 * q + 1] = v.y;
      }
    st += 3 * kSeg;
    for (int m = 1; m < L.n_layers; ++m, st += 4 * kSeg) {
      const float wy = L.wy[m] != nullptr ? __ldg(L.wy[m] + row) : 0.0f;
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        const float a = L.wy[m] != nullptr ? wy * st[3 * kSeg + p] : st[3 * kSeg + p];
        const float k = 1.0f - a;
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c][p] = rgb[c][p] * k + st[c * kSeg + p];
      }
    }
    unsigned ys[6] = {0, 0, 0, 0, 0, 0}, cb[3] = {0, 0, 0}, cr[3] = {0, 0, 0};
    const int xg = x0 + 6 * lane;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (xg + p >= width) break;
      const float rp = l2g_of(rgb[0][p]), gp = l2g_of(rgb[1][p]), bp = l2g_of(rgb[2][p]);
      ys[p] = phn::quad_code(e, 0, rp, gp, bp, phn::kField);
      if ((p & 1) == 0) {
        cb[p / 2] = phn::quad_code(e, 1, rp, gp, bp, phn::kField);
        cr[p / 2] = phn::quad_code(e, 2, rp, gp, bp, phn::kField);
      }
    }
    const int g = x0 / 6 + lane;
    if (g < groups) words[static_cast<size_t>(row) * groups + g] = phn::v210_group(ys, cb, cr);
    __syncwarp();
  }
}

// ---- variants 1 and 2: a warp a segment, a lane three pixel pairs, loads in registers
constexpr int kSegWarps = 32;
constexpr int kSegThreads = 32 * kSegWarps;
constexpr int kSegPairs = phn::kPixelsPerBlock / 2;  // pixel pairs a segment: 3 a lane
constexpr int kSegSmemBytes = phn::kTable + kSegWarps * 2 * kSegPairs * 4;  // corrections, then each warp's codes

// Asks L2 for the 16-byte units wholly inside [first, first + n floats)
__device__ __forceinline__ void prefetch_l2(const float* first, int n) {
  const uintptr_t a = (reinterpret_cast<uintptr_t>(first) + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t b = (reinterpret_cast<uintptr_t>(first) + 4 * static_cast<uintptr_t>(n)) & ~static_cast<uintptr_t>(15);
  if (b > a) asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a), "r"(static_cast<unsigned>(b - a)) : "memory");
}

// The planes a segment (row, pixels x0 on) reads, lane q asking for
// plane q: layer 0's R, G and B, then each layer's R, G, B and alpha (or
// wx)
__device__ __forceinline__ void prefetch_segment(const phn::Layers& L, size_t plane, int width, int row, int x0, int lane) {
  const int n = width - x0 < phn::kPixelsPerBlock ? width - x0 : phn::kPixelsPerBlock;
  if (lane >= 3 + 4 * (L.n_layers - 1)) return;
  const int m = lane < 3 ? 0 : 1 + (lane - 3) / 4, c = lane < 3 ? lane : (lane - 3) % 4;
  const float* p = c == 3 && L.wx[m] != nullptr ? L.wx[m] + x0 : L.frame[m] + c * plane + static_cast<size_t>(row) * width + x0;
  prefetch_l2(p, n);
}

// Pixels x and x + 1 of a row of one plane (p: pixel x's address; n: the
// pixels of the row from x on): with kVec one 8-byte load (p 8-byte
// aligned, a pair inside the frame whole or not at all), else one load a
// pixel inside the frame; 0 outside it
template <bool kVec>
__device__ __forceinline__ float2 load_pair(const float* __restrict__ p, int n) {
  if constexpr (kVec) {
    return n > 0 ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.0f, 0.0f);
  } else {
    return make_float2(n > 0 ? __ldg(p) : 0.0f, n > 1 ? __ldg(p + 1) : 0.0f);
  }
}

// The linear RGB of three pairs of a row (pair k at pixel x[k], n[k]
// pixels of the row from there) composited over black from every layer,
// in the order of ops/composite.py combine_rgb
template <bool kVec>
__device__ __forceinline__ void composite_pairs(const phn::Layers& L, size_t plane, size_t row_at, int row,
                                                const int (&x)[3], const int (&n)[3], float (&out)[3][3][2]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 v = load_pair<kVec>(L.frame[0] + c * plane + row_at + x[k], n[k]);
      out[k][c][0] = v.x;
      out[k][c][1] = v.y;
    }
  }
  for (int m = 1; m < L.n_layers; ++m) {
    const float* f = L.frame[m] + row_at;
    const bool separable = L.wx[m] != nullptr;
    const float* alpha = separable ? L.wx[m] : f + 3 * plane;  // indexed by x either way
    const float wy = separable ? __ldg(L.wy[m] + row) : 0.0f;
    float2 a[3], v[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k] = load_pair<kVec>(alpha + x[k], n[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[k][c] = load_pair<kVec>(f + c * plane + x[k], n[k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float k0 = 1.0f - (separable ? wy * a[k].x : a[k].x);
      const float k1 = 1.0f - (separable ? wy * a[k].y : a[k].y);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        out[k][c][0] = out[k][c][0] * k0 + v[k][c].x;
        out[k][c][1] = out[k][c][1] * k1 + v[k][c].y;
      }
    }
  }
}

// The v210 codes of a pixel pair from its linear RGB (rgb[c][p]), n of
// its pixels inside the frame: (luma 0 | luma 1 << 16, Cb | Cr << 16) of
// the even pixel, each masked to 10 bits; a pixel outside codes 0
template <class L2GFn>
__device__ __forceinline__ uint2 pair_codes(const phn::Encode& e, const L2GFn& l2g_of, const float (&rgb)[3][2], int n) {
  unsigned y[2] = {0u, 0u}, chroma = 0u;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= n) break;
    const float rp = l2g_of(rgb[0][p]);
    const float gp = l2g_of(rgb[1][p]);
    const float bp = l2g_of(rgb[2][p]);
    y[p] = phn::quad_code(e, 0, rp, gp, bp, phn::kField);
    if (p == 0) chroma = phn::quad_code(e, 1, rp, gp, bp, phn::kField) | (phn::quad_code(e, 2, rp, gp, bp, phn::kField) << 16);
  }
  return make_uint2(y[0] | (y[1] << 16), chroma);
}

// The words of the group of three pairs' codes (luma and chroma as
// pair_codes gives them)
__device__ __forceinline__ int4 group_of_pairs(const unsigned* ys, const unsigned* cs) {
  unsigned y[6], cb[3], cr[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    y[2 * q] = ys[q] & 0xFFFFu;
    y[2 * q + 1] = ys[q] >> 16;
    cb[q] = cs[q] & 0xFFFFu;
    cr[q] = cs[q] >> 16;
  }
  return phn::v210_group(y, cb, cr);
}

// Variants 1 and 2 (a block of kSegThreads threads,
// kSegSmemBytes of dynamic shared memory): every group of the pitch of
// every row of the layers' (height, width) frames, composited, encoded and
// stored to words (height, groups); fields past the frame width pack as 0
template <bool kVec, bool kPrefetch>
__device__ __forceinline__ void pair_segments(const phn::Layers& L, const phn::Encode& e, const int4* __restrict__ corr,
                                              int4* __restrict__ words, int width, int height, int groups) {
  extern __shared__ int4 smem[];
  phn::copy_corrections(smem, corr, threadIdx.x, kSegThreads);
  const phn::CorrectedL2G l2g_of{e.g, reinterpret_cast<const signed char*>(smem)};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* ys = reinterpret_cast<unsigned*>(smem + phn::kTable / 16) + warp * 2 * kSegPairs;
  unsigned* cs = ys + kSegPairs;
  const int segs_x = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock;
  const int n_segs = segs_x * height, stride = gridDim.x * kSegWarps;
  const size_t plane = static_cast<size_t>(width) * height;
  const auto prefetch = [&](int s) {
    if (s < n_segs) prefetch_segment(L, plane, width, s / segs_x, s % segs_x * phn::kPixelsPerBlock, lane);
  };
  if (kPrefetch) prefetch(blockIdx.x * kSegWarps + warp);
  phn::cp_async_wait<0>();
  __syncthreads();
  for (int s = blockIdx.x * kSegWarps + warp; s < n_segs; s += stride) {
    if (kPrefetch) prefetch(s + stride);
    const int row = s / segs_x, x0 = (s - row * segs_x) * phn::kPixelsPerBlock;
    int x[3], n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = x0 + 2 * (lane + 32 * k);
      n[k] = width - x[k];
    }
    float rgb[3][3][2];
    composite_pairs<kVec>(L, plane, static_cast<size_t>(row) * width, row, x, n, rgb);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint2 c = n[k] > 0 ? pair_codes(e, l2g_of, rgb[k], n[k]) : make_uint2(0u, 0u);
      ys[lane + 32 * k] = c.x;
      cs[lane + 32 * k] = c.y;
    }
    __syncwarp();
    const int g = x0 / 6 + lane;
    if (g < groups) words[static_cast<size_t>(row) * groups + g] = group_of_pairs(ys + 3 * lane, cs + 3 * lane);
    __syncwarp();
  }
}

template <bool kVec, bool kPrefetch>
__global__ void __launch_bounds__(kSegThreads, 1)
    pairs_kernel(const __grid_constant__ phn::Layers L, const __grid_constant__ phn::Encode e,
                 const int4* __restrict__ corr, int4* __restrict__ words, int width, int height, int groups) {
  pair_segments<kVec, kPrefetch>(L, e, corr, words, width, height, groups);
}

bool pairs_aligned(const phn::Layers& L, int width) {
  const auto at8 = [](const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  bool ok = width % 2 == 0;
  for (int m = 0; m < L.n_layers; ++m) ok = ok && at8(L.frame[m]) && at8(L.wx[m]);
  return ok;
}

template <typename Kernel>
int launch_persistent(Kernel kernel, int threads, int smem, const phn::Layers& L, const phn::Encode& e,
                      const void* corr, void* words, int width, int height, int groups, cudaStream_t st) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int units = (groups + phn::kGroupsPerBlock - 1) / phn::kGroupsPerBlock * height;
  const int per_block = threads == kBlockThreads ? kBlockParts : threads / 32;
  const int blocks = (units + per_block - 1) / per_block;
  const int grid = blocks < sms * per_sm ? blocks : sms * per_sm;
  kernel<<<grid, threads, smem, st>>>(
      L, e, static_cast<const int4*>(corr), static_cast<int4*>(words), width, height, groups);
  return static_cast<int>(cudaGetLastError());
}

bool layers_of(const void* const* frames, const int* channels, const void* const* wys, const void* const* wxs,
               int n_layers, phn::Layers& L) {
  if (n_layers < 1 || n_layers > phn::kMaxLayers) return false;
  L = phn::Layers{};
  L.n_layers = n_layers;
  for (int m = 0; m < n_layers; ++m) {
    const bool rgb3 = channels[m] == 3 && m > 0;
    L.frame[m] = static_cast<const float*>(frames[m]);
    L.wy[m] = rgb3 ? static_cast<const float*>(wys[m]) : nullptr;
    L.wx[m] = rgb3 ? static_cast<const float*>(wxs[m]) : nullptr;
  }
  return true;
}

const char* const kNames[] = {"(a) 192 threads a segment, a thread a pixel", "a lane three pixel pairs, loads in registers",
                              "a lane three pixel pairs, next segment prefetched into L2",
                              "(b) staged, every layer in one stage"};

}  // namespace

// kernel 0: K2 (frames[0] only), 1: B5.  Arguments as phn_combine_pack's
// (a 3-channel layer 0 needs no alpha vectors).
extern "C" int v210_old(int kernel, int part, const void* const* frames, const int* channels,
                        const void* const* wys, const void* const* wxs, int n_layers, void* words, int width,
                        int height, int groups, const float* coeffs, void* stream) {
  phn::Layers L;
  if (!layers_of(frames, channels, wys, wxs, n_layers, L)) return static_cast<int>(cudaErrorInvalidValue);
  const phn::Encode e = phn::encode_from(coeffs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (part) {
    case 0: return launch_old<0>(kernel, L, words, width, height, groups, e, st);
    case 1: return launch_old<1>(kernel, L, words, width, height, groups, e, st);
    case 2: return launch_old<2>(kernel, L, words, width, height, groups, e, st);
    case 3: return launch_old<3>(kernel, L, words, width, height, groups, e, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* v210_mapping_name(int variant) {
  return variant >= 0 && variant < static_cast<int>(sizeof(kNames) / sizeof(kNames[0])) ? kNames[variant] : nullptr;
}

extern "C" int v210_mapping(int variant, const void* const* frames, const int* channels, const void* const* wys,
                            const void* const* wxs, int n_layers, void* words, int width, int height, int groups,
                            const float* coeffs, const void* corr, void* stream) {
  phn::Layers L;
  if (!layers_of(frames, channels, wys, wxs, n_layers, L)) return static_cast<int>(cudaErrorInvalidValue);
  const phn::Encode e = phn::encode_from(coeffs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) return launch_persistent(block_kernel, kBlockThreads, kBlockSmemBytes, L, e, corr, words, width,
                                             height, groups, st);
  if (variant == 1 || variant == 2) {
    const bool vec = pairs_aligned(L, width);
    if (variant == 1)
      return vec ? launch_persistent(pairs_kernel<true, false>, kSegThreads, kSegSmemBytes, L, e, corr, words, width,
                                     height, groups, st)
                 : launch_persistent(pairs_kernel<false, false>, kSegThreads, kSegSmemBytes, L, e, corr, words, width,
                                     height, groups, st);
    return vec ? launch_persistent(pairs_kernel<true, true>, kSegThreads, kSegSmemBytes, L, e, corr, words, width,
                                   height, groups, st)
               : launch_persistent(pairs_kernel<false, true>, kSegThreads, kSegSmemBytes, L, e, corr, words, width,
                                   height, groups, st);
  }
  if (variant == 3) {
    const bool vec = phn::quads_aligned(L, width);
    const int per_warp = kStages * (3 + 4 * (L.n_layers - 1)) * phn::kPixelsPerBlock * 4;
    int warps = (phn::kSegSmemLimit - phn::kTable) / per_warp;
    warps = warps > 32 ? 32 : warps;
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = phn::kTable + warps * per_warp;
    if (vec) return launch_persistent(staged_kernel<true>, 32 * warps, smem, L, e, corr, words, width, height, groups, st);
    return launch_persistent(staged_kernel<false>, 32 * warps, smem, L, e, corr, words, width, height, groups, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
