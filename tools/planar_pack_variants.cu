// The planar packs' suspects told apart (tools/kernel_variants.py packs):
// B11 (planar 4:2:2, 8 or 10 bit) and B13 (yuv420p, nv12) in their first
// design and in the other mappings and transfers measured for the
// redesign.
//   pack_old_mapping: one thread a pixel pair of one row, 128-thread
//     blocks, a row a grid row (the kernels before their redesign, with
//     their phn::encode_pair): three scalar loads a pixel, lanes 8 bytes
//     apart; each sample its own 1- or 2-byte store; three full-precision
//     powf a pixel.  part 0: whole; 1: stores only (constant codes, no
//     loads); 2: no powf (the linear segment fi * delta for every index);
//     3: loads with trivial arithmetic (the codes from the samples' bits).
//   pack_quad: one thread a quad (4 pixels of a row) or two (8 pixels),
//     16-byte loads a plane into registers (one load a pixel with kVec
//     off; the built kernels stage them in shared memory with cp.async a
//     tile ahead instead), one store of the luma and one of each chroma
//     plane's samples, linear->gamma' by
//     QuadXfer: 0 powf; 1 two MUFU operations and a correction byte from
//     shared memory (persistent blocks that copy the 64 KB once); 2 the
//     same, the bytes read through L1 (__ldg); 3 a gather from a 65536-float
//     table of l2g's values (pack_l2g_table); 4 the table's gather in warps
//     whose green indices span at most kGatherSpan, else 1.  4:2:0 a row
//     pair a thread (every thread the same work) or a row a thread (odd
//     rows without chroma).
// form: 0 yuv422p8, 1 yuv422p10le, 2 yuv420p, 3 nv12.  Planes and pitches
// as phn_planar422_pack / phn_planar420_pack take them (c1 unused for
// nv12).
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

// ---- the first design
struct PairCodes {
  unsigned y[2], cb, cr;
};

// the first design's phn::encode_pair, its transfer or loads changed by kPart
template <int kPart>
__device__ __forceinline__ PairCodes encode_pair(const phn::Encode& e, const float* __restrict__ row,
                                                 size_t plane, int x0, int width, bool chroma,
                                                 const phn::PlanarPad& pad) {
  PairCodes c{{pad.black, pad.black}, pad.null, pad.null};
  if (kPart == 1) {
    c.y[0] = 64u & pad.mask;
    c.y[1] = 940u & pad.mask;
    if (chroma) {
      c.cb = 512u & pad.mask;
      c.cr = 384u & pad.mask;
    }
    return c;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int x = x0 + q;
    if (x >= width) break;
    float rp, gp, bp;
    if (kPart == 2) {
      rp = static_cast<float>(phn::u16_sat_rte(row[x] * 65535.0f)) * e.g.inv_max * e.g.delta;
      gp = static_cast<float>(phn::u16_sat_rte(row[plane + x] * 65535.0f)) * e.g.inv_max * e.g.delta;
      bp = static_cast<float>(phn::u16_sat_rte(row[2 * plane + x] * 65535.0f)) * e.g.inv_max * e.g.delta;
    } else if (kPart == 3) {
      const unsigned bits = __float_as_uint(row[x]) ^ __float_as_uint(row[plane + x]) ^
                            __float_as_uint(row[2 * plane + x]);
      c.y[q] = bits & pad.mask;
      if (q == 0 && chroma) {
        c.cb = (bits >> 8) & pad.mask;
        c.cr = (bits >> 16) & pad.mask;
      }
      continue;
    } else {
      rp = phn::l2g(e.g, row[x]);
      gp = phn::l2g(e.g, row[plane + x]);
      bp = phn::l2g(e.g, row[2 * plane + x]);
    }
    c.y[q] = static_cast<unsigned>(phn::encode_row(e, 0, rp, gp, bp)) & pad.mask;
    if (q == 0 && chroma) {
      c.cb = static_cast<unsigned>(phn::encode_row(e, 1, rp, gp, bp)) & pad.mask;
      c.cr = static_cast<unsigned>(phn::encode_row(e, 2, rp, gp, bp)) & pad.mask;
    }
  }
  return c;
}

template <int kPart, typename T>
__global__ void old422_kernel(const float* __restrict__ rgb, T* __restrict__ y, T* __restrict__ u,
                              T* __restrict__ v, phn::Encode e, phn::PlanarPad pad, int width, int height,
                              int y_pitch, int c_pitch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (k >= c_pitch) return;

  const PairCodes c = encode_pair<kPart>(e, rgb + static_cast<size_t>(row) * width,
                                         static_cast<size_t>(width) * height, 2 * k, width, true, pad);
  T* yrow = y + static_cast<size_t>(row) * y_pitch;
  yrow[2 * k] = static_cast<T>(c.y[0]);
  yrow[2 * k + 1] = static_cast<T>(c.y[1]);
  u[static_cast<size_t>(row) * c_pitch + k] = static_cast<T>(c.cb);
  v[static_cast<size_t>(row) * c_pitch + k] = static_cast<T>(c.cr);
}

template <int kPart>
__global__ void old420_kernel(const float* __restrict__ rgb, uint8_t* __restrict__ y, uint8_t* __restrict__ c0,
                              uint8_t* __restrict__ c1, phn::Encode e, phn::PlanarPad pad, int width, int height,
                              int y_pitch, int c_pitch, int interleaved) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (2 * k >= y_pitch) return;

  const bool chroma = (row & 1) == 0;
  const PairCodes c = encode_pair<kPart>(e, rgb + static_cast<size_t>(row) * width,
                                         static_cast<size_t>(width) * height, 2 * k, width, chroma, pad);
  uint8_t* yrow = y + static_cast<size_t>(row) * y_pitch;
  yrow[2 * k] = static_cast<uint8_t>(c.y[0]);
  yrow[2 * k + 1] = static_cast<uint8_t>(c.y[1]);
  if (!chroma) return;
  const size_t crow = static_cast<size_t>(row >> 1) * c_pitch;
  if (interleaved) {
    c0[crow + 2 * k] = static_cast<uint8_t>(c.cb);
    c0[crow + 2 * k + 1] = static_cast<uint8_t>(c.cr);
  } else {
    c0[crow + k] = static_cast<uint8_t>(c.cb);
    c1[crow + k] = static_cast<uint8_t>(c.cr);
  }
}

template <int kPart>
void launch_old(int form, const float* rgb, void* y, void* c0, void* c1, const phn::Encode& e, int luma_black,
                int width, int height, int y_pitch, int c_pitch, cudaStream_t st) {
  if (form < 2) {
    const dim3 grid((c_pitch + 127) / 128, height);
    if (form == 0) {
      old422_kernel<kPart, uint8_t><<<grid, 128, 0, st>>>(rgb, static_cast<uint8_t*>(y), static_cast<uint8_t*>(c0),
          static_cast<uint8_t*>(c1), e, phn::planar_pad(8, luma_black), width, height, y_pitch, c_pitch);
    } else {
      old422_kernel<kPart, uint16_t><<<grid, 128, 0, st>>>(rgb, static_cast<uint16_t*>(y),
          static_cast<uint16_t*>(c0), static_cast<uint16_t*>(c1), e, phn::planar_pad(10, luma_black), width, height,
          y_pitch, c_pitch);
    }
  } else {
    const dim3 grid((y_pitch / 2 + 127) / 128, height);
    old420_kernel<kPart><<<grid, 128, 0, st>>>(rgb, static_cast<uint8_t*>(y), static_cast<uint8_t*>(c0),
        static_cast<uint8_t*>(c1), e, phn::planar_pad(8, luma_black), width, height, y_pitch, c_pitch, form == 3);
  }
}

// ---- the quad mappings, loading into registers
// R, G, B of the quad at x0 of a row (row: the row's R samples; channel
// planes `plane` floats apart; alpha is not read), n (<= 4) of its pixels
// inside the frame: with kVec one 16-byte load a plane (row + x0 16-byte
// aligned, a quad inside the frame whole or not at all), else one load a
// pixel
template <bool kVec>
__device__ __forceinline__ void load_quad(const float* __restrict__ row, size_t plane, int x0, int n,
                                          float (&rgb)[3][4]) {
  if constexpr (kVec) {
    if (n <= 0) return;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + c * plane + x0));
      rgb[c][0] = v.x;
      rgb[c][1] = v.y;
      rgb[c][2] = v.z;
      rgb[c][3] = v.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p >= n) break;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c][p] = __ldg(row + c * plane + x0 + p);
    }
  }
}

constexpr int kGatherSpan = 8192;  // QuadXfer 4: a warp gathers when its indices span at most this many

struct PowL2G {  // phn::l2g, with powf
  phn::L2G g;
  __device__ __forceinline__ float operator()(float x) const { return phn::l2g(g, x); }
};

struct LdgL2G {  // phn::l2g_corrected, the correction bytes through L1
  phn::L2G g;
  const signed char* corr;
  __device__ __forceinline__ float operator()(float x) const {
    const int i = phn::index_of(x);
    const float fi = static_cast<float>(i) * g.inv_max;
    if (fi < g.beta) return fi * g.delta;
    return g.alpha * __int_as_float(__float_as_int(phn::pow_approx(fi, g.gamma)) + __ldg(corr + i)) - g.alpha_m1;
  }
};

struct TableL2G {  // l2g's value gathered from its 65536-float table
  const float* lut;
  __device__ __forceinline__ float operator()(float x) const { return __ldg(lut + phn::index_of(x)); }
};

struct Args {
  const float* rgb;
  void *y, *c0, *c1;
  phn::Encode e;
  phn::PlanarPad pad;
  const int4* corr;
  const float* lut;
  int width, height, y_pitch, c_pitch;
};

// kN codes of kBits each in one store of kN * kBits / 8 bytes (s aligned to it)
template <typename T, int kN>
__device__ __forceinline__ void store_codes(T* s, const unsigned (&c)[kN]) {
  constexpr int kBits = 8 * sizeof(T), kWords = (kN * kBits + 31) / 32;
  if constexpr (kN * kBits == 16) {
    *reinterpret_cast<unsigned short*>(s) = static_cast<unsigned short>(c[0] | (c[1] << 8));
  } else {
    unsigned w[kWords] = {};
#pragma unroll
    for (int i = 0; i < kN; ++i) w[i * kBits / 32] |= c[i] << (i * kBits % 32);
    if constexpr (kWords == 1) *reinterpret_cast<unsigned*>(s) = w[0];
    if constexpr (kWords == 2) *reinterpret_cast<uint2*>(s) = make_uint2(w[0], w[1]);
    if constexpr (kWords == 4) *reinterpret_cast<uint4*>(s) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int kXfer>
__device__ __forceinline__ phn::QuadCodes encode(const Args& a, const signed char* smem, bool gather,
                                                 const float (&px)[3][4], int n, bool chroma) {
  if constexpr (kXfer == 0) return phn::encode_quad(a.e, PowL2G{a.e.g}, px, n, chroma, a.pad);
  if constexpr (kXfer == 1) return phn::encode_quad(a.e, phn::CorrectedL2G{a.e.g, smem}, px, n, chroma, a.pad);
  if constexpr (kXfer == 2)
    return phn::encode_quad(a.e, LdgL2G{a.e.g, reinterpret_cast<const signed char*>(a.corr)}, px, n, chroma, a.pad);
  if constexpr (kXfer == 3) return phn::encode_quad(a.e, TableL2G{a.lut}, px, n, chroma, a.pad);
  if constexpr (kXfer == 4) {
    if (gather) return phn::encode_quad(a.e, TableL2G{a.lut}, px, n, chroma, a.pad);
    return phn::encode_quad(a.e, phn::CorrectedL2G{a.e.g, smem}, px, n, chroma, a.pad);
  }
}

// kQuads (1 or 2) quads a thread; k420 with kPair: both rows of a row pair
template <typename T, int kForm, int kXfer, int kQuads, bool kPair, bool kVec, int kRows, int kBlocks>
__global__ void __launch_bounds__(32 * kRows, kBlocks) quad_kernel(const __grid_constant__ Args a) {
  constexpr bool k420 = kForm >= 2, kNv12 = kForm == 3, kSmem = kXfer == 1 || kXfer == 4;
  constexpr int kPx = 4 * kQuads, kH = k420 && kPair ? 2 : 1;
  extern __shared__ int4 table[];
  if constexpr (kSmem) phn::copy_corrections(table, a.corr, threadIdx.y * 32 + threadIdx.x, 32 * kRows);
  const signed char* smem = reinterpret_cast<const signed char*>(table);
  const int units = a.y_pitch / kPx, rows = kH == 2 ? (a.height + 1) / 2 : a.height;
  const int tiles_x = (units + 31) / 32;
  const int n_tiles = tiles_x * ((rows + kRows - 1) / kRows);
  const size_t plane = static_cast<size_t>(a.width) * a.height;
  bool copied = !kSmem;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int j = (tile % tiles_x) * 32 + threadIdx.x;
    const int r = (tile / tiles_x) * kRows + threadIdx.y;
    const bool inside = j < units && r < rows;
    const int x0 = kPx * j, row = kH * r;
    float px[kH][kQuads][3][4] = {};
    if (inside) {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        if (row + h >= a.height) break;
#pragma unroll
        for (int qd = 0; qd < kQuads; ++qd)
          load_quad<kVec>(a.rgb + static_cast<size_t>(row + h) * a.width, plane, x0 + 4 * qd,
                               a.width - x0 - 4 * qd, px[h][qd]);
      }
    }
    if (!copied) {
      phn::cp_async_wait<0>();
      __syncthreads();
      copied = true;
    }
    if (!inside) continue;
    bool gather = false;
    if constexpr (kXfer == 4) {
      const unsigned i = phn::index_of(px[0][0][1][0]), lanes = __activemask();
      gather = static_cast<int>(__reduce_max_sync(lanes, i) - __reduce_min_sync(lanes, i)) <= kGatherSpan;
    }
    unsigned cb[2 * kQuads], cr[2 * kQuads];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      if (row + h >= a.height) break;
      const bool chroma = h == 0 && (!k420 || kPair || (row & 1) == 0);
      unsigned ys[kPx];
#pragma unroll
      for (int qd = 0; qd < kQuads; ++qd) {
        const phn::QuadCodes q = encode<kXfer>(a, smem, gather, px[h][qd], a.width - x0 - 4 * qd, chroma);
#pragma unroll
        for (int p = 0; p < 4; ++p) ys[4 * qd + p] = q.y[p];
        if (h == 0) {
          cb[2 * qd] = q.cb[0];
          cb[2 * qd + 1] = q.cb[1];
          cr[2 * qd] = q.cr[0];
          cr[2 * qd + 1] = q.cr[1];
        }
      }
      store_codes<T, kPx>(static_cast<T*>(a.y) + static_cast<size_t>(row + h) * a.y_pitch + x0, ys);
    }
    if (k420 && !kPair && (row & 1)) continue;
    const size_t c = static_cast<size_t>(k420 ? row / 2 : row) * a.c_pitch;
    if constexpr (kNv12) {
      unsigned cc[4 * kQuads];
#pragma unroll
      for (int i = 0; i < 2 * kQuads; ++i) {
        cc[2 * i] = cb[i];
        cc[2 * i + 1] = cr[i];
      }
      store_codes<T, 4 * kQuads>(static_cast<T*>(a.c0) + c + x0, cc);
    } else {
      store_codes<T, 2 * kQuads>(static_cast<T*>(a.c0) + c + 2 * kQuads * j, cb);
      store_codes<T, 2 * kQuads>(static_cast<T*>(a.c1) + c + 2 * kQuads * j, cr);
    }
  }
}

template <typename T, int kForm, int kXfer, int kQuads, bool kPair, bool kVec, int kRows, int kBlocks>
int launch_quad(const Args& a, cudaStream_t st) {
  constexpr bool kSmem = kXfer == 1 || kXfer == 4;
  constexpr int kH = kForm >= 2 && kPair ? 2 : 1;
  auto kernel = quad_kernel<T, kForm, kXfer, kQuads, kPair, kVec, kRows, kBlocks>;
  const int rows = kH == 2 ? (a.height + 1) / 2 : a.height;
  const int tiles = (a.y_pitch / (4 * kQuads) + 31) / 32 * ((rows + kRows - 1) / kRows);
  int grid = tiles;
  if constexpr (kSmem) {
    static int resident[phn::kMaxDevices];
    cudaError_t err;
    const int wave = phn::resident_blocks(kernel, 32 * kRows, phn::kTable, resident, &err);
    if (wave == 0) return static_cast<int>(err);
    grid = min(tiles, wave);
  }
  kernel<<<grid, dim3(32, kRows), kSmem ? phn::kTable : 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kXfer, int kQuads, bool kPair, bool kVec, int kRows, int kBlocks>
int launch_forms(int form, const Args& a, cudaStream_t st) {
  switch (form) {
    case 0: return launch_quad<uint8_t, 0, kXfer, kQuads, kPair, kVec, kRows, kBlocks>(a, st);
    case 1: return launch_quad<uint16_t, 1, kXfer, kQuads, kPair, kVec, kRows, kBlocks>(a, st);
    case 2: return launch_quad<uint8_t, 2, kXfer, kQuads, kPair, kVec, kRows, kBlocks>(a, st);
    case 3: return launch_quad<uint8_t, 3, kXfer, kQuads, kPair, kVec, kRows, kBlocks>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void l2g_table_kernel(phn::L2G g, float* __restrict__ lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= phn::kTable) return;
  const float fi = static_cast<float>(i) * g.inv_max;
  lut[i] = fi < g.beta ? fi * g.delta : g.alpha * powf(fi, g.gamma) - g.alpha_m1;
}

}  // namespace

// The variants' names, in the order of pack_quad's variant argument
extern "C" const char* pack_quad_name(int variant) {
  static const char* names[] = {
      "registers, powf",
      "registers, corrections in shared memory",
      "registers, corrections through L1",
      "registers, float table",
      "registers, float table where a warp's indices lie close, else shared corrections",
      "registers, 8 pixels a thread, corrections in shared memory",
      "registers, quad a row (4:2:0), corrections in shared memory",
      "registers, one load a pixel, corrections in shared memory",
      "registers, 16 block rows, 2 blocks an SM, corrections in shared memory",
      "registers, 8 pixels a thread, powf",
  };
  return variant >= 0 && variant < static_cast<int>(sizeof(names) / sizeof(names[0])) ? names[variant] : nullptr;
}

// rgb, planes, pitches and luma_black as the built packs take them; form as
// above; corr: the l2g corrections (phn_l2g_corrections); lut: l2g's
// 65536-float table (pack_l2g_table).  Variants 1-4, 6 and 8 take the
// 16-byte loads, so the frame must be 16-byte aligned and its width a
// multiple of 4 (else cudaErrorInvalidValue); a 4:2:2 form runs variant 6
// as variant 1.
extern "C" int pack_quad(int variant, int form, const void* rgb, void* y, void* c0, void* c1, int width,
                         int height, int y_pitch, int c_pitch, int luma_black, const float* coeffs,
                         const void* corr, const float* lut, void* stream) {
  const Args a{static_cast<const float*>(rgb), y, c0, c1, phn::encode_from(coeffs),
               phn::planar_pad(form == 1 ? 10 : 8, luma_black), static_cast<const int4*>(corr), lut,
               width, height, y_pitch, c_pitch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(rgb) % 16 == 0 && width % 4 == 0;
  if (!vec && variant != 7) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return launch_forms<0, 1, true, true, 8, 1>(form, a, st);
    case 1: return launch_forms<1, 1, true, true, 32, 1>(form, a, st);
    case 2: return launch_forms<2, 1, true, true, 8, 1>(form, a, st);
    case 3: return launch_forms<3, 1, true, true, 8, 1>(form, a, st);
    case 4: return launch_forms<4, 1, true, true, 32, 1>(form, a, st);
    case 5: return launch_forms<1, 2, true, true, 32, 1>(form, a, st);
    case 6: return launch_forms<1, 1, false, true, 32, 1>(form, a, st);
    case 7: return launch_forms<1, 1, true, false, 32, 1>(form, a, st);
    case 8: return launch_forms<1, 1, true, true, 16, 2>(form, a, st);
    case 9: return launch_forms<0, 2, true, true, 8, 1>(form, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int pack_old_mapping(int part, int form, const void* rgb, void* y, void* c0, void* c1, int width,
                                int height, int y_pitch, int c_pitch, int luma_black, const float* coeffs,
                                void* stream) {
  const phn::Encode e = phn::encode_from(coeffs);
  const float* in = static_cast<const float*>(rgb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form < 0 || form > 3) return static_cast<int>(cudaErrorInvalidValue);
  switch (part) {
    case 0: launch_old<0>(form, in, y, c0, c1, e, luma_black, width, height, y_pitch, c_pitch, st); break;
    case 1: launch_old<1>(form, in, y, c0, c1, e, luma_black, width, height, y_pitch, c_pitch, st); break;
    case 2: launch_old<2>(form, in, y, c0, c1, e, luma_black, width, height, y_pitch, c_pitch, st); break;
    case 3: launch_old<3>(form, in, y, c0, c1, e, luma_black, width, height, y_pitch, c_pitch, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// lut: 65536 float32 in device memory, filled with l2g's value at every
// table index of the encode's transfer (enc_coeffs: col[12], l2g[6])
extern "C" int pack_l2g_table(float* lut, const float* enc_coeffs, void* stream) {
  l2g_table_kernel<<<phn::kTable / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(phn::encode_from(enc_coeffs).g,
                                                                                      lut);
  return static_cast<int>(cudaGetLastError());
}
