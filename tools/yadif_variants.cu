// yadif's suspects told apart (tools/kernel_variants.py): the ring and
// pair kernels as they were before their redesigns, one thread per output
// pixel in 32x8 blocks, each tap gathered from device memory through a
// clamped row and column, whole and with one part taken out.
//   part 0: the whole kernel (equals yadif_ring_plain / yadif_pair_plain)
//   part 1: the stores only (constants to the outputs, no loads)
//   part 2: the same clamped loads, summed (trivial arithmetic)
//   part 3: the full arithmetic on taps made from (x, y) (no loads)
//   part 4: the full arithmetic on taps read without clamps (interior
//           pixels; the edge pixels store a constant)
#include "../phaneron_tpu_torch/csrc/yadif.cu"

namespace {

// ---- the one-thread-a-pixel mapping's helpers, as csrc/yadif.cu had them
__device__ __forceinline__ const float* row_of(const float* plane, int y, int height,
                                               int width) {
  return plane + static_cast<size_t>(min(max(y, 0), height - 1)) * width;
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

const dim3 kBlock(32, 8);

dim3 grid_of(int height, int width) {
  return dim3((width + kBlock.x - 1) / kBlock.x, (height + kBlock.y - 1) / kBlock.y);
}

// the predicted value of one plane with part kPart of the taps
template <int kPart>
__device__ __forceinline__ float predict_part(const float* prev, const float* cur,
                                              const float* next, int x, int y, int height,
                                              int width, bool is_second, bool skip_spatial) {
  if (kPart == 0) return predict(prev, cur, next, x, y, height, width, is_second, skip_spatial);
  const float* cde = is_second ? cur : prev;
  const float* hij = is_second ? next : cur;
  if (kPart == 2) {
    const float* cu = row_of(cur, y - 1, height, width);
    const float* cd = row_of(cur, y + 1, height, width);
    float acc = 0.0f;
#pragma unroll
    for (int d = -3; d <= 3; ++d) acc += cu[col_of(x + d, width)] + cd[col_of(x + d, width)];
    return acc + row_of(prev, y - 1, height, width)[x] + row_of(prev, y + 1, height, width)[x] +
           row_of(cde, y - 2, height, width)[x] + row_of(cde, y, height, width)[x] +
           row_of(cde, y + 2, height, width)[x] + row_of(hij, y - 2, height, width)[x] +
           row_of(hij, y, height, width)[x] + row_of(hij, y + 2, height, width)[x] +
           row_of(next, y - 1, height, width)[x] + row_of(next, y + 1, height, width)[x];
  }
  if (kPart == 3) {
    float t[26];
#pragma unroll
    for (int i = 0; i < 26; ++i) t[i] = static_cast<float>((x * 7 + y * 13 + i * 29) & 255) * 0.00390625f;
    const float spatial = spatial_from_taps(t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8],
                                            t[9], t[10], t[11], t[12], t[13]);
    return temporal_clamp(t[14], t[15], t[16], t[17], t[18], t[3], t[10], t[19], t[20], t[21],
                          t[22], t[23], spatial, skip_spatial);
  }
  // kPart == 4: interior pixels, no clamps
  if (x < 3 || x >= width - 3 || y < 2 || y >= height - 2) return 0.5f;
  const float* cu = cur + static_cast<size_t>(y - 1) * width;
  const float* cd = cu + 2 * width;
  const float spatial = spatial_from_taps(cu[x - 3], cu[x - 2], cu[x - 1], cu[x], cu[x + 1],
                                          cu[x + 2], cu[x + 3], cd[x - 3], cd[x - 2], cd[x - 1],
                                          cd[x], cd[x + 1], cd[x + 2], cd[x + 3]);
  const size_t o = static_cast<size_t>(y) * width + x;
  const size_t w = width;
  return temporal_clamp(prev[o - w], prev[o + w], cde[o - 2 * w], cde[o], cde[o + 2 * w], cu[x],
                        cd[x], hij[o - 2 * w], hij[o], hij[o + 2 * w], next[o - w], next[o + w],
                        spatial, skip_spatial);
}

template <int kPart>
__device__ __forceinline__ void pixel_part(const float* __restrict__ prev,
                                           const float* __restrict__ cur,
                                           const float* __restrict__ next, float* __restrict__ out,
                                           const Frame& f, int x, int y, bool keep,
                                           bool is_second) {
  const size_t plane = static_cast<size_t>(f.width) * f.height;
  const size_t o = static_cast<size_t>(y) * f.width + x;
  for (int c = 0; c < 3; ++c) {
    const size_t off = c * plane;
    if (kPart == 1) {
      out[off + o] = 0.25f * c;
    } else {
      out[off + o] = keep ? cur[off + o]
                          : predict_part<kPart>(prev + off, cur + off, next + off, x, y, f.height,
                                                f.width, is_second, f.skip_spatial);
    }
  }
  if (f.channels == 4) out[3 * plane + o] = f.opaque || kPart == 1 ? 1.0f : cur[3 * plane + o];
}

template <int kPart>
__global__ void old_pair_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                                const float* __restrict__ next, float* __restrict__ out0,
                                float* __restrict__ out1, Frame f, int tff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= f.width || y >= f.height) return;
  const int kept = y % 2, predicted = 1 - kept;
  pixel_part<kPart>(prev, cur, next, kept ? out1 : out0, f, x, y, true, false);
  pixel_part<kPart>(prev, cur, next, kept ? out0 : out1, f, x, y, false, (predicted ^ tff) == 0);
}

// The ring kernel before its redesign: one parity, read from device memory
template <int kPart>
__global__ void old_ring_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                                const float* __restrict__ next, const int* __restrict__ parity,
                                float* __restrict__ out, Frame f, int tff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= f.width || y >= f.height) return;
  const int par = *parity;
  pixel_part<kPart>(prev, cur, next, out, f, x, y, (y % 2) == par, (par ^ tff) == 0);
}

}  // namespace

// The old pair kernel with part `part` (0..4), the arguments of phn_yadif_pair
extern "C" int yadif_old_pair(int part, const void* prev, const void* cur, const void* next,
                              void* out0, void* out1, int channels, int height, int width, int tff,
                              int skip_spatial, int opaque, void* stream) {
  if (!valid(channels, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  const Frame f{channels, height, width, skip_spatial != 0, opaque != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(prev);
  const auto* b = static_cast<const float*>(cur);
  const auto* c = static_cast<const float*>(next);
  auto* o0 = static_cast<float*>(out0);
  auto* o1 = static_cast<float*>(out1);
  const dim3 grid = grid_of(height, width);
  switch (part) {
    case 0: old_pair_kernel<0><<<grid, kBlock, 0, st>>>(a, b, c, o0, o1, f, tff != 0); break;
    case 1: old_pair_kernel<1><<<grid, kBlock, 0, st>>>(a, b, c, o0, o1, f, tff != 0); break;
    case 2: old_pair_kernel<2><<<grid, kBlock, 0, st>>>(a, b, c, o0, o1, f, tff != 0); break;
    case 3: old_pair_kernel<3><<<grid, kBlock, 0, st>>>(a, b, c, o0, o1, f, tff != 0); break;
    case 4: old_pair_kernel<4><<<grid, kBlock, 0, st>>>(a, b, c, o0, o1, f, tff != 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The old ring kernel with part `part` (0..4), the arguments of phn_yadif_ring
extern "C" int yadif_old_ring(int part, const void* prev, const void* cur, const void* next,
                              const void* parity, void* out, int channels, int height, int width,
                              int tff, int skip_spatial, int opaque, void* stream) {
  if (!valid(channels, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  const Frame f{channels, height, width, skip_spatial != 0, opaque != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(prev);
  const auto* b = static_cast<const float*>(cur);
  const auto* c = static_cast<const float*>(next);
  const auto* par = static_cast<const int*>(parity);
  auto* o = static_cast<float*>(out);
  const dim3 grid = grid_of(height, width);
  switch (part) {
    case 0: old_ring_kernel<0><<<grid, kBlock, 0, st>>>(a, b, c, par, o, f, tff != 0); break;
    case 1: old_ring_kernel<1><<<grid, kBlock, 0, st>>>(a, b, c, par, o, f, tff != 0); break;
    case 2: old_ring_kernel<2><<<grid, kBlock, 0, st>>>(a, b, c, par, o, f, tff != 0); break;
    case 3: old_ring_kernel<3><<<grid, kBlock, 0, st>>>(a, b, c, par, o, f, tff != 0); break;
    case 4: old_ring_kernel<4><<<grid, kBlock, 0, st>>>(a, b, c, par, o, f, tff != 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
