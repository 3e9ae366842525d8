// The planar unpacks' suspects told apart (tools/kernel_variants.py
// planar): K3/B10 (planar 4:2:2, 8 or 10 bit) and B12 (yuv420p, nv12) in
// the first design and in one other mapping.
//   planar_old_mapping: one thread a pixel pair of one row, 128-thread
//     blocks, a row a grid row (the kernels before their redesign): each
//     pixel's four plane stores land 8 bytes apart from lane to lane, and
//     a 4:2:0 chroma sample is loaded by the threads of both its rows.
//     part 0: whole; 1: stores only (a constant decode, no loads); 2: no
//     gamma'->linear gather (the table index scaled instead); 3: loads and
//     trivial arithmetic (the samples stored as they are).
//   planar_pixel_mapping: one thread a pixel, 192-thread blocks of 4 rows
//     (4:2:0: 4 row pairs), K1's mapping: each lane loads its own luma
//     sample and its pair's chroma samples, and stores each plane on
//     consecutive floats.
// form: 0 yuv422p8, 1 yuv422p10le, 2 yuv420p, 3 nv12.  Planes and pitches
// as phn_planar422_unpack / phn_planar420_unpack take them (c1 unused for
// nv12).
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

template <int kPart>
__device__ __forceinline__ void old_px(const phn::Decode& d, float yf, float uf, float vf, float rgb[3]) {
  if (kPart == 1) {
    rgb[0] = 0.25f;
    rgb[1] = 0.5f;
    rgb[2] = 0.75f;
  } else if (kPart == 2) {
    float lin[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gam = d.col[4 * c] * yf + d.col[4 * c + 1] * uf + d.col[4 * c + 2] * vf + d.col[4 * c + 3];
      lin[c] = static_cast<float>(phn::u16_sat_rte(gam * 65535.0f)) * 1.52590219e-05f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = d.gamut[3 * c] * lin[0] + d.gamut[3 * c + 1] * lin[1] + d.gamut[3 * c + 2] * lin[2];
  } else if (kPart == 3) {
    rgb[0] = yf;
    rgb[1] = uf;
    rgb[2] = vf;
  } else {
    phn::decode(d, yf, uf, vf, rgb);
  }
}

// the first design's phn::decode_pair
template <int kPart, typename T>
__device__ __forceinline__ void old_pair(const phn::Decode& d, const T* __restrict__ yrow, int x0, int width,
                                         float uf, float vf, float* __restrict__ o, size_t plane) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int x = x0 + q;
    if (x >= width) break;
    float rgb[3];
    old_px<kPart>(d, kPart == 1 ? 0.0f : static_cast<float>(yrow[x]), uf, vf, rgb);
    o[x] = rgb[0];
    o[plane + x] = rgb[1];
    o[2 * plane + x] = rgb[2];
    o[3 * plane + x] = 1.0f;
  }
}

template <int kPart, typename T>
__global__ void old422_kernel(const T* __restrict__ y, const T* __restrict__ u, const T* __restrict__ v,
                              float* __restrict__ out, phn::Decode d, int width, int height, int y_pitch,
                              int c_pitch) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (2 * k >= width) return;
  const size_t c = static_cast<size_t>(row) * c_pitch + k;
  const float uf = kPart == 1 ? 0.0f : static_cast<float>(u[c]);
  const float vf = kPart == 1 ? 0.0f : static_cast<float>(v[c]);
  old_pair<kPart>(d, y + static_cast<size_t>(row) * y_pitch, 2 * k, width, uf, vf,
                  out + static_cast<size_t>(row) * width, static_cast<size_t>(width) * height);
}

template <int kPart>
__global__ void old420_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ c0,
                              const uint8_t* __restrict__ c1, float* __restrict__ out, phn::Decode d, int width,
                              int height, int y_pitch, int c_pitch, int interleaved) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (2 * k >= width) return;
  const uint8_t* crow = c0 + static_cast<size_t>(row >> 1) * c_pitch;
  float uf = 0.0f, vf = 0.0f;
  if (kPart != 1) {
    if (interleaved) {
      uf = static_cast<float>(crow[2 * k]);
      vf = static_cast<float>(crow[2 * k + 1]);
    } else {
      uf = static_cast<float>(crow[k]);
      vf = static_cast<float>(c1[static_cast<size_t>(row >> 1) * c_pitch + k]);
    }
  }
  old_pair<kPart>(d, y + static_cast<size_t>(row) * y_pitch, 2 * k, width, uf, vf,
                  out + static_cast<size_t>(row) * width, static_cast<size_t>(width) * height);
}

template <int kPart>
void launch_old(int form, const void* y, const void* c0, const void* c1, float* o, const phn::Decode& d,
                int width, int height, int y_pitch, int c_pitch, cudaStream_t st) {
  const dim3 grid(((width + 1) / 2 + 127) / 128, height);
  if (form == 0) {
    old422_kernel<kPart, uint8_t><<<grid, 128, 0, st>>>(static_cast<const uint8_t*>(y),
        static_cast<const uint8_t*>(c0), static_cast<const uint8_t*>(c1), o, d, width, height, y_pitch, c_pitch);
  } else if (form == 1) {
    old422_kernel<kPart, uint16_t><<<grid, 128, 0, st>>>(static_cast<const uint16_t*>(y),
        static_cast<const uint16_t*>(c0), static_cast<const uint16_t*>(c1), o, d, width, height, y_pitch, c_pitch);
  } else {
    old420_kernel<kPart><<<grid, 128, 0, st>>>(static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(c0),
        static_cast<const uint8_t*>(c1), o, d, width, height, y_pitch, c_pitch, form == 3);
  }
}

// one thread a pixel: 4:2:2 rows or 4:2:0 row pairs, kRows of them a block
constexpr int kRows = 4;

template <typename T, bool k420, bool kNv12>
__global__ void __launch_bounds__(phn::kPixelsPerBlock)
    pixel_kernel(const T* __restrict__ y, const T* __restrict__ c0, const T* __restrict__ c1,
                 float* __restrict__ out, const __grid_constant__ phn::Decode d, int width, int height, int y_pitch,
                 int c_pitch) {
  const int x = blockIdx.x * phn::kPixelsPerBlock + threadIdx.x;
  if (x >= width) return;
  const size_t plane = static_cast<size_t>(width) * height;
  const int units = k420 ? (height + 1) / 2 : height;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int unit = blockIdx.y * kRows + r;
    if (unit >= units) break;
    const size_t c = static_cast<size_t>(unit) * c_pitch;
    const float uf = static_cast<float>(__ldg(c0 + c + (kNv12 ? 2 * (x >> 1) : x >> 1)));
    const float vf = static_cast<float>(kNv12 ? __ldg(c0 + c + 2 * (x >> 1) + 1) : __ldg(c1 + c + (x >> 1)));
#pragma unroll
    for (int h = 0; h < (k420 ? 2 : 1); ++h) {
      const int row = k420 ? 2 * unit + h : unit;
      if (row >= height) break;
      float rgb[3];
      phn::decode(d, static_cast<float>(__ldg(y + static_cast<size_t>(row) * y_pitch + x)), uf, vf, rgb);
      float* o = out + static_cast<size_t>(row) * width + x;
      o[0] = rgb[0];
      o[plane] = rgb[1];
      o[2 * plane] = rgb[2];
      o[3 * plane] = 1.0f;
    }
  }
}

}  // namespace

extern "C" int planar_old_mapping(int part, int form, const void* y, const void* c0, const void* c1, void* out,
                                  int width, int height, int y_pitch, int c_pitch, const float* coeffs,
                                  const float* g2l, void* stream) {
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form < 0 || form > 3) return static_cast<int>(cudaErrorInvalidValue);
  switch (part) {
    case 0: launch_old<0>(form, y, c0, c1, o, d, width, height, y_pitch, c_pitch, st); break;
    case 1: launch_old<1>(form, y, c0, c1, o, d, width, height, y_pitch, c_pitch, st); break;
    case 2: launch_old<2>(form, y, c0, c1, o, d, width, height, y_pitch, c_pitch, st); break;
    case 3: launch_old<3>(form, y, c0, c1, o, d, width, height, y_pitch, c_pitch, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int planar_pixel_mapping(int form, const void* y, const void* c0, const void* c1, void* out, int width,
                                    int height, int y_pitch, int c_pitch, const float* coeffs, const float* g2l,
                                    void* stream) {
  const phn::Decode d = phn::decode_from(coeffs, g2l);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int units = form >= 2 ? (height + 1) / 2 : height;
  const dim3 grid((width + phn::kPixelsPerBlock - 1) / phn::kPixelsPerBlock, (units + kRows - 1) / kRows);
  const dim3 block(phn::kPixelsPerBlock);
  const uint8_t *y8 = static_cast<const uint8_t*>(y), *a8 = static_cast<const uint8_t*>(c0),
                *b8 = static_cast<const uint8_t*>(c1);
  switch (form) {
    case 0: pixel_kernel<uint8_t, false, false><<<grid, block, 0, st>>>(y8, a8, b8, o, d, width, height, y_pitch,
                                                                        c_pitch); break;
    case 1: pixel_kernel<uint16_t, false, false><<<grid, block, 0, st>>>(
        static_cast<const uint16_t*>(y), static_cast<const uint16_t*>(c0), static_cast<const uint16_t*>(c1), o, d,
        width, height, y_pitch, c_pitch); break;
    case 2: pixel_kernel<uint8_t, true, false><<<grid, block, 0, st>>>(y8, a8, b8, o, d, width, height, y_pitch,
                                                                       c_pitch); break;
    case 3: pixel_kernel<uint8_t, true, true><<<grid, block, 0, st>>>(y8, a8, a8, o, d, width, height, y_pitch,
                                                                      c_pitch); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
