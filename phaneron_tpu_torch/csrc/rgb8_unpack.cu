// rgb8_unpack: 8-bit interleaved RGBA, rgba8 (bytes R, G, B, A) or bgra8 (B,
// G, R, A), one (H, W, 4) uint8 plane -> linear RGBA (4, H, W) float32.
//
// Replaces no TPU kernel: the JAX package decodes the RGB formats in XLA
// (phaneron_tpu/ops/io.py to_rgba), and so did the port, in 21 torch ops a
// source (1.13-1.16 device ms a UHD tick of the keyed file-media channel, the
// largest single block of it; PERF.md).  Per pixel: each byte c of R, G, B
// and A -> the gamma'->linear cell at index c * 257 (== rte(c * 65535 / 255),
// rgba8.ts:53-61; alpha through the same transfer), then the 3x3 gamut on R,
// G and B, each row summed left to right (ops/colorspace.py rgb_gamut; the
// library is built with -fmad=false), alpha as it is: equal to the plain
// version (ops/kernels.py rgb8_unpack_plain) to the bit.
//
// Bound: device-memory bytes, 4 read and 16 written a pixel (UHD 166 MB,
// 0.0495 ms at 3.35 TB/s; 1080p 0.0124 ms).  The plane and each output plane
// hold their pixels in the same row-major order, so the frame, or a band's
// rows of it, is one run of pixels: a thread takes kQuadsPerThread quads of 4
// pixels, kThreads quads apart, each in one 16-byte load (neighbouring lanes
// on neighbouring quads) and each of its 4 output planes in one 16-byte
// store.  With its loads in flight, each block gathers the 256 cells
// table[c * 257] into shared memory, one a thread, so a quad's 16 gathers
// never leave the SM.  Where the pixel count is not a multiple of 4 (planes 1
// to 3 then lie off 16 bytes) one store a pixel, and where the plane also
// lies off 16 bytes (a band's rows) one 4-byte load a pixel: the C entry
// chooses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block; one table cell a thread
constexpr int kQuadsPerThread = 4;  // quads a thread, kThreads apart
constexpr int kCodes = 256;
constexpr int kIndexStep = 257;  // the table index of code c: c * 257
static_assert(kThreads == kCodes, "one table cell a thread");

struct Rgb8Decode {
  float gamut[9];  // 3x3, rows R, G, B over linear (R, G, B)
  const float* table;  // gamma'->linear, 65536 float32 in device memory
};

// kR: the byte position of R (0 rgba8, 2 bgra8); G at 1, B at 2 - kR, A at 3
template <int kR, bool kVecLoad, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
    rgb8_unpack_kernel(const uint32_t* __restrict__ in, float* __restrict__ out,
                       const __grid_constant__ Rgb8Decode d, long long n) {
  __shared__ float lin[kCodes];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kQuadsPerThread + threadIdx.x;
  uint32_t px[kQuadsPerThread][4];
#pragma unroll
  for (int i = 0; i < kQuadsPerThread; ++i) {
    const long long p = 4 * (first + static_cast<long long>(i) * kThreads);
    if constexpr (kVecLoad) {  // n % 4 == 0: a quad is whole or outside
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (p < n) w = __ldg(reinterpret_cast<const uint4*>(in + p));
      px[i][0] = w.x;
      px[i][1] = w.y;
      px[i][2] = w.z;
      px[i][3] = w.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) px[i][k] = p + k < n ? __ldg(in + p + k) : 0u;
    }
  }
  lin[threadIdx.x] = __ldg(d.table + threadIdx.x * kIndexStep);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kQuadsPerThread; ++i) {
    const long long p = 4 * (first + static_cast<long long>(i) * kThreads);
    if (p >= n) break;
    float c[4][4];  // channel, pixel
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = px[i][k];
      const float r = lin[(v >> (8 * kR)) & 0xFFu];
      const float g = lin[(v >> 8) & 0xFFu];
      const float b = lin[(v >> (8 * (2 - kR))) & 0xFFu];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        c[ch][k] = d.gamut[3 * ch] * r + d.gamut[3 * ch + 1] * g + d.gamut[3 * ch + 2] * b;
      c[3][k] = lin[v >> 24];
    }
    float* o = out + p;
    if constexpr (kVecStore) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        *reinterpret_cast<float4*>(o + ch * n) = make_float4(c[ch][0], c[ch][1], c[ch][2], c[ch][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (p + k >= n) break;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) o[ch * n + k] = c[ch][k];
      }
    }
  }
}

template <int kR, bool kVecLoad, bool kVecStore>
void launch(const void* in, float* out, const Rgb8Decode& d, long long n, cudaStream_t s) {
  const long long per_block = 4LL * kThreads * kQuadsPerThread;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  rgb8_unpack_kernel<kR, kVecLoad, kVecStore><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(in), out, d, n);
}

template <int kR>
void launch_any(const void* in, float* out, const Rgb8Decode& d, long long n, cudaStream_t s) {
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_stores = n % 4 == 0 && at16(out);
  if (vec_stores && at16(in)) {
    launch<kR, true, true>(in, out, d, n, s);
  } else if (vec_stores) {
    launch<kR, false, true>(in, out, d, n, s);
  } else {
    launch<kR, false, false>(in, out, d, n, s);
  }
}

}  // namespace

// in: (height, width, 4) uint8, 4-byte aligned; out: (4, height, width)
// float32.  r_byte: the byte position of R, 0 (rgba8) or 2 (bgra8).  gamut:
// the 3x3 gamut matrix (9 float32, host memory); table: the gamma'->linear
// table (65536 float32) in device memory.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another r_byte.
extern "C" int phn_rgb8_unpack(const void* in, void* out, int width, int height, int r_byte,
                               const float* gamut, const float* table, void* stream) {
  Rgb8Decode d;
  for (int i = 0; i < 9; ++i) d.gamut[i] = gamut[i];
  d.table = table;
  const long long n = static_cast<long long>(width) * height;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (r_byte != 0 && r_byte != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (r_byte == 0) {
    launch_any<0>(in, o, d, n, s);
  } else {
    launch_any<2>(in, o, d, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
