// B14's suspects told apart (tools/kernel_variants.py rotate): the affine
// warp in its first thread mapping (csrc/rotate.cu before its redesign:
// one thread a pixel, every tap gathered from device memory, 32x8 blocks
// so that a warp is 32 pixels of one output row), whole and with one part
// taken out or changed:
//   part 0: whole
//   part 1: stores only (no taps, no loads: a value made from the position)
//   part 2: the taps and the lerps, each tap value made from the taps'
//           position in place of its load
//   part 3: whole, in 16x16 blocks whose warps each cover 8x4 output pixels
// Parts 0 and 3 compute the kernel's function; 1 and 2 are timed only.
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

__device__ __forceinline__ phn::Taps affine_taps(const float* mat, int x, int y, int width,
                                                 int height) {
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float ix = static_cast<float>(x) / fw - 0.5f;
  const float iy = static_cast<float>(y) / fh - 0.5f;
  const float px = mat[0] * ix + mat[1] * iy + mat[2] + 0.5f;
  const float py = mat[3] * ix + mat[4] * iy + mat[5] + 0.5f;
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

template <int kPart>
__device__ __forceinline__ float sample_affine(const float* __restrict__ s, int width,
                                               const phn::Taps& t) {
  const float* r0 = s + static_cast<ptrdiff_t>(t.y0) * width;
  const float* r1 = r0 + width;
  float v00, v10, v01, v11;
  if (kPart == 2) {  // a value from the tap's position, no load
    const float q = static_cast<float>(t.x0 + t.y0);
    v00 = t.vx0 && t.vy0 ? q : 0.0f;
    v10 = t.vx1 && t.vy0 ? q + 1.0f : 0.0f;
    v01 = t.vx0 && t.vy1 ? q + 2.0f : 0.0f;
    v11 = t.vx1 && t.vy1 ? q + 3.0f : 0.0f;
  } else {
    v00 = t.vx0 && t.vy0 ? r0[t.x0] : 0.0f;
    v10 = t.vx1 && t.vy0 ? r0[t.x0 + 1] : 0.0f;
    v01 = t.vx0 && t.vy1 ? r1[t.x0] : 0.0f;
    v11 = t.vx1 && t.vy1 ? r1[t.x0 + 1] : 0.0f;
  }
  const float top = v00 * (1.0f - t.fx) + v10 * t.fx;
  const float bot = v01 * (1.0f - t.fx) + v11 * t.fx;
  return top * (1.0f - t.fy) + bot * t.fy;
}

template <int kPart>
__global__ void rotate_old_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ mat, const float* __restrict__ mat_b,
                                  const float* __restrict__ mix, const float* __restrict__ mask,
                                  float* __restrict__ out, int channels, int height, int width) {
  int x, y;
  if (kPart == 3) {  // 16x16 blocks of 8 warps, a warp 8x4 pixels
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, warp = tid >> 5, lane = tid & 31;
    x = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
    y = blockIdx.y * 16 + (warp >> 1) * 4 + (lane >> 3);
  } else {
    x = blockIdx.x * blockDim.x + threadIdx.x;
    y = blockIdx.y * blockDim.y + threadIdx.y;
  }
  if (x >= width || y >= height) return;
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  if (kPart == 1) {
    for (int c = 0; c < channels; ++c) out[c * plane + o] = static_cast<float>(x + c) * 0.25f + y;
    return;
  }
  const phn::Taps t = affine_taps(mat, x, y, width, height);
  const phn::Taps tb = b != nullptr ? affine_taps(mat_b, x, y, width, height) : t;
  float m = 1.0f;
  if (mask != nullptr) {
    m = mask[o];
  } else if (b != nullptr) {
    m = *mix;
  }
  for (int c = 0; c < channels; ++c) {
    float v = sample_affine<kPart>(a + c * plane, width, t);
    if (b != nullptr) {
      const float vb = sample_affine<kPart>(b + c * plane, width, tb);
      v = mask != nullptr ? vb * m + v * (1.0f - m) : v * m + vb * (1.0f - m);
    }
    out[c * plane + o] = v;
  }
}

template <int kPart>
void launch(const float* a, const float* b, const float* mat, const float* mat_b, const float* mix,
            const float* mask, float* out, int channels, int height, int width, cudaStream_t st) {
  const dim3 block = kPart == 3 ? dim3(16, 16) : dim3(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  rotate_old_kernel<kPart><<<grid, block, 0, st>>>(a, b, mat, mat_b, mix, mask, out, channels,
                                                   height, width);
}

}  // namespace

// The arguments of phn_rotate (without its branches) after the part.
// Returns cudaGetLastError().
extern "C" int rotate_old_mapping(int part, const void* a, const void* b, const void* mat,
                                  const void* mat_b, const void* mix, const void* mask, void* out,
                                  int channels, int height, int width, void* stream) {
  if (b != nullptr && (mix == nullptr) == (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fa = static_cast<const float*>(a), fb = static_cast<const float*>(b);
  const auto fm = static_cast<const float*>(mat);
  const auto fmb = mat_b != nullptr ? static_cast<const float*>(mat_b) : fm;
  const auto fmix = static_cast<const float*>(mix), fmask = static_cast<const float*>(mask);
  const auto o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (part) {
    case 0: launch<0>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width, st); break;
    case 1: launch<1>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width, st); break;
    case 2: launch<2>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width, st); break;
    case 3: launch<3>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
