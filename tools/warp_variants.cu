// K4's suspects told apart (tools/kernel_variants.py k4): the axis-aligned
// warp in its first thread mapping (csrc/warp.cu before its redesign: one
// thread a pixel in 32x8 blocks, its own taps from two divisions a matrix,
// channels and mode read at run time, each channel's taps read from
// device memory through L1 and blended before the next channel's), whole
// and with one part taken out or changed:
//   part 0: whole
//   part 1: stores only (no taps, no loads: a value made from the position)
//   part 2: the taps and the lerps, each tap value made from the taps'
//           position in place of its load
// Part 0 computes the kernel's function; 1 and 2 are timed only.  The
// built kernel (csrc/warp.cu) is this mapping with the channel count and
// the mode made template constants.
#include "../phaneron_tpu_torch/csrc/phn_common.cuh"

namespace {

template <int kPart>
__device__ __forceinline__ float sample_part(const float* __restrict__ s, int width,
                                             const phn::Taps& t) {
  if (kPart == 2) {  // a value from the tap's position, no load
    const float q = static_cast<float>(t.x0 + t.y0);
    return phn::bilerp(t, q, q + 1.0f, q + 2.0f, q + 3.0f);
  }
  return phn::sample(s, width, t);
}

// parts 0-2: channels and mode at run time, as the old kernel
template <int kPart>
__global__ void warp_old_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                const float* __restrict__ mat, const float* __restrict__ mat_b,
                                const float* __restrict__ mix, const float* __restrict__ mask,
                                float* __restrict__ out, int channels, int height, int width) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const size_t plane = static_cast<size_t>(width) * height;
  const size_t o = static_cast<size_t>(y) * width + x;
  if (kPart == 1) {
    for (int c = 0; c < channels; ++c) out[c * plane + o] = static_cast<float>(x + c) * 0.25f + y;
    return;
  }
  const phn::Taps t = phn::axis_taps(mat, x, y, width, height);
  const phn::Taps tb = b != nullptr ? phn::axis_taps(mat_b, x, y, width, height) : t;
  float m = 1.0f;
  if (mask != nullptr) {
    m = mask[o];
  } else if (b != nullptr) {
    m = *mix;
  }
  for (int c = 0; c < channels; ++c) {
    float v = sample_part<kPart>(a + c * plane, width, t);
    if (b != nullptr) {
      const float vb = sample_part<kPart>(b + c * plane, width, tb);
      v = mask != nullptr ? vb * m + v * (1.0f - m) : v * m + vb * (1.0f - m);
    }
    out[c * plane + o] = v;
  }
}

}  // namespace

// The arguments of the old phn_warp after the part.  Returns
// cudaGetLastError().
extern "C" int warp_old_mapping(int part, const void* a, const void* b, const void* mat,
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
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  switch (part) {
    case 0: warp_old_kernel<0><<<grid, block, 0, st>>>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width); break;
    case 1: warp_old_kernel<1><<<grid, block, 0, st>>>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width); break;
    case 2: warp_old_kernel<2><<<grid, block, 0, st>>>(fa, fb, fm, fmb, fmix, fmask, o, channels, height, width); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
