// The l2g corrections: at each of the 65536 table indices of linear->gamma'
// (phn::l2g), the signed byte that moves phn::pow_approx's bits to powf's,
// which every kernel that encodes without powf reads (K2 v210_pack, B3
// fused_v210, B5 combine_pack, B11 planar422_pack, B13 planar420_pack;
// phn::l2g_corrected, phn::CorrectedL2G).  Built once per device and
// colour spec by ops/kernels.py l2g_corrections_on.
#include "phn_common.cuh"

namespace {

// corr[i]: bits(powf(fi, gamma)) - bits(pow_approx(fi, gamma)) at or past
// beta, 0 below it (where the transfer is linear)
__global__ void l2g_corrections_kernel(phn::L2G g, signed char* __restrict__ corr, int* __restrict__ bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= phn::kTable) return;
  const float fi = static_cast<float>(i) * g.inv_max;
  corr[i] = fi < g.beta ? 0 : phn::correction(powf(fi, g.gamma), phn::pow_approx(fi, g.gamma), bad);
}

}  // namespace

// corr: 65536 bytes in device memory, filled with the corrections of the
// encode's linear->gamma' (enc_coeffs: col[12], l2g[6]; only l2g is read);
// bad: one int32 in device memory, set to the count of indices whose
// correction a byte cannot hold (0 expected).  Returns cudaGetLastError().
extern "C" int phn_l2g_corrections(void* corr, void* bad, const float* enc_coeffs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  l2g_corrections_kernel<<<phn::kTable / 256, 256, 0, st>>>(phn::encode_from(enc_coeffs).g,
                                                            static_cast<signed char*>(corr), static_cast<int*>(bad));
  return static_cast<int>(cudaGetLastError());
}
