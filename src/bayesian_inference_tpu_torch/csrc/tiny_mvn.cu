// Batched tiny-MVN terms of given residuals and covariances.
//
// Replaces bayesian_inference_tpu/ops/pallas_mvn.py::_mvn_kernel (reached
// through _block_mvn_pallas <- block_mvn_loglike). For every instance i of
// the batch, with C[i] = L L^T:
//
//   quad[i]        = |L^{-1} dY[i]|^2
//   half_logdet[i] = sum log diag L
//
// so that the MVN log-likelihood is -quad/2 - half_logdet (block_mvn_loglike)
// and the Woodbury capacitance term of the lowrank likelihood,
// +r^T M^{-1} r / 2 - log det M / 2, is +quad/2 - half_logdet from the same
// single sweep (ops/mvn.py::woodbury_loglike).
//
// The TPU kernel put the batch on the 128 lanes and the (nb, nb, batch)
// matrix in VMEM. Here one warp owns one instance: it copies the lower
// triangle of C[i] and dY[i] into its own shared-memory tile (odd row pitch)
// and runs the column sweep of tiny_chol.cuh. A pivot that is not positive
// gives NaN in that instance only.
//
// What bounds it: the serial column steps of the sweep (a warp barrier each,
// ~nb^3/6 fused multiply-adds per instance spread over the lanes); reading C
// (nb^2 floats per instance) is a few microseconds at the lowrank batch sizes
// (50 to 1,500 instances of 41 x 41). Plain fp32 FMA in a fixed order.

#include <cuda_runtime.h>

#include "tiny_chol.cuh"

namespace {

constexpr int kWarps = 4;  // instances per thread block
constexpr int kMaxNb = 48;

__global__ void __launch_bounds__(kWarps * 32)
tiny_mvn_kernel(const float* __restrict__ dY, const float* __restrict__ C,
                float* __restrict__ quad_out, float* __restrict__ half_logdet_out, int nb, int B) {
  extern __shared__ float smem[];
  const int cp = nb | 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= B) return;  // warp-uniform; the kernel has no block-wide barrier

  float* tile = smem + warp * (nb * cp + nb);
  float* bs = tile + nb * cp;
  const float* Ci = C + static_cast<size_t>(i) * nb * nb;
  for (int e = lane; e < nb * nb; e += 32) {
    const int f = e / nb, g = e - f * nb;
    if (g <= f) tile[f * cp + g] = Ci[e];
  }
  for (int f = lane; f < nb; f += 32) bs[f] = dY[static_cast<size_t>(i) * nb + f];
  __syncwarp();

  float quad, half_logdet;
  tiny_chol_sweep(tile, bs, nb, cp, lane, quad, half_logdet);
  if (lane == 0) {
    quad_out[i] = quad;
    half_logdet_out[i] = half_logdet;
  }
}

}  // namespace

// dY (B, nb) and C (B, nb, nb), row-major; quad and half_logdet (B,).
extern "C" int tiny_mvn_f32(const float* dY, const float* C, float* quad, float* half_logdet,
                            int B, int nb, void* stream) {
  if (nb < 1 || nb > kMaxNb || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kWarps * (nb * (nb | 1) + nb);  // <= 38,400 bytes
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiny_mvn_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, smem, s>>>(dY, C, quad, half_logdet, nb, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
