// Fused block-MVN log-likelihood of the MCMC likelihood's observable blocks.
//
// Replaces bayesian_inference_tpu/ops/pallas_mvn.py::_fused_kernel_packed (and
// computes the same function as its W > 64 sibling _fused_kernel). For every
// walker w and every observable block o of one width bucket:
//
//   b = d0[o] + U[o] z[w]                       (nb)
//   C = D[o] + U[o] diag(v[w]) U[o]^T           (nb x nb)
//   ll[o, w] = -1/2 |L^{-1} b|^2 - sum(log diag L),   C = L L^T
//
// and out[w] = sum_o ll[o, w]. No (W, n_obs, nb, nb) covariance ever reaches
// device memory: a thread block stages one observable block's U, D and d0 in
// shared memory once, and each of its warps owns one walker, assembling b and
// the lower triangle of C in its own shared-memory tile (at most 48 x 49
// floats) and factorising it with the lanes over rows (right-looking rank-1
// downdates fused with the forward substitution and the log-determinant).
// Padded rows of a bucket carry D = I, U = 0, d0 = 0 and contribute 0.
//
// What bounds it: the assembly's ~nb^2 k / 2 fused multiply-adds per
// (walker, block) and the factorisation's serial column steps (a warp barrier
// each). Plain fp32 FMA throughout, in a fixed order.
//
// The sum over blocks is deterministic, without atomics: the first kernel
// writes a (n_obs, W) buffer and a second kernel sums it per walker in block
// order, so repeated runs give bit-equal log-probabilities.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // walkers per thread block
constexpr int kMaxNb = 48;

__global__ void __launch_bounds__(kWarps * 32)
fused_block_mvn_kernel(const float* __restrict__ U, const float* __restrict__ D,
                       const float* __restrict__ d0, const float* __restrict__ z,
                       const float* __restrict__ v, float* __restrict__ ll_blk,
                       int nb, int k, int W) {
  extern __shared__ float smem[];
  const int kp = k | 1;   // odd pitches keep strided shared reads conflict-light
  const int cp = nb | 1;
  float* U_s = smem;                 // nb x kp
  float* D_s = U_s + nb * kp;        // nb x cp
  float* d0_s = D_s + nb * cp;       // nb
  float* warp_tiles = d0_s + nb;
  const int per_warp = 2 * k + nb + nb * cp;

  const int o = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int w = blockIdx.y * kWarps + warp;

  const float* Uo = U + static_cast<size_t>(o) * nb * k;
  const float* Do = D + static_cast<size_t>(o) * nb * nb;
  for (int e = tid; e < nb * k; e += kWarps * 32) U_s[(e / k) * kp + e % k] = Uo[e];
  for (int e = tid; e < nb * nb; e += kWarps * 32) D_s[(e / nb) * cp + e % nb] = Do[e];
  for (int e = tid; e < nb; e += kWarps * 32) d0_s[e] = d0[static_cast<size_t>(o) * nb + e];

  float* zs = warp_tiles + warp * per_warp;
  float* vs = zs + k;
  float* bs = vs + k;
  float* C = bs + nb;
  if (w < W) {
    for (int e = lane; e < k; e += 32) {
      zs[e] = z[static_cast<size_t>(w) * k + e];
      vs[e] = v[static_cast<size_t>(w) * k + e];
    }
  }
  __syncthreads();
  if (w >= W) return;  // no block-wide barrier below this point

  // Assembly: residual and the lower triangle of the covariance.
  for (int f = lane; f < nb; f += 32) {
    float acc = d0_s[f];
    for (int q = 0; q < k; ++q) acc = fmaf(U_s[f * kp + q], zs[q], acc);
    bs[f] = acc;
  }
  for (int e = lane; e < nb * nb; e += 32) {
    const int f = e / nb, g = e % nb;
    if (g > f) continue;
    float acc = D_s[f * cp + g];
    for (int q = 0; q < k; ++q) acc = fmaf(U_s[f * kp + q] * vs[q], U_s[g * kp + q], acc);
    C[f * cp + g] = acc;
  }
  __syncwarp();

  // Cholesky fused with forward substitution and log-determinant.
  float quad = 0.f, half_logdet = 0.f;
  for (int j = 0; j < nb; ++j) {
    const float pivot = C[j * cp + j];
    const float d = pivot > 0.f ? sqrtf(pivot) : __int_as_float(0x7fc00000);
    const float inv = 1.f / d;
    const float yj = bs[j] * inv;
    quad = fmaf(yj, yj, quad);
    half_logdet += logf(d);
    for (int i = j + 1 + lane; i < nb; i += 32) {
      const float l = C[i * cp + j] * inv;
      C[i * cp + j] = l;
      bs[i] = fmaf(-l, yj, bs[i]);
    }
    __syncwarp();
    for (int i = j + 1 + lane; i < nb; i += 32) {
      const float li = C[i * cp + j];
      for (int c = j + 1; c <= i; ++c) C[i * cp + c] = fmaf(-li, C[c * cp + j], C[i * cp + c]);
    }
    __syncwarp();
  }
  if (lane == 0) ll_blk[static_cast<size_t>(o) * W + w] = -0.5f * quad - half_logdet;
}

__global__ void sum_over_blocks_kernel(const float* __restrict__ ll_blk, float* __restrict__ out,
                                       int n_obs, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float acc = 0.f;
  for (int o = 0; o < n_obs; ++o) acc += ll_blk[static_cast<size_t>(o) * W + w];
  out[w] = acc;
}

}  // namespace

extern "C" int fused_block_mvn_f32(const float* U, const float* D, const float* d0,
                                   const float* z, const float* v, float* ll_blk, float* out,
                                   int n_obs, int nb, int k, int W, void* stream) {
  if (nb < 1 || nb > kMaxNb || k < 1 || n_obs < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kp = k | 1, cp = nb | 1;
  const size_t smem = sizeof(float) * (nb * kp + nb * cp + nb + kWarps * (2 * k + nb + nb * cp));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_mvn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_obs, (W + kWarps - 1) / kWarps);
  fused_block_mvn_kernel<<<grid, kWarps * 32, smem, s>>>(U, D, d0, z, v, ll_blk, nb, k, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_over_blocks_kernel<<<(W + 127) / 128, 128, 0, s>>>(ll_blk, out, n_obs, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
