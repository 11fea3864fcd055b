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
// single factorisation (ops/mvn.py::woodbury_loglike).
//
// What bounds it on this card: not the bytes (the lower triangle of C and dY:
// 0.18 MB at B = 50, 5.4 MB at B = 1,500, nb = 41: 0.05 and 1.6 us) but one
// instance's chain of dependent steps.
//
// Design: one thread block per instance and one 4 x 4 register tile per
// thread (tile_chol.cuh). C is padded with the identity to 4T x 4T, with T
// the smallest of 4, 8, 12, 16 tiles that holds nb; dY is one more tile row
// below it (the augmented matrix [C; dY^T]), zero-padded. The right-looking
// tiled factorisation of the augmented matrix leaves L^{-1} dY in that row,
// so the factorisation and the forward solve are one sweep of T steps, two
// block barriers each: the owners of a tile column factor the pivot tile and
// publish the column of L, then every tile to the right takes a rank-4
// update (64 register FMAs). Only the lower tiles have threads
// (column-major, so the tiles that still work at step K are the block's
// last threads): 90 tiles in 3 warps at nb = 41, 152 in 5 warps at
// nb = 64. The per-tile partial sums are added in a fixed order by one
// thread. At B = 50 the instances sit on 50 SMs and one instance's latency
// is the time; at B = 1,500 the launch bounds hold a thread to 56 registers
// so that 12 blocks of 3 warps share an SM and the batch runs in one wave
// (12 x 132 = 1,584 blocks).
//
// A pivot that is not positive gives NaN in that instance only. Plain fp32
// FMA in a fixed order: repeated runs are bit-equal.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile_chol.cuh"

namespace {

constexpr int kMaxNb = 64;

template <int T>
constexpr int threads() { return (tile_chol::n_tiles<T, T + 1>() + 31) / 32 * 32; }

template <int T>
__global__ void __launch_bounds__(threads<T>(), T <= 12 ? 12 : 7)
tiny_mvn_kernel(const float* __restrict__ dY, const float* __restrict__ C, float* __restrict__ quad_out,
                float* __restrict__ half_logdet_out, int nb, bool vec) {
  __shared__ __align__(16) float pub[2 * 16 * (T + 1)];
  __shared__ float part[2 * T];  // per tile: quad, then log-determinant

  int I, J;
  tile_chol::tile_of<T, T + 1>(threadIdx.x, I, J);
  const size_t inst = blockIdx.x;

  float a[4][4];
  if (I < 0) {
    // no tile
  } else if (I < T) {
    tile_chol::load_tile(C + inst * nb * nb, nb, I, J, vec, a);
  } else {  // the right-hand side, as row 4T of the augmented matrix
    const float* b = dY + inst * nb;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * J + c;
      a[0][c] = k < nb ? __ldg(b + k) : 0.f;
    }
#pragma unroll
    for (int r = 1; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
  }
  tile_chol::factor<T, T + 1>(a, I, J, pub);

  if (I == T) {
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) q = fmaf(a[0][c], a[0][c], q);
    part[J] = q;
  } else if (I == J) {
    float h = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) h += logf(a[c][c]);
    part[T + J] = h;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float q = 0.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      q += part[j];
      h += part[T + j];
    }
    quad_out[inst] = q;
    half_logdet_out[inst] = h;
  }
}

template <int T>
void launch(const float* dY, const float* C, float* quad, float* half_logdet, int B, int nb, bool vec,
            cudaStream_t s) {
  tiny_mvn_kernel<T><<<B, threads<T>(), 0, s>>>(dY, C, quad, half_logdet, nb, vec);
}

}  // namespace

// dY (B, nb) and C (B, nb, nb), row-major; quad and half_logdet (B,).
extern "C" int tiny_mvn_f32(const float* dY, const float* C, float* quad, float* half_logdet,
                            int B, int nb, void* stream) {
  if (nb < 1 || nb > kMaxNb || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = nb % 4 == 0 && reinterpret_cast<std::uintptr_t>(C) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb <= 16) {
    launch<4>(dY, C, quad, half_logdet, B, nb, vec, s);
  } else if (nb <= 32) {
    launch<8>(dY, C, quad, half_logdet, B, nb, vec, s);
  } else if (nb <= 48) {
    launch<12>(dY, C, quad, half_logdet, B, nb, vec, s);
  } else {
    launch<16>(dY, C, quad, half_logdet, B, nb, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
