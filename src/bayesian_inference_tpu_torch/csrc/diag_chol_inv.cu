// Batched Cholesky factor and its inverse for small SPD blocks (n <= 64).
//
// Replaces bayesian_inference_tpu/ops/blocked_cholesky.py::_diag_chol_inv_kernel
// (the Pallas kernel that factorises the NB x NB diagonal blocks of the GP-fit
// Gram matrices with the instance batch on the TPU's 128 lanes, then solves
// L X = I for all right-hand sides at once, one row per step).
//
// What bounds it on this card: at the fit's exploration batch (2,091 blocks
// of 64 x 64) the bytes, 40 KB per instance (read A's lower triangle, write L
// and L^-1), about 26 us for the batch at 3.35 TB/s; at the polish and posterior batches (123
// and 41 blocks, and 5 to 75 in cross-validation), fewer instances than the
// card has SMs, the latency of one instance, which is set by its chain of
// dependent steps and barriers.
//
// Design: one thread block per instance, one 4 x 4 register tile of the
// (identity-padded) 64 x 64 matrix per thread, only the 136 lower tiles
// (J <= I), in column-major order: 136 threads in 5 warps.
//   1. A is read with 16-byte loads straight into the tiles (the upper half
//      is not read).
//   2. Factorisation (tile_chol.cuh): right-looking over the 16 tile columns,
//      two barriers each; the owners of the tile column factor the pivot
//      tile and publish the column of L, then every tile to the right takes
//      a rank-4 update in registers (64 FMAs). The working tiles are the last
//      threads, so whole warps drop out as it goes.
//   3. L goes out with 16-byte stores from the registers (each off-diagonal
//      tile also writes the zeros of its mirror tile above the diagonal), and
//      into shared memory for step 4.
//   4. L X = I by block rows, the JAX kernel's right-looking form with 4 rows
//      per step: the owners of tile row S solve their 4 x 4 diagonal system,
//      publish the 4 finished rows of X and store them; after one barrier
//      every tile below takes a rank-4 update (64 register FMAs).
// 48 block barriers in all. One configuration serves both regimes: 32 short
// tile steps for one instance's latency (B <= 132), and small blocks (5
// warps, 64 registers a thread, 21 KB of shared memory), 6 of which share an
// SM, at the large batch.
//
// A pivot that is not positive (or not finite) yields NaN in that instance
// only: the GP fit turns a non-finite log marginal likelihood into +inf.
// Outputs are row-major (batch, n, n); entries above the diagonal are 0.

#include <cstdint>

#include <cuda_runtime.h>

#include "tile_chol.cuh"

namespace {

constexpr int kMaxN = 64;
constexpr int kT = kMaxN / 4;         // tiles per side
constexpr int kThreads = (tile_chol::n_tiles<kT, kT>() + 31) / 32 * 32;  // 160 for 136 tiles

// Row r of tile (I, J) of L in shared memory, [r][J][I]: the lanes of a warp
// hold consecutive tile rows of one tile column, so their float4 reads of
// one tile column of L hit consecutive 16-byte words.
__device__ __forceinline__ int l_index(int r, int I, int J) { return (r * kT + J) * kT + I; }

__global__ void __launch_bounds__(kThreads, 6)
diag_chol_inv_kernel(const float* __restrict__ A, float* __restrict__ L, float* __restrict__ Linv, int n,
                     bool vec) {
  __shared__ __align__(16) float pub[2 * 16 * kT];     // published tile column
  __shared__ float4 ls[4 * kT * kT];                  // L
  __shared__ __align__(16) float ys[2 * 4 * kMaxN];    // published rows of X
  __shared__ float inv_diag[kMaxN];

  int I, J;
  tile_chol::tile_of<kT, kT>(threadIdx.x, I, J);
  const bool lower = J <= I;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  float a[4][4];
  if (lower) tile_chol::load_tile(A + base, n, I, J, vec, a);
  tile_chol::factor<kT, kT>(a, I, J, pub);

  const float zero[4][4] = {};
  if (lower) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ls[l_index(r, I, J)] = make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
    if (I == J) {
#pragma unroll
      for (int r = 0; r < 4; ++r) inv_diag[4 * I + r] = 1.f / a[r][r];
    }
    tile_chol::store_tile(L + base, n, I, J, vec, a);
    if (J < I) {  // the mirror tile above the diagonal
      tile_chol::store_tile(L + base, n, J, I, vec, zero);
      tile_chol::store_tile(Linv + base, n, J, I, vec, zero);
    }
  }
  __syncthreads();

  // R = I; at step S: X_SJ = L_SS^{-1} R_SJ, then R_IJ -= L_IS X_SJ (I > S).
  float x[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[r][c] = (I == J && r == c) ? 1.f : 0.f;
#pragma unroll 1  // as the factorisation's loop (tile_chol.cuh)
  for (int S = 0; S < kT; ++S) {
    float* y = ys + (S & 1) * 4 * kMaxN;
    if (I == S && lower) {
      float l[4][4], inv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tile_chol::unpack(ls[l_index(r, S, S)], l[r]);
        inv[r] = inv_diag[4 * S + r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) x[r][c] *= inv[r];
#pragma unroll
        for (int r2 = r + 1; r2 < 4; ++r2)
#pragma unroll
          for (int c = 0; c < 4; ++c) x[r2][c] = fmaf(-l[r2][r], x[r][c], x[r2][c]);
        *reinterpret_cast<float4*>(y + r * kMaxN + 4 * J) = make_float4(x[r][0], x[r][1], x[r][2], x[r][3]);
      }
      if (I == J) {  // the diagonal tile of X is lower triangular
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = r + 1; c < 4; ++c) x[r][c] = 0.f;
      }
      tile_chol::store_tile(Linv + base, n, I, J, vec, x);
    }
    if (S == kT - 1) break;
    __syncthreads();  // rows 4S..4S+3 of X are published
    if (I > S && J <= S) {
      float l[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tile_chol::unpack(ls[l_index(r, I, S)], l[r]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float ysj[4];
        tile_chol::unpack(*reinterpret_cast<const float4*>(y + s * kMaxN + 4 * J), ysj);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) x[r][c] = fmaf(-l[r][s], ysj[c], x[r][c]);
      }
    }
  }
}

}  // namespace

extern "C" int diag_chol_inv_f32(const float* A, float* L, float* Linv, int batch, int n, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const bool vec = n % 4 == 0 && (reinterpret_cast<std::uintptr_t>(A) | reinterpret_cast<std::uintptr_t>(L) |
                                  reinterpret_cast<std::uintptr_t>(Linv)) % 16 == 0;
  diag_chol_inv_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, L, Linv, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
