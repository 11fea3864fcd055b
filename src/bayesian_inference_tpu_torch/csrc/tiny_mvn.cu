// Batched tiny-MVN terms of given residuals and covariances, and the whole
// Woodbury log-likelihood of the lowrank mode from one launch.
//
// Replaces bayesian_inference_tpu/ops/pallas_mvn.py::_mvn_kernel (reached
// through _block_mvn_pallas <- block_mvn_loglike). For every instance i of
// the batch, with C[i] = L L^T:
//
//   quad[i]        = |L^{-1} dY[i]|^2
//   half_logdet[i] = sum log diag L
//
// so that the MVN log-likelihood is -quad/2 - half_logdet (block_mvn_loglike,
// entry tiny_mvn_f32).
//
// The Woodbury entry (tiny_mvn_woodbury_f32) is the same sweep with its
// operands built in the block instead of read: for walker i with PC-space
// means z and variances v (ops/mvn.py::woodbury_loglike),
//
//   M = G + diag(1/v),  r = b + z G,
//   loglike = quad/2 - half_logdet - rest/2,
//   rest    = c0 + 2 b.z + zG.z + 2 half_logdet_D + sum log v,
//
// with (quad, half_logdet) those of (r, M). G (k x k) is shared by every
// instance; b and c0 are shared too, or one row per group of ``per_row``
// consecutive instances (the closure batch's points). The JAX package makes
// this a chain of small XLA operations around two calls of its kernel; here
// the chain's ~23 kernels per evaluation are one launch.
//
// What bounds it on this card: not the bytes (the lower triangle of C and dY:
// 0.18 MB at B = 50, 5.4 MB at B = 1,500, nb = 41: 0.05 and 1.6 us; the
// Woodbury entry reads only z and v per instance) but one instance's chain
// of dependent steps.
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
// The Woodbury entry's prologue loads each thread's tile of G as K4 loads
// its tile of C (G is the same for every instance, so the loads hit the
// cache), stages z in shared memory, and has every tile of G publish its
// share of zG (by symmetry an off-diagonal tile gives two); after a second
// barrier the owner of tile (T, J) of the augmented row adds the shares of
// its four columns in tile-row order, forms r = b + zG and its columns'
// terms of b.z, zG.z and sum log v, while the diagonal tiles add 1/v to
// become M. Staging all of G in shared memory instead cost 4.7 us of a
// 13.5 us launch at B = 50, k = 41 on an H100 (its loads ran one after
// another). The
// epilogue adds the per-tile terms in tile order, as it adds quad and
// half_logdet, and combines them in the order of the plain version.
//
// A pivot that is not positive gives NaN in that instance only. Plain fp32
// FMA in a fixed order: repeated runs are bit-equal.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "tile_chol.cuh"

namespace {

constexpr int kMaxNb = 64;

// Threads of a block of T x T tiles: one per lower tile of the augmented
// matrix, in whole warps. A constant, not a function: device code reads it.
template <int T>
constexpr int kThreads = (tile_chol::n_tiles<T, T + 1>() + 31) / 32 * 32;

// The standalone entry's operands: residuals dY (B, nb) and covariances C
// (B, nb, nb) given; quad and half_logdet written.
struct Given {
  const float* dY;
  const float* C;
  float* quad;
  float* half_logdet;
  int nb;
  bool vec;
};

// The Woodbury entry's operands: z, v (B, k); G (k, k); b (rows, k) and c0
// (rows,), row = instance / per_row; half_logdet_D a scalar; loglike written.
struct Woodbury {
  const float* z;
  const float* v;
  const float* G;
  const float* b;
  const float* c0;
  const float* half_logdet_D;
  float* loglike;
  int k;
  int per_row;
  bool vec;  // 16-byte loads of G
};

// Per tile, the partial sums the epilogue adds: quad and the log-determinant,
// and for the Woodbury entry b.z, zG.z and sum log v.
template <class Op>
constexpr int kParts = std::is_same<Op, Woodbury>::value ? 5 : 2;

// Thread (I, J)'s tile of the augmented matrix [C; dY^T].
template <int T>
__device__ __forceinline__ void assemble(const Given& op, size_t inst, int I, int J, float (&a)[4][4], float*) {
  const int nb = op.nb;
  if (I < 0) {
    // no tile
  } else if (I < T) {
    tile_chol::load_tile(op.C + inst * nb * nb, nb, I, J, op.vec, a);
  } else {  // the right-hand side, as row 4T of the augmented matrix
    const float* b = op.dY + inst * nb;
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
}

// Thread (I, J)'s tile of the augmented matrix [M; r^T], built from z, v, G
// and b; the owners of the r row also leave their columns' terms of the rest
// in part[2T + J], part[3T + J], part[4T + J]. Every thread must call it
// (two block barriers).
template <int T>
__device__ __forceinline__ void assemble(const Woodbury& op, size_t inst, int I, int J, float (&a)[4][4],
                                         float* part) {
  constexpr int n = 4 * T;
  __shared__ float zs[n];          // z, zero-padded
  __shared__ float shares[T * n];  // [I][j]: tile row I's share of (zG)_j
  const int k = op.k, tid = static_cast<int>(threadIdx.x);
  const float* v = op.v + inst * k;
  const float* b = op.b + static_cast<unsigned>(inst) / op.per_row * k;
  if (tid < n) zs[tid] = tid < k ? __ldg(op.z + inst * k + tid) : 0.f;
  // Every load before the first barrier: this thread's tile of G (padded
  // with the identity, as K4 pads C) and, on the diagonal, its v; on the r
  // row, its columns of b and v.
  float w[4], bj[4];
  if (I >= 0 && I < T) tile_chol::load_tile(op.G, k, I, J, op.vec, a);
  const int j0 = 4 * (I == T ? J : I);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool in = (I == J || I == T) && j0 + c < k;
    w[c] = in ? __ldg(v + j0 + c) : 1.f;
    bj[c] = in && I == T ? __ldg(b + j0 + c) : 0.f;
  }
  __syncthreads();  // z is staged

  if (I >= 0 && I < T) {
    // zG's shares from this tile of G: tile row I's to the columns of J and,
    // by symmetry (tile (J, I) = tile (I, J)^T), tile row J's to the columns
    // of I; each a four-term FMA chain in order.
    float zi[4], zj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      zi[c] = zs[4 * I + c];
      zj[c] = zs[4 * J + c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) p = fmaf(zi[r], a[r][c], p);
      shares[I * n + 4 * J + c] = p;
    }
    if (I > J) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) p = fmaf(zj[c], a[r][c], p);
        shares[J * n + 4 * I + r] = p;
      }
    }
    if (I == J) {  // M = G + diag(1/v)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * I + r < k) a[r][r] += 1.f / w[r];
    }
  }
  __syncthreads();  // zG's shares are published
  if (I != T) return;

  // The row r^T = (b + zG)^T below M, zG the shares added in tile-row order
  // (the pad adds exact zeros), and this tile's columns of b.z, zG.z, log v.
  float bz = 0.f, zgz = 0.f, logv = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = 4 * J + c;
    float zg = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) zg += shares[i * n + j];
    a[0][c] = bj[c] + zg;
    if (j < k) {
      bz = fmaf(bj[c], zs[j], bz);
      zgz = fmaf(zg, zs[j], zgz);
      logv += logf(w[c]);
    }
  }
#pragma unroll
  for (int r = 1; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
  part[2 * T + J] = bz;
  part[3 * T + J] = zgz;
  part[4 * T + J] = logv;
}

// Thread 0, after the sweep: the per-tile sums added in tile order, written.
template <int T>
__device__ __forceinline__ void finish(const Given& op, size_t inst, float q, float h, const float*) {
  op.quad[inst] = q;
  op.half_logdet[inst] = h;
}

template <int T>
__device__ __forceinline__ void finish(const Woodbury& op, size_t inst, float q, float h, const float* part) {
  float bz = 0.f, zgz = 0.f, logv = 0.f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    bz += part[2 * T + j];
    zgz += part[3 * T + j];
    logv += part[4 * T + j];
  }
  const float c0 = __ldg(op.c0 + static_cast<unsigned>(inst) / op.per_row);
  const float rest = c0 + 2.f * bz + zgz + 2.f * __ldg(op.half_logdet_D) + logv;
  op.loglike[inst] = 0.5f * q - h - 0.5f * rest;
}

template <int T, class Op>
__global__ void __launch_bounds__(kThreads<T>, T <= 12 ? 12 : 7) tiny_mvn_kernel(const Op op) {
  __shared__ __align__(16) float pub[2 * 16 * (T + 1)];
  __shared__ float part[kParts<Op> * T];  // per tile: quad, the log-determinant, then the Woodbury terms

  int I, J;
  tile_chol::tile_of<T, T + 1>(threadIdx.x, I, J);
  const size_t inst = blockIdx.x;

  float a[4][4];
  assemble<T>(op, inst, I, J, a, part);
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
    finish<T>(op, inst, q, h, part);
  }
}

// One launch over B instances of width n, with the tile count that holds n.
template <class Op>
int launch(const Op& op, int B, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) {
    tiny_mvn_kernel<4><<<B, kThreads<4>, 0, s>>>(op);
  } else if (n <= 32) {
    tiny_mvn_kernel<8><<<B, kThreads<8>, 0, s>>>(op);
  } else if (n <= 48) {
    tiny_mvn_kernel<12><<<B, kThreads<12>, 0, s>>>(op);
  } else {
    tiny_mvn_kernel<16><<<B, kThreads<16>, 0, s>>>(op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dY (B, nb) and C (B, nb, nb), row-major; quad and half_logdet (B,).
extern "C" int tiny_mvn_f32(const float* dY, const float* C, float* quad, float* half_logdet,
                            int B, int nb, void* stream) {
  if (nb < 1 || nb > kMaxNb || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = nb % 4 == 0 && reinterpret_cast<std::uintptr_t>(C) % 16 == 0;
  return launch(Given{dY, C, quad, half_logdet, nb, vec}, B, nb, stream);
}

// z, v (B, k); G (k, k); b (B / per_row, k) and c0 (B / per_row,), one row
// for every per_row consecutive instances (per_row = B: one shared row);
// half_logdet_D (); loglike (B,). All row-major float32.
extern "C" int tiny_mvn_woodbury_f32(const float* z, const float* v, const float* G, const float* b,
                                     const float* c0, const float* half_logdet_D, float* loglike, int B, int k,
                                     int per_row, void* stream) {
  if (k < 1 || k > kMaxNb || B < 1 || per_row < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 4 == 0 && reinterpret_cast<std::uintptr_t>(G) % 16 == 0;
  return launch(Woodbury{z, v, G, b, c0, half_logdet_D, loglike, k, per_row, vec}, B, k, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
