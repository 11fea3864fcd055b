// Right-looking Cholesky factorisation of one small SPD matrix over a grid of
// 4 x 4 register tiles, one tile per thread, two block barriers per tile
// column. Shared by K3 (diag_chol_inv.cu) and K4 (tiny_mvn.cu).
//
// The matrix is padded to 4T x 4T (identity on the pad) and cut into T x T
// tiles. Tile rows may run past T (ROWS = T + 1 in K4, whose extra tile row
// holds the right-hand side as a row of the augmented matrix, so that the
// factorisation also yields L^{-1} b). Only the lower tiles (J <= I) exist:
// thread t holds the t-th of them in column-major order (tile_of), so the
// tiles that still work at step K (J >= K) are the last threads of the
// block, and whole warps fall idle as the factorisation moves right.
//
// Tile step K, in two phases with a block barrier before each:
//   - the owners of tile column K (consecutive threads, about one warp) read
//     the published column of A, factor the 4 x 4 pivot tile A_KK each in
//     registers (so that no third barrier is needed), turn their tile A_IK
//     into L_IK = A_IK L_KK^{-T} and publish it;
//   - the owners of tiles (I, J), K < J <= I, read the rows of L_IK and L_JK
//     and apply the rank-4 update A_IJ -= L_IK L_JK^T (64 register FMAs);
//     the owners of tile column K + 1 then publish their tiles of A.
// Most threads do nothing but the update, which keeps each step's
// instructions few.
// Each entry sees the operations of the column-by-column sweep in the same
// order (scale by the reciprocal pivot, then one FMA per earlier column,
// columns in order). The pivot's reciprocal is rsqrtf (one MUFU operation,
// not the dozens of instructions of an IEEE square root and division on
// the chain of every step); d = p * rsqrt(p).
//
// A pivot that is not positive (or not finite) gives NaN (rsqrt of a
// negative number is NaN; of 0, inf, and 0 * inf is NaN), which spreads to
// every later entry of that matrix and to nothing else. Plain fp32 FMA in a
// fixed order: repeated runs are bit-equal.

#pragma once

#include <cuda_runtime.h>

namespace tile_chol {

// The number of lower tiles of a ROWS x T tile grid.
template <int T, int ROWS>
constexpr int n_tiles() { return T * ROWS - T * (T - 1) / 2; }

// The tile (I, J) of thread tid, in column-major order over the lower tiles;
// a thread past the last tile gets I = -1, J = 0 (no tile: J > I).
template <int T, int ROWS>
__device__ __forceinline__ void tile_of(int tid, int& I, int& J) {
  J = 0;
#pragma unroll 1
  while (J < T && tid >= ROWS - J) {
    tid -= ROWS - J;
    ++J;
  }
  I = J < T ? J + tid : -1;
  if (J == T) J = 0;
}

// Float offset of row rho of tile row I in a published tile column of A or
// of L ([rho][I][4]: lanes reading consecutive tile rows hit consecutive
// 16-byte words, so the float4 reads are conflict-free).
template <int ROWS>
__device__ __forceinline__ int pub_offset(int rho, int I) { return (rho * ROWS + I) * 4; }

template <int ROWS>
__device__ __forceinline__ float4 pub_row(const float* P, int rho, int I) {
  return *reinterpret_cast<const float4*>(P + pub_offset<ROWS>(rho, I));
}

template <int ROWS>
__device__ __forceinline__ void publish(float* P, int I, const float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(P + pub_offset<ROWS>(r, I)) = make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
}

__device__ __forceinline__ void unpack(float4 v, float (&x)[4]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// In place: the lower part of l becomes the Cholesky factor of the tile,
// inv its reciprocal pivots.
__device__ __forceinline__ void chol4(float (&l)[4][4], float (&inv)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float p = l[c][c];
    inv[c] = rsqrtf(p);
    l[c][c] = p * inv[c];
#pragma unroll
    for (int r = c + 1; r < 4; ++r) l[r][c] *= inv[c];
#pragma unroll
    for (int r = c + 1; r < 4; ++r)
#pragma unroll
      for (int s = c + 1; s <= r; ++s) l[r][s] = fmaf(-l[r][c], l[s][c], l[r][s]);
  }
}

// One row x of A_IK becomes the same row of L_IK = A_IK L_KK^{-T}.
__device__ __forceinline__ void trsm_row(float (&x)[4], const float (&l)[4][4], const float (&inv)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] *= inv[c];
#pragma unroll
    for (int c2 = c + 1; c2 < 4; ++c2) x[c2] = fmaf(-x[c], l[c2][c], x[c2]);
  }
}

// a -= x y^T for the rows x of L_IK and the rows y of L_JK, read from the
// published column of L.
template <int ROWS>
__device__ __forceinline__ void rank4_update(float (&a)[4][4], const float* P, int I, int J) {
  float x[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) unpack(pub_row<ROWS>(P, r, I), x[r]);
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // row s of L_JK, one at a time
    float y[4];
    unpack(pub_row<ROWS>(P, s, J), y);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][s] = fmaf(-x[r][c], y[c], a[r][s]);
  }
}

// Factor in place. On entry thread (I, J) holds tile (I, J) of the padded
// matrix in a (J <= I; a thread with no tile passes anything). On return a
// holds L_IJ, with zeros above the diagonal of a diagonal tile. P is
// 2 * 16 * ROWS floats of 16-byte-aligned shared memory: a column of A,
// then a column of L. Every thread of the block must call it (2T barriers).
template <int T, int ROWS>
__device__ __forceinline__ void factor(float (&a)[4][4], int I, int J, float* P) {
  float* pl = P + 16 * ROWS;
  const bool lower = J <= I;
  if (lower && J == 0) publish<ROWS>(P, I, a);
  // Not unrolled: one step's code (registers indexed at compile time, K only
  // in addresses and comparisons) stays in the instruction cache.
#pragma unroll 1
  for (int K = 0; K < T; ++K) {
    __syncthreads();  // tile column K of A is published
    if (lower && J == K) {
      float l[4][4], inv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) unpack(pub_row<ROWS>(P, r, K), l[r]);
      chol4(l, inv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (I == K) {
#pragma unroll
          for (int c = 0; c < 4; ++c) a[r][c] = c <= r ? l[r][c] : 0.f;
        } else {
          trsm_row(a[r], l, inv);
        }
      }
      publish<ROWS>(pl, I, a);
    }
    __syncthreads();  // tile column K of L is published
    if (lower && J > K) {
      rank4_update<ROWS>(a, pl, I, J);
      if (J == K + 1) publish<ROWS>(P, I, a);
    }
  }
}

// Tile (I, J) of a row-major n x n matrix at src, padded to 4T with the
// identity: 16-byte loads where vec (n % 4 == 0, src 16-byte aligned).
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int n, int I, int J, bool vec,
                                          float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * I + r;
    if (vec && i < n && 4 * J < n) {
      unpack(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(i) * n + 4 * J)), a[r]);
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * J + c;
      a[r][c] = (i < n && k < n) ? __ldg(src + static_cast<size_t>(i) * n + k) : (i == k ? 1.f : 0.f);
    }
  }
}

// Tile (I, J) of a row-major n x n output (the part inside n x n).
__device__ __forceinline__ void store_tile(float* __restrict__ dst, int n, int I, int J, bool vec,
                                           const float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * I + r;
    if (i >= n || 4 * J >= n) continue;
    if (vec) {
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(i) * n + 4 * J) =
          make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * J + c < n) dst[static_cast<size_t>(i) * n + 4 * J + c] = a[r][c];
  }
}

}  // namespace tile_chol
