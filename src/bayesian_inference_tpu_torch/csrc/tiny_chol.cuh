// One warp's column sweep over a small SPD matrix in shared memory: the
// right-looking Cholesky factorisation fused with the forward substitution of
// a right-hand side and the log-determinant.
//
// Used by the tiny-MVN kernel (tiny_mvn.cu, K4). On entry C holds the lower
// triangle of the n x n matrix with row pitch cp (odd, so the column reads of
// the lanes fall in different banks) and b holds the right-hand side; both
// are overwritten. Lanes own rows; every column step is a warp barrier.
//
// On return, on every lane: quad = |L^{-1} b|^2 and half_logdet = sum log
// diag L, with C = L L^T. A pivot that is not positive gives NaN in both, and
// in nothing else. Plain fp32 FMA in a fixed order: repeated runs are
// bit-equal.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void tiny_chol_sweep(float* C, float* b, int n, int cp, int lane,
                                                float& quad, float& half_logdet) {
  quad = 0.f;
  half_logdet = 0.f;
  for (int j = 0; j < n; ++j) {
    const float pivot = C[j * cp + j];
    const float d = pivot > 0.f ? sqrtf(pivot) : __int_as_float(0x7fc00000);
    const float inv = 1.f / d;
    const float yj = b[j] * inv;
    quad = fmaf(yj, yj, quad);
    half_logdet += logf(d);
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float l = C[i * cp + j] * inv;
      C[i * cp + j] = l;
      b[i] = fmaf(-l, yj, b[i]);
    }
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float li = C[i * cp + j];
      for (int c = j + 1; c <= i; ++c) C[i * cp + c] = fmaf(-li, C[c * cp + j], C[i * cp + c]);
    }
    __syncwarp();
  }
}
