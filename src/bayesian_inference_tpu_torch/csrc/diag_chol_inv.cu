// Batched Cholesky factor and its inverse for small SPD blocks (n <= 64).
//
// Replaces bayesian_inference_tpu/ops/blocked_cholesky.py::_diag_chol_inv_kernel
// (the Pallas kernel that factorises the NB x NB diagonal blocks of the GP-fit
// Gram matrices with the instance batch on the TPU's 128 lanes). Here each
// instance is one thread block: a Gram block is only 16 KB, so it lives in
// shared memory for the whole factorisation and nothing but the input and the
// two outputs touches device memory.
//
// What bounds it: the column recurrence is serial (a barrier per column step),
// and each step is a rank-1 update of the trailing block read from and written
// to shared memory; the flops (n^3/3 + n^3/6) are small. The batch (41 PCs x
// 51 restarts = 2,091 blocks in the fit's exploration stage) fills the card's
// 132 SMs many times over, which hides the barrier latency across blocks.
//
// Algorithm, per instance:
//   for j: d = sqrt(A[j][j]); L[i][j] = A[i][j] / d (i > j); A[i][k] -= L[i][j] L[k][j]
//   then X = L^{-1} by forward substitution of the identity, one thread per
//   right-hand-side column.
// A pivot that is not positive (or not finite) yields NaN, never garbage: the
// GP fit turns a non-finite log marginal likelihood into +inf.
// Outputs are row-major (batch, n, n); entries above the diagonal are 0.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kPitch = kMaxN + 1;  // odd row pitch: column reads avoid bank conflicts
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
diag_chol_inv_kernel(const float* __restrict__ A, float* __restrict__ L,
                     float* __restrict__ Linv, int n) {
  __shared__ float a[kMaxN * kPitch];
  __shared__ float x[kMaxN * kPitch];
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * n; e += kThreads) a[(e / n) * kPitch + e % n] = A[base + e];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float pivot = a[j * kPitch + j];
    const float d = pivot > 0.f ? sqrtf(pivot) : __int_as_float(0x7fc00000);
    const float inv = 1.f / d;
    __syncthreads();  // every thread has read the pivot before it is overwritten
    for (int i = j + tid; i < n; i += kThreads) {
      a[i * kPitch + j] = (i == j) ? d : a[i * kPitch + j] * inv;
    }
    __syncthreads();
    const int m = n - j - 1;  // trailing block, lower triangle only
    for (int e = tid; e < m * m; e += kThreads) {
      const int i = j + 1 + e / m;
      const int k = j + 1 + e % m;
      if (k <= i) a[i * kPitch + k] -= a[i * kPitch + j] * a[k * kPitch + j];
    }
    __syncthreads();
  }

  if (tid < n) {  // L X = I, column c of X by forward substitution
    const int c = tid;
    for (int i = 0; i < c; ++i) x[i * kPitch + c] = 0.f;
    for (int i = c; i < n; ++i) {
      float s = (i == c) ? 1.f : 0.f;
      for (int k = c; k < i; ++k) s -= a[i * kPitch + k] * x[k * kPitch + c];
      x[i * kPitch + c] = s / a[i * kPitch + i];
    }
  }
  __syncthreads();

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, k = e % n;
    L[base + e] = k <= i ? a[i * kPitch + k] : 0.f;
    Linv[base + e] = k <= i ? x[i * kPitch + k] : 0.f;
  }
}

}  // namespace

extern "C" int diag_chol_inv_f32(const float* A, float* L, float* Linv, int batch, int n,
                                 void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  diag_chol_inv_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, L, Linv, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
