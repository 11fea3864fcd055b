// Fused GP predict of k stacked GPs on one design: cross-covariance, mean and
// variance in one launch, the cross-covariance never leaving the chip.
//
// Replaces the work XLA fuses around the sampler's likelihood in the JAX
// package: bayesian_inference_tpu/models/gp.py::predict_all_shared (no Pallas
// kernel there; a Pallas attempt lost to XLA's fusion on the TPU). On this
// card the same function, written as library and elementwise calls, is about
// fifteen launches per evaluation, and at the closure batch's B = 1,500 every
// (k, B, N) intermediate is a 48 MB round trip to device memory. For PC c,
// walker b and design point n:
//
//   w[c] = exp(-2 log_ls[c])                                   (d)
//   ks[c, b, n] = Matern_nu(sqrt(sum_q (theta[b, q] - X[n, q])^2 w[c, q] + 1e-36)) (+ exp(log_c[c]))
//   mean[b, c] = sum_n ks[c, b, n] alpha[c, n]
//   var[b, c] = max(prior_var[c] - ks[c, b]^T Kinv[c] ks[c, b], 0)     (NaN stays NaN)
//
// nu: 0 = RBF exp(-sq / 2), 1 = Matern 1/2, 3 = Matern 3/2, 5 = Matern 5/2
// (twice nu), as ops/gram.py::matern_from_sqdist. Distances come from direct
// differences, never from |a|^2 + |b|^2 - 2ab; every product and sum is
// plain FP32 (FFMA), no TF32.
//
// What bounds it: the variance's k B N^2 FMA (156 MFLOP at k = 41, B = 50,
// N = 195; 4.68 GFLOP at B = 1,500) against Kinv's k N^2 floats (6.24 MB):
// operations at B >= ~20, so 2.3 us at B = 50 and 70 us at B = 1,500 on an
// H100 SXM (67 TFLOP/s FP32). The design keeps Kinv's reads off the FMAs'
// path:
// - One thread block per (PC, walker tile of BT walkers). The block builds
//   its ks tile (N x BT, laid out [n][walker], rows padded by 4 floats so
//   that a column's walkers lie on distinct banks) in shared memory while
//   the first panels of Kinv[c] are already in flight.
// - Kinv[c] streams through shared memory in panels of kRows whole rows,
//   each one bulk copy (TMA, cp.async.bulk, completing on an mbarrier) of
//   the panel's contiguous floats from the 16-byte boundary below it, up to
//   kMaxStages panels in flight, so the copies cost the threads no
//   instructions and overlap the FMAs. Every block reads Kinv[c] once, from
//   L2 after the first block of the PC.
// - Each thread owns one column m of t = ks Kinv and accumulates it for the
//   tile's BT walkers in registers: per row one 4-byte shared load of Kinv
//   (consecutive across the warp) and BT / 4 16-byte broadcast loads of ks
//   feed BT FMAs. The block has as many warps as N needs (7 at N = 195), up
//   to 8, and loops over column chunks beyond 256.
// - Each panel's products are summed apart and then added to t, so that the
//   rounding error grows with N / kRows and not with N (at N = 700 the
//   row-by-row sum came to 2.04 times the plain f32 version's error).
// - The epilogue folds t . ks per walker into partial sums, reduced across
//   the warp by a shuffle butterfly and across warps in a fixed order, and so
//   does the mean ks . alpha, column by column after the row loop. No
//   atomics: repeated launches are bit-equal, and since the column of every
//   thread is the same at every BT, a walker's values do not depend on which
//   walkers share its tile or launch.
// - BT follows the batch so that the grid fills 132 SMs: 8 walkers per tile
//   up to B = 128 (287 blocks at B = 50, k = 41), 16 up to 512, 32 above
//   (1,927 blocks at B = 1,500). Walkers past B (the ragged tile) carry
//   ks = 0 and write nothing; rows past N are zero in shared memory,
//   columns past N are skipped.
// What it reaches (H100 80GB HBM3 at 700 W, chip_smoke.py): 30 us at B = 50
// and 0.42 ms at B = 1,500, 8-18 % of the bound. Where the rest goes is
// open: a 16-byte shared load of ks costs its warp four clocks even when
// every lane reads one address, so a row costs about 2 BT clocks of the
// shared pipe against BT / 4 of the FMA pipe, and the ks tile, the panels'
// waits and the epilogue are not small beside it. Forms tried on the way,
// all slower at one of the two batches: each thread one column with Kinv
// read from L2 row by row (24 us / 0.54 ms: the loads' latency), per-thread
// 4-byte copies of the panels into register tiles of 4-8 walkers x 2-4
// columns (42-58 us at B = 50), and 8 x 8 register tiles (64 us / 0.49 ms:
// one warp a block at B = 50, 139 registers).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxDim = 16;    // input dimensions the kernel takes
constexpr int kRows = 16;      // Kinv rows per panel
constexpr int kMaxStages = 4;  // panels in flight
constexpr size_t kMaxDynamicShared = 220 * 1024;

__device__ __forceinline__ float matern(float sq, int nu2) {
  if (nu2 == 0) return expf(-0.5f * sq);
  const float dist = sqrtf(sq + 1e-36f);
  if (nu2 == 1) return expf(-dist);
  if (nu2 == 3) {
    const float t = 1.7320508075688772f * dist;
    return (1.f + t) * expf(-t);
  }
  const float t = 2.23606797749979f * dist;
  return (1.f + t + t * t * (1.f / 3.f)) * expf(-t);
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A panel buffer's completion barrier: one arrival (the issuing thread's,
// with the bytes to expect) and the bulk copy's bytes complete a phase.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(bar)) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_address(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool barrier_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(shared_address(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(bytes), "r"(shared_address(bar))
               : "memory");
}

__host__ __device__ inline int padded_rows(int N) { return (N + kRows - 1) / kRows * kRows; }
// A panel buffer: kRows rows of N floats after up to 3 floats of lead, in 16-byte units.
__host__ __device__ inline int panel_floats(int N) { return (kRows * N + 3 + 3) / 4 * 4; }

template <int BT>
__global__ void __launch_bounds__(kMaxWarps * 32)
gp_predict_kernel(const float* __restrict__ theta, const float* __restrict__ X, const float* __restrict__ log_ls,
                  const float* __restrict__ log_c, const float* __restrict__ alpha, const float* __restrict__ Kinv,
                  const float* __restrict__ prior_var, float* __restrict__ mean, float* __restrict__ var, int B,
                  int N, int d, int k, int nu2, int with_constant, int stages) {
  constexpr int KS = BT + 4;  // ks row stride: the epilogue's 16-byte loads of a column fall on distinct banks
  extern __shared__ __align__(16) float smem[];
  const int n_pad = padded_rows(N), stride = panel_floats(N);
  float* ks = smem;                  // [n_pad][KS]
  float* panels = ks + n_pad * KS;   // stages x stride
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  __shared__ float w[kMaxDim];
  __shared__ float th[kMaxDim * BT];  // the tile's theta, [q][walker]: a warp's walkers on distinct banks
  __shared__ float red[kMaxWarps][2 * BT];  // per-warp sums of t . ks, then of ks . alpha

  const int c = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* Kc = Kinv + static_cast<size_t>(c) * N * N;
  const int n_panels = n_pad / kRows;

  // Panel p (rows [p kRows, p kRows + kRows) of Kinv[c], zero past N) into
  // buffer b: the bulk copy of its 16-byte-aligned body, the ragged tail
  // (at most 3 floats) and the zero rows by the threads. Element (r, m)
  // lands at buffer[lead(p) + r N + m].
  auto lead = [&](int p) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(Kc + static_cast<size_t>(p) * kRows * N) >> 2) & 3);
  };
  auto stage = [&](int p, int b) {
    const int n0 = p * kRows, rows = min(kRows, N - n0), l = lead(p);
    const float* from = Kc + static_cast<size_t>(n0) * N - l;
    const int total = l + rows * N, body = total & ~3;
    float* buf = panels + b * stride;
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the block's reads of this buffer
      barrier_expect(&bars[b], body * 4);
      if (body > 0) bulk_copy(buf, from, body * 4, &bars[b]);
    }
    for (int i = body + tid; i < total; i += nthreads) buf[i] = from[i];
    for (int i = total + tid; i < l + kRows * N; i += nthreads) buf[i] = 0.f;
  };

  for (int i = tid; i < stages; i += nthreads) barrier_init(&bars[i]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int q = tid; q < d; q += nthreads) w[q] = expf(-2.f * log_ls[static_cast<size_t>(c) * d + q]);
  for (int e = tid; e < BT * d; e += nthreads) {
    const int j = e / d, q = e % d;
    th[q * BT + j] = b0 + j < B ? theta[static_cast<size_t>(b0 + j) * d + q] : 0.f;
  }
  const float constant = with_constant ? expf(log_c[c]) : 0.f;
  __syncthreads();

  // Panels are consumed in one sequence over the column chunks: the g-th is
  // panel g % n_panels, in buffer g % stages; stages - 1 are in flight.
  const int total = (N + nthreads - 1) / nthreads * n_panels;
  for (int g = 0; g < stages - 1 && g < total; ++g) stage(g % n_panels, g % stages);
  unsigned phases = 0;  // bit b: the parity of buffer b's next completion

  // The ks tile: one (design point, walker) pair per thread and round.
  for (int e = tid; e < n_pad * BT; e += nthreads) {
    const int n = e / BT, j = e % BT;
    float value = 0.f;
    if (n < N && b0 + j < B) {
      const float* xn = X + static_cast<size_t>(n) * d;
      float sq = 0.f;
      for (int q = 0; q < d; ++q) {
        const float diff = th[q * BT + j] - xn[q];
        sq = fmaf(diff * diff, w[q], sq);
      }
      value = matern(sq, nu2) + constant;
    }
    ks[n * KS + j] = value;
  }

  float part_q[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) part_q[j] = 0.f;
  int g = 0;
  for (int col0 = 0; col0 < N; col0 += nthreads) {
    const int m = col0 + tid;
    float t[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) t[j] = 0.f;
    for (int p = 0; p < n_panels; ++p, ++g) {
      // The buffer refilled here was read in the previous round, which every
      // thread has left (the barrier at its end).
      if (g + stages - 1 < total) stage((g + stages - 1) % n_panels, (g + stages - 1) % stages);
      const int b = g % stages;
      while (!barrier_try_wait(&bars[b], (phases >> b) & 1u)) {
      }
      phases ^= 1u << b;
      __syncthreads();  // the threads' tail and zero rows, and at first the ks tile
      if (m < N) {
        const float* col = panels + b * stride + lead(p) + m;
        const float* kp = ks + p * kRows * KS;
        float tp[BT];  // this panel's sum, added to t whole: the error grows with N / kRows, not N
#pragma unroll
        for (int j = 0; j < BT; ++j) tp[j] = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float kv = col[r * N];
#pragma unroll
          for (int j4 = 0; j4 < BT / 4; ++j4) {
            const float4 a = *reinterpret_cast<const float4*>(kp + r * KS + 4 * j4);
            tp[4 * j4] = fmaf(a.x, kv, tp[4 * j4]);
            tp[4 * j4 + 1] = fmaf(a.y, kv, tp[4 * j4 + 1]);
            tp[4 * j4 + 2] = fmaf(a.z, kv, tp[4 * j4 + 2]);
            tp[4 * j4 + 3] = fmaf(a.w, kv, tp[4 * j4 + 3]);
          }
        }
#pragma unroll
        for (int j = 0; j < BT; ++j) t[j] += tp[j];
      }
      __syncthreads();  // this buffer may be staged again
    }
    if (m < N) {
#pragma unroll
      for (int j4 = 0; j4 < BT / 4; ++j4) {
        const float4 km = *reinterpret_cast<const float4*>(ks + m * KS + 4 * j4);
        part_q[4 * j4] = fmaf(t[4 * j4], km.x, part_q[4 * j4]);
        part_q[4 * j4 + 1] = fmaf(t[4 * j4 + 1], km.y, part_q[4 * j4 + 1]);
        part_q[4 * j4 + 2] = fmaf(t[4 * j4 + 2], km.z, part_q[4 * j4 + 2]);
        part_q[4 * j4 + 3] = fmaf(t[4 * j4 + 3], km.w, part_q[4 * j4 + 3]);
      }
    }
  }

  // The mean's products, each thread over its columns, after the row loop
  // (its registers are free again).
  float part_m[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) part_m[j] = 0.f;
  for (int m = tid; m < N; m += nthreads) {
    const float am = alpha[static_cast<size_t>(c) * N + m];
#pragma unroll
    for (int j4 = 0; j4 < BT / 4; ++j4) {
      const float4 km = *reinterpret_cast<const float4*>(ks + m * KS + 4 * j4);
      part_m[4 * j4] = fmaf(km.x, am, part_m[4 * j4]);
      part_m[4 * j4 + 1] = fmaf(km.y, am, part_m[4 * j4 + 1]);
      part_m[4 * j4 + 2] = fmaf(km.z, am, part_m[4 * j4 + 2]);
      part_m[4 * j4 + 3] = fmaf(km.w, am, part_m[4 * j4 + 3]);
    }
  }

  // Fixed-order reductions: a butterfly over the warp, then the warps in order.
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    float q = part_q[j], mm = part_m[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      q += __shfl_xor_sync(0xffffffffu, q, off);
      mm += __shfl_xor_sync(0xffffffffu, mm, off);
    }
    if (lane == 0) {
      red[warp][j] = q;
      red[warp][BT + j] = mm;
    }
  }
  __syncthreads();
  for (int j = tid; j < BT && b0 + j < B; j += nthreads) {
    float q = 0.f, mm = 0.f;
    for (int i = 0; i < nthreads / 32; ++i) {
      q += red[i][j];
      mm += red[i][BT + j];
    }
    const float v = prior_var[c] - q;
    const size_t out = static_cast<size_t>(b0 + j) * k + c;
    mean[out] = mm;
    var[out] = v < 0.f ? 0.f : v;
  }
}

__host__ inline int warps_for(int N) { return N >= kMaxWarps * 32 ? kMaxWarps : (N + 31) / 32; }

__host__ inline size_t shared_bytes(int N, int bt, int stages) {
  return sizeof(float) * (static_cast<size_t>(padded_rows(N)) * (bt + 4) + static_cast<size_t>(stages) * panel_floats(N));
}

// Panels in flight for a tile of bt walkers: as many as fit, up to kMaxStages; 0 when two do not.
__host__ inline int stages_for(int N, int bt) {
  for (int s = kMaxStages; s >= 2; --s) {
    if (shared_bytes(N, bt, s) <= kMaxDynamicShared) return s;
  }
  return 0;
}

template <int BT>
cudaError_t launch(const float* theta, const float* X, const float* log_ls, const float* log_c, const float* alpha,
                   const float* Kinv, const float* prior_var, float* mean, float* var, int B, int N, int d, int k,
                   int nu2, int with_constant, cudaStream_t stream) {
  const int stages = stages_for(N, BT);
  const size_t smem = shared_bytes(N, BT, stages);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(gp_predict_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const dim3 grid((B + BT - 1) / BT, k);
  gp_predict_kernel<BT><<<grid, warps_for(N) * 32, smem, stream>>>(theta, X, log_ls, log_c, alpha, Kinv, prior_var,
                                                                   mean, var, B, N, d, k, nu2, with_constant, stages);
  return cudaGetLastError();
}

}  // namespace

// The walker tile for a batch of B walkers on N design points: by B, halved
// while two panels would not fit beside the ks tile; 0 when even 8 walkers
// do not fit (N > 1,279).
static int walker_tile(int B, int N) {
  int bt = B <= 128 ? 8 : (B <= 512 ? 16 : 32);
  while (bt > 8 && stages_for(N, bt) == 0) bt /= 2;
  return stages_for(N, bt) == 0 ? 0 : bt;
}

extern "C" int gp_predict_f32(const float* theta, const float* X, const float* log_ls, const float* log_c,
                              const float* alpha, const float* Kinv, const float* prior_var, float* mean, float* var,
                              int B, int N, int d, int k, int nu2, int with_constant, void* stream) {
  if (B < 1 || N < 1 || k < 1 || d < 1 || d > kMaxDim || k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (nu2 != 0 && nu2 != 1 && nu2 != 3 && nu2 != 5) return static_cast<int>(cudaErrorInvalidValue);
  const int bt = walker_tile(B, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bt == 8) return static_cast<int>(launch<8>(theta, X, log_ls, log_c, alpha, Kinv, prior_var, mean, var, B, N, d,
                                                 k, nu2, with_constant, s));
  if (bt == 16) return static_cast<int>(launch<16>(theta, X, log_ls, log_c, alpha, Kinv, prior_var, mean, var, B, N,
                                                   d, k, nu2, with_constant, s));
  if (bt == 32) return static_cast<int>(launch<32>(theta, X, log_ls, log_c, alpha, Kinv, prior_var, mean, var, B, N,
                                                   d, k, nu2, with_constant, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
