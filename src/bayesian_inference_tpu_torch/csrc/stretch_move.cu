// The affine-invariant stretch move around the two log-probability calls of
// one ensemble step, in three launches (one kernel, a phase argument).
//
// Replaces the work XLA fuses in the JAX package's sampler step around its
// likelihood: bayesian_inference_tpu/mcmc/stretch.py:33-140
// (_stretch_half_draws, _step_with_rands; no Pallas kernel there). On this
// card the same step, written as torch calls, is some 40 gathers, elementwise
// calls, concatenations and index copies, each a launch of 1-2.5 us on a few
// hundred floats. For each of P independent ensembles of W walkers in d
// dimensions (one thread block each), from row r = t * thin + j of a chunk's
// pregenerated draws (t, the output row, read from a device counter):
//
//   phase 0: xp = coords[perm], lpp = log_prob[perm] (scratch, permuted order);
//            y0 = the proposals of the first half, against the second half:
//            z = ((a - 1) u + 1)^2 / a, x_c = xp[half + partner],
//            y = x_c + z (xp[i] - x_c)
//   (the caller evaluates lp_y0 = log_prob_fn(y0))
//   phase 1: accept the first half: log u_acc < (d - 1) log z + lp_y - lpp
//            (NaN and -inf reject, as torch's <); where accepted xp, lpp take
//            y0, lp_y0; then y1 = the second half's proposals against the
//            updated first half
//   (the caller evaluates lp_y1 = log_prob_fn(y1))
//   phase 2: accept the second half; assemble the new state by gathering with
//            inv (never a scatter): coords[i] = xp[inv[i]], log_prob likewise,
//            n_accepted[i] += accepted[inv[i]]; with write_row also the chain
//            row t, the log-prob row t and the row's mean acceptance,
//            sum_i (n_accepted[i] - base[i]) / W over the output row's thin
//            sub-steps.
//
// Every product, sum and comparison is the one torch's elementwise calls
// make, rounded the same way (__fmul_rn and friends keep nvcc from
// contracting them into FMAs; a division by the scalar a is torch's
// multiplication by 1 / a, taken in double and rounded to float), so that
// the kernel and the plain version take the same decisions on the same
// inputs: on an H100 under torch 2.11 the two agree bit for bit.
//
// What bounds it: nothing of the card. A step moves a few kilobytes per
// ensemble (W = 100, d = 6: 2.4 KB of coords, ~3 KB of draws), 0.1 us at
// 3.35 TB/s; each launch costs its latency. The design therefore minimises
// launches: the move's ~40 calls become 3, each reads its draws from the
// device counter itself (no index_select), and a block holds its whole
// ensemble, so the step needs only block barriers. The mean acceptance is an
// integer sum in shared memory (exact in any order).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Draws {
  const int64_t* perm;      // (n, P, W)
  const int64_t* inv;       // (n, P, W)
  const float* u_z;         // (n, P, 2, half)
  const int64_t* partners;  // (n, P, 2, half)
  const float* u_acc;       // (n, P, 2, half)
};

struct Scratch {
  float* xp;     // (P, W, d) the ensemble in permuted order
  float* lpp;    // (P, W)
  int32_t* acc;  // (P, W) accepted, in permuted order
};

// z = ((a - 1) u + 1)^2 / a, as torch computes it on the card.
__device__ __forceinline__ float stretch_z(float u, float am1, float inv_a) {
  const float s = __fadd_rn(__fmul_rn(am1, u), 1.f);
  return __fmul_rn(__fmul_rn(s, s), inv_a);
}

// y = x_c + z (x - x_c), elementwise.
__device__ __forceinline__ void propose(float* y, const float* x, const float* xc, float z, int d) {
  for (int q = 0; q < d; ++q) y[q] = __fadd_rn(xc[q], __fmul_rn(z, __fsub_rn(x[q], xc[q])));
}

// log u_acc < (d - 1) log z + lp_y - lp_x; false for NaN.
__device__ __forceinline__ bool accepted(float u_acc, float z, float lp_y, float lp_x, float dm1) {
  const float ratio = __fsub_rn(__fadd_rn(__fmul_rn(dm1, logf(z)), lp_y), lp_x);
  return logf(u_acc) < ratio;
}

// Accept or reject the walkers [h * half, (h + 1) * half) of the permuted
// ensemble against their proposals y and log-probs lp_y.
__device__ __forceinline__ void accept_half(const Scratch& s, const float* y, const float* lp_y, const float* u_z,
                                            const float* u_acc, int h, int p, int W, int d, float am1, float inv_a,
                                            float dm1) {
  const int half = W / 2;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const size_t w = static_cast<size_t>(p) * W + h * half + i;
    const float lp = lp_y[static_cast<size_t>(p) * half + i];
    const bool ok = accepted(u_acc[i], stretch_z(u_z[i], am1, inv_a), lp, s.lpp[w], dm1);
    if (ok) {
      const float* yi = y + (static_cast<size_t>(p) * half + i) * d;
      for (int q = 0; q < d; ++q) s.xp[w * d + q] = yi[q];
      s.lpp[w] = lp;
    }
    s.acc[w] = ok;
  }
}

__global__ void stretch_move_kernel(int phase, const float* __restrict__ coords, const float* __restrict__ log_prob,
                                    const int32_t* __restrict__ n_accepted, const int32_t* __restrict__ base,
                                    Draws draws, Scratch s, float* __restrict__ y0, float* __restrict__ y1,
                                    const float* __restrict__ lp_y, const int64_t* __restrict__ t_ptr, int thin,
                                    int j, float am1, float inv_a, float* __restrict__ coords_out,
                                    float* __restrict__ log_prob_out, int32_t* __restrict__ n_accepted_out,
                                    float* __restrict__ chain, float* __restrict__ chain_log_prob,
                                    float* __restrict__ acceptance, int write_row, int P, int W, int d) {
  const int p = blockIdx.x;
  const int half = W / 2;
  const float dm1 = static_cast<float>(d - 1);
  const int64_t t = *t_ptr;
  const int64_t row = t * thin + j;
  const int64_t* perm = draws.perm + (row * P + p) * W;
  const size_t h0 = static_cast<size_t>((row * P + p) * 2) * half;  // half 0 of this row's (2, half) draws
  const size_t h1 = h0 + half;

  if (phase == 0) {
    const float* cp = coords + static_cast<size_t>(p) * W * d;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const int64_t src = perm[i];
      const size_t w = static_cast<size_t>(p) * W + i;
      s.lpp[w] = log_prob[static_cast<size_t>(p) * W + src];
      for (int q = 0; q < d; ++q) s.xp[w * d + q] = cp[src * d + q];
    }
    // The proposals read the unpermuted coords through perm: no barrier.
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const float z = stretch_z(draws.u_z[h0 + i], am1, inv_a);
      const float* x = cp + perm[i] * d;
      const float* xc = cp + perm[half + draws.partners[h0 + i]] * d;
      propose(y0 + (static_cast<size_t>(p) * half + i) * d, x, xc, z, d);
    }
    return;
  }

  if (phase == 1) {
    accept_half(s, y0, lp_y, draws.u_z + h0, draws.u_acc + h0, 0, p, W, d, am1, inv_a, dm1);
    __syncthreads();
    const float* xpp = s.xp + static_cast<size_t>(p) * W * d;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const float z = stretch_z(draws.u_z[h1 + i], am1, inv_a);
      const float* x = xpp + static_cast<size_t>(half + i) * d;
      const float* xc = xpp + draws.partners[h1 + i] * d;
      propose(y1 + (static_cast<size_t>(p) * half + i) * d, x, xc, z, d);
    }
    return;
  }

  __shared__ int n_row;
  if (threadIdx.x == 0) n_row = 0;
  accept_half(s, y1, lp_y, draws.u_z + h1, draws.u_acc + h1, 1, p, W, d, am1, inv_a, dm1);
  __syncthreads();
  const int64_t* inv = draws.inv + (row * P + p) * W;
  int mine = 0;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const size_t w = static_cast<size_t>(p) * W + i;
    const size_t src = static_cast<size_t>(p) * W + inv[i];
    const float lp = s.lpp[src];
    const int32_t n = n_accepted[w] + s.acc[src];
    log_prob_out[w] = lp;
    n_accepted_out[w] = n;
    for (int q = 0; q < d; ++q) coords_out[w * d + q] = s.xp[src * d + q];
    if (write_row) {
      const size_t o = static_cast<size_t>(t) * P * W + w;
      if (chain != nullptr) {
        for (int q = 0; q < d; ++q) chain[o * d + q] = s.xp[src * d + q];
        chain_log_prob[o] = lp;
      }
      mine += n - base[w];
    }
  }
  if (write_row) {
    atomicAdd(&n_row, mine);
    __syncthreads();
    // torch's mean on the card: the sum times 1 / W.
    if (threadIdx.x == 0) acceptance[static_cast<size_t>(t) * P + p] = static_cast<float>(n_row) * (1.f / W);
  }
}

}  // namespace

extern "C" int stretch_move_f32(int phase, const float* coords, const float* log_prob, const int32_t* n_accepted,
                                const int32_t* base, const int64_t* perm, const int64_t* inv, const float* u_z,
                                const int64_t* partners, const float* u_acc, float* xp, float* lpp, int32_t* acc,
                                float* y0, float* y1, const float* lp_y, const int64_t* t, int thin, int j, float am1,
                                float inv_a, float* coords_out, float* log_prob_out, int32_t* n_accepted_out,
                                float* chain, float* chain_log_prob, float* acceptance, int write_row, int P, int W,
                                int d, void* stream) {
  if (phase < 0 || phase > 2 || P < 1 || W < 2 || W % 2 || d < 1 || thin < 1 || j < 0 || j >= thin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = W >= 1024 ? 1024 : (W + 31) / 32 * 32;
  const Draws draws{perm, inv, u_z, partners, u_acc};
  const Scratch s{xp, lpp, acc};
  stretch_move_kernel<<<P, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      phase, coords, log_prob, n_accepted, base, draws, s, y0, y1, lp_y, t, thin, j, am1, inv_a, coords_out,
      log_prob_out, n_accepted_out, chain, chain_log_prob, acceptance, write_row, P, W, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
