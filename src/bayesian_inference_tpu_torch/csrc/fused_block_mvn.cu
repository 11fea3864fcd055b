// Fused block-MVN log-likelihood of the MCMC likelihood's observable blocks,
// every width bucket in one launch.
//
// Replaces bayesian_inference_tpu/ops/pallas_mvn.py::_fused_kernel_packed (and
// computes the same function as its W > 64 sibling _fused_kernel). For every
// walker w and every observable block o of every width bucket:
//
//   b = d0[p(w), o] + U[o] z[w]                 (nb)
//   C = D[o] + U[o] diag(v[w]) U[o]^T           (nb x nb)
//   ll[o, w] = -1/2 |L^{-1} b|^2 - sum(log diag L),   C = L L^T
//
// and out[w] = sum over buckets, then over their blocks, of ll[o, w]. Padded
// rows of a bucket carry D = I, U = 0, d0 = 0 and contribute 0. The residual
// offsets d0 may differ per point of a batched closure run: each bucket's d0
// is then (P, n_obs, nb), walkers are point-major with Wh per point, and
// walker w reads row p(w) = w / Wh (P = 1, Wh = W: one analysis).
//
// What bounds it: plain FP32 FMA. Per walker at the production buckets
// (nb 8/16/24 x 40/96/8 blocks, k = 41) the assembly takes 692,736 FMA, the
// residual 83,968, the Cholesky 87,381 and the solve 15,872: 1.76 MFLOP
// against ~10 KB of operands per walker, so the least time on an H100 SXM
// (67 TFLOP/s FP32 without tensor cores) is 1.3 us at W = 50 and 39 us at
// W = 1,500. Single-pass TF32 would break the port's precision contract.
//
// The design follows from that: FMAs, not loads or barriers, must set the
// pace, so one thread owns one (walker, block) pair, as the TPU kernel put
// walkers on its lanes. Every lane of a thread block has the same nb, so
// nothing diverges and the factorisation needs no barrier at all.
// - A thread block takes one observable block and a tile of walkers. It
//   stages the block's U once, transposed to [q][row] so that a column of U
//   is a few broadcast 16-byte shared loads (every lane reads the same
//   address), its D, and the tile's z and v as [q][walker] (odd pitch:
//   conflict-free), all with cp.async so that every copy is in flight at
//   once (copies one round trip at a time took 5-12 us per block).
// - nb <= 16 (padded to 8 or 16 with identity rows, which leave every real
//   entry and both sums bit-unchanged): the thread keeps its whole lower
//   triangle and residual in registers. The assembly streams over q: per q it
//   loads one column of U and v[w, q], z[w, q], then runs nb (nb + 1) / 2 + nb
//   independent FMAs. The Cholesky, forward solve and log-determinant run on
//   the registers fully unrolled. Walker tile 64.
// - 16 < nb <= 48: the triangle does not fit in registers. It is assembled
//   in 8 x 8 register tiles (the same arithmetic per entry) and written to
//   shared memory laid out [entry][walker], stride 1 across lanes. A blocked
//   right-looking Cholesky factorises it on 8 x 8 register tiles (one shared
//   load or store per 8 FMA, independent chains), with the forward solve and
//   the log-determinant. Walker tile 32, so that the shared memory of one
//   launch stays small enough for several blocks per SM; the block's two
//   warps share the assembly's tiles (one barrier), then one factorises.
// - Any number of PCs k: for k > kChunk a second instance of the kernel
//   stages U's columns and the tile's z and v kChunk PCs at a time, and the
//   assembly runs over the chunks in order, carrying its partial sums
//   (registers for nb <= 16, the shared triangle above), in the same order
//   over q as one pass; every thread stays for the barriers of the later
//   chunks' staging. k <= kChunk runs the one-pass instance: each copy reads
//   contiguous sources and the walkers past W leave before the assembly (on
//   an H100 the chunked form's index arithmetic and idle threads cost 10 %
//   at k = 41).
// - The launch covers every bucket: a small table maps each thread block to
//   its bucket, block and walker tile (heaviest buckets first). A second
//   kernel sums each walker's (bucket, block) terms in a fixed order: no
//   atomics, repeated launches are bit-equal, and a walker's value does not
//   depend on which walkers share its launch.
// A pivot that is not positive gives NaN in that walker's block term, and in
// nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;      // threads per block, the walker tile for nb <= 16
constexpr int kTileShared = 32;   // walker tile for nb > 16
constexpr int kMaxNb = 48;
constexpr int kChunk = 128;       // PCs staged at a time
constexpr int kMaxBuckets = 8;

struct Bucket {
  const float* U;    // (n_obs, nb, k)
  const float* D;    // (n_obs, nb, nb)
  const float* d0;   // (P, n_obs, nb)
  int n_obs, nb;
  int obs_offset;    // first row of this bucket's blocks in ll_blk (bucket order)
  int block_start;   // first thread block of this bucket (launch order)
  int tiles;         // walker tiles per observable block
};

struct Buckets {
  Bucket b[kMaxBuckets];
  int n;
};

__host__ __device__ inline int padded(int nb) { return (nb + 7) & ~7; }
__host__ __device__ inline int walker_tile(int nb) { return nb <= 16 ? kThreads : kTileShared; }
__host__ __device__ inline int tri(int n) { return n * (n + 1) / 2; }

__host__ __device__ inline int first_chunk(int k) { return k < kChunk ? k : kChunk; }

// Shared floats one thread block of a bucket of width nb uses, staging kc PCs at a time.
__host__ inline size_t shared_floats(int nb, int kc) {
  const int tw = walker_tile(nb);
  size_t n = static_cast<size_t>(kc) * padded(nb) + 2 * static_cast<size_t>(kc) * (tw + 1) + nb * nb;
  if (nb > 16) n += static_cast<size_t>(tri(nb) + nb) * tw;
  return n;
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// A 4-byte copy from device to shared memory that does not hold the thread
// (cp.async); copy_async_wait waits for all of the thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// What one thread block stages: its observable block's U (nb x k, row-major
// in device memory) and its walker tile's z and v (k per walker), into
// U_s [q][row] (pitch nbp) and zT, vT [q][walker] (pitch tp), kc PCs at a
// time. Walkers of the tile at or past n_walkers stage zeros.
struct Staging {
  const float* Uo;
  const float* zt;
  const float* vt;
  float* U_s;
  float* zT;
  float* vT;
  int nb, nbp, k, tw, tp, n_walkers;

  // Copies PCs [q0, q0 + kc) in flight (cp.async); the caller waits and syncs.
  // Whole: all k PCs (q0 = 0, kc = k), each source contiguous.
  template <bool Whole>
  __device__ __forceinline__ void chunk(int q0, int kc) const {
    for (int e = threadIdx.x; e < nb * kc; e += kThreads) {
      const float* src = Whole ? Uo + e : Uo + static_cast<size_t>(e / kc) * k + q0 + e % kc;
      copy_async(U_s + (e % kc) * nbp + e / kc, src);
    }
    const int n_in = (n_walkers < tw ? n_walkers : tw) * kc;
    for (int e = threadIdx.x; e < tw * kc; e += kThreads) {
      const int w = e / kc, q = e % kc;
      float* zd = zT + q * tp + w;
      float* vd = vT + q * tp + w;
      if (e < n_in) {
        const size_t at = Whole ? e : static_cast<size_t>(w) * k + q0 + q;
        copy_async(zd, zt + at);
        copy_async(vd, vt + at);
      } else {
        *zd = 0.f;
        *vd = 0.f;
      }
    }
  }

  // Stages the next chunk once every thread is done with the current one.
  __device__ __forceinline__ void next_chunk(int q0, int kc) const {
    __syncthreads();
    chunk<false>(q0, kc);
    copy_async_wait();
    __syncthreads();
  }
};

// Entry (f, g), g <= f, of a thread's packed lower triangle in shared memory
// ([entry][walker], pitch tw); rows at or past nb read as the identity.
__device__ __forceinline__ float entry(const float* C_s, int f, int g, int nb, int tw, int t) {
  return f < nb ? C_s[(tri(f) + g) * tw + t] : (f == g ? 1.f : 0.f);
}

// Adds the kc staged PCs' terms to a register triangle C and residual b.
template <int NB>
__device__ __forceinline__ void accumulate_in_registers(float (&C)[NB * (NB + 1) / 2], float (&b)[NB],
                                                        const float* U_s, const float* zT, const float* vT, int tp,
                                                        int t, int kc) {
#pragma unroll 1
  for (int q = 0; q < kc; ++q) {
    const float zq = zT[q * tp + t];
    const float vq = vT[q * tp + t];
    float u[NB];
    const float4* col = reinterpret_cast<const float4*>(U_s + q * NB);
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) {
      const float4 x = col[i];
      u[4 * i] = x.x;
      u[4 * i + 1] = x.y;
      u[4 * i + 2] = x.z;
      u[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int f = 0; f < NB; ++f) {
      b[f] = fmaf(u[f], zq, b[f]);
      const float a = u[f] * vq;
#pragma unroll
      for (int g = 0; g <= f; ++g) C[tri(f) + g] = fmaf(a, u[g], C[tri(f) + g]);
    }
  }
}

// nb <= NB (8 or 16): the pair's triangle and residual in registers. Do is the
// block's D in shared memory; the first chunk of PCs is staged. Unchunked
// (k <= kChunk), only live threads (a walker below W) call it. Chunked, every
// thread of the block calls it, since the later chunks' staging has barriers,
// and only a live one computes and returns its terms.
template <int NB, bool Chunked>
__device__ __forceinline__ void pair_in_registers(const float* __restrict__ Do, const float* __restrict__ d0w,
                                                  const Staging& st, int t, int nb, bool live,
                                                  float& quad, float& half_logdet) {
  float C[NB * (NB + 1) / 2];
  float b[NB];
#pragma unroll
  for (int f = 0; f < NB; ++f) {
    b[f] = live && f < nb ? d0w[f] : 0.f;
#pragma unroll
    for (int g = 0; g <= f; ++g) C[tri(f) + g] = f < nb ? Do[f * nb + g] : (f == g ? 1.f : 0.f);
  }

  if constexpr (Chunked) {
#pragma unroll 1
    for (int q0 = 0; q0 < st.k; q0 += kChunk) {
      const int kc = first_chunk(st.k - q0);
      if (q0 > 0) st.next_chunk(q0, kc);
      if (live) accumulate_in_registers<NB>(C, b, st.U_s, st.zT, st.vT, st.tp, t, kc);
    }
  } else {
    accumulate_in_registers<NB>(C, b, st.U_s, st.zT, st.vT, st.tp, t, st.k);
  }
  if (!live) return;

  // Right-looking Cholesky fused with the forward solve and the log-det.
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float pivot = C[tri(j) + j];
    const float d = pivot > 0.f ? sqrtf(pivot) : nan_f();
    const float inv = 1.f / d;
    const float yj = b[j] * inv;
    quad = fmaf(yj, yj, quad);
    half_logdet += logf(d);
#pragma unroll
    for (int i = j + 1; i < NB; ++i) {
      const float l = C[tri(i) + j] * inv;
      C[tri(i) + j] = l;
      b[i] = fmaf(-l, yj, b[i]);
    }
#pragma unroll
    for (int i = j + 1; i < NB; ++i) {
#pragma unroll
      for (int c = j + 1; c <= i; ++c) C[tri(i) + c] = fmaf(-C[tri(i) + j], C[tri(c) + j], C[tri(i) + c]);
    }
  }
}

// 16 < nb <= 48: the pair's triangle and residual into shared memory,
// [entry][walker] with pitch tw, over the kc PCs staged. The 8 x 8 tiles are
// dealt out over ``parts`` threads of the same walker; this one computes
// those numbered ``part``. The first chunk starts from D and d0, a later one
// from the partial sums this thread stored for the same tiles.
__device__ __forceinline__ void assemble_in_shared(const float* __restrict__ Do, const float* __restrict__ d0w,
                                                   const float* U_s, const float* zT, const float* vT, int tp,
                                                   float* C_s, float* b_s, int tw, int t, int nb, int kc,
                                                   bool first, int part, int parts) {
  const int nbp = padded(nb);
  const int tiles = nbp / 8;
  int n = 0;
#pragma unroll 1
  for (int F = 0; F < tiles; ++F) {
#pragma unroll 1
    for (int G = 0; G <= F; ++G) {
      if (n++ % parts != part) continue;
      const bool diag = F == G;
      float acc[8][8];
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = 8 * F + i;
        r[i] = diag && f < nb ? (first ? d0w[f] : b_s[f * tw + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int g = 8 * G + j;
          acc[i][j] = f < nb && g <= f ? (first ? Do[f * nb + g] : C_s[(tri(f) + g) * tw + t]) : 0.f;
        }
      }
#pragma unroll 1
      for (int q = 0; q < kc; ++q) {
        const float vq = vT[q * tp + t];
        const float4* rows = reinterpret_cast<const float4*>(U_s + q * nbp + 8 * F);
        const float4* cols = reinterpret_cast<const float4*>(U_s + q * nbp + 8 * G);
        const float4 f0 = rows[0], f1 = rows[1], g0 = cols[0], g1 = cols[1];
        const float uf[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
        const float ug[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        if (diag) {
          const float zq = zT[q * tp + t];
#pragma unroll
          for (int i = 0; i < 8; ++i) r[i] = fmaf(uf[i], zq, r[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = uf[i] * vq;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, ug[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = 8 * F + i;
        if (f >= nb) break;
        if (diag) b_s[f * tw + t] = r[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int g = 8 * G + j;
          if (g <= f) C_s[(tri(f) + g) * tw + t] = acc[i][j];
        }
      }
    }
  }
}

// Blocked right-looking Cholesky of the triangle assemble_in_shared left, over
// 8 x 8 tiles, each step on register tiles (rows >= nb read as the identity
// and never stored): factor the diagonal tile with the forward solve and the
// log-det, solve the tiles below it and update their residual rows, then
// update the trailing tiles.
__device__ __forceinline__ void factor_in_shared(float* C_s, float* b_s, int tw, int t, int nb,
                                                 float& quad, float& half_logdet) {
  const int tiles = padded(nb) / 8;
#pragma unroll 1
  for (int J = 0; J < tiles; ++J) {
    float A[8][8];
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = 8 * J + i;
      y[i] = f < nb ? b_s[f * tw + t] : 0.f;
#pragma unroll
      for (int j = 0; j <= i; ++j) A[i][j] = entry(C_s, f, 8 * J + j, nb, tw, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pivot = A[j][j];
      const float d = pivot > 0.f ? sqrtf(pivot) : nan_f();
      const float inv = 1.f / d;
      const float yj = y[j] * inv;
      y[j] = yj;
      A[j][j] = inv;  // the panel solves below scale by it
      quad = fmaf(yj, yj, quad);
      half_logdet += logf(d);
#pragma unroll
      for (int i = j + 1; i < 8; ++i) {
        const float l = A[i][j] * inv;
        A[i][j] = l;
        y[i] = fmaf(-l, yj, y[i]);
      }
#pragma unroll
      for (int i = j + 1; i < 8; ++i) {
#pragma unroll
        for (int c = j + 1; c <= i; ++c) A[i][c] = fmaf(-A[i][j], A[c][j], A[i][c]);
      }
    }

#pragma unroll 1
    for (int I = J + 1; I < tiles; ++I) {
      float X[8][8];
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = 8 * I + i;
        r[i] = f < nb ? b_s[f * tw + t] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) X[i][j] = entry(C_s, f, 8 * J + j, nb, tw, t);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          X[i][j] *= A[j][j];
          r[i] = fmaf(-X[i][j], y[j], r[i]);
        }
#pragma unroll
        for (int c = j + 1; c < 8; ++c) {
#pragma unroll
          for (int i = 0; i < 8; ++i) X[i][c] = fmaf(-X[i][j], A[c][j], X[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = 8 * I + i;
        if (f >= nb) break;
        b_s[f * tw + t] = r[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) C_s[(tri(f) + 8 * J + j) * tw + t] = X[i][j];
      }
    }

#pragma unroll 1
    for (int I = J + 1; I < tiles; ++I) {
      float P[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) P[i][j] = entry(C_s, 8 * I + i, 8 * J + j, nb, tw, t);
      }
#pragma unroll 1
      for (int K = J + 1; K <= I; ++K) {
        float Q[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) Q[i][j] = entry(C_s, 8 * K + i, 8 * J + j, nb, tw, t);
        }
        // One row of the tile at a time: 8 independent sums, each over j in order.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int f = 8 * I + i;
          if (f >= nb) break;
          float acc[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int g = 8 * K + c;
            acc[c] = g <= f ? C_s[(tri(f) + g) * tw + t] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[c] = fmaf(-P[i][j], Q[c][j], acc[c]);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int g = 8 * K + c;
            if (g <= f) C_s[(tri(f) + g) * tw + t] = acc[c];
          }
        }
      }
    }
  }
}

template <bool Chunked>
__global__ void __launch_bounds__(kThreads)
fused_block_mvn_buckets_kernel(const Buckets buckets, const float* __restrict__ z, const float* __restrict__ v,
                               float* __restrict__ ll_blk, int k, int W, int Wh) {
  extern __shared__ __align__(16) float smem[];
  int bi = 0;
  while (bi + 1 < buckets.n && static_cast<int>(blockIdx.x) >= buckets.b[bi + 1].block_start) ++bi;
  const Bucket bk = buckets.b[bi];
  const int local = blockIdx.x - bk.block_start;
  const int o = local / bk.tiles;
  const int nb = bk.nb, nbp = padded(nb);
  const int tw = walker_tile(nb), tp = tw + 1;
  const int w0 = (local % bk.tiles) * tw;
  const int kc0 = first_chunk(k);

  float* U_s = smem;             // kc0 x nbp, [q][row], rows >= nb zero
  float* zT = U_s + kc0 * nbp;   // kc0 x tp, [q][walker]
  float* vT = zT + kc0 * tp;
  float* D_s = vT + kc0 * tp;    // nb x nb
  float* C_s = D_s + nb * nb;    // nb > 16 only: tri(nb) x tw
  float* b_s = C_s + tri(nb) * tw;

  // Staging: every copy of the block in flight at once (cp.async), since one
  // round trip to device memory at a time costs microseconds under load.
  const Staging st{bk.U + static_cast<size_t>(o) * nb * k, z + static_cast<size_t>(w0) * k,
                   v + static_cast<size_t>(w0) * k, U_s, zT, vT, nb, nbp, k, tw, tp, W - w0};
  const float* Do = bk.D + static_cast<size_t>(o) * nb * nb;
  for (int e = threadIdx.x; e < nb * nb; e += kThreads) copy_async(D_s + e, Do + e);
  for (int e = threadIdx.x; e < kc0 * (nbp - nb); e += kThreads) {
    U_s[(e / (nbp - nb)) * nbp + nb + e % (nbp - nb)] = 0.f;
  }
  st.chunk<!Chunked>(0, kc0);
  copy_async_wait();
  __syncthreads();

  const int t = threadIdx.x % tw;    // the walker's lane in the tile
  const int part = threadIdx.x / tw;  // nb > 16: which share of the assembly
  const int w = w0 + t;
  const bool live = w < W;
  const float* d0w = bk.d0 + (static_cast<size_t>(w / Wh) * bk.n_obs + o) * nb;
  float quad = 0.f, half_logdet = 0.f;
  if (nb <= 16) {
    if (!Chunked && !live) return;  // no block-wide barrier below this point
    if (nb <= 8) {
      pair_in_registers<8, Chunked>(D_s, d0w, st, t, nb, live, quad, half_logdet);
    } else {
      pair_in_registers<16, Chunked>(D_s, d0w, st, t, nb, live, quad, half_logdet);
    }
    if (!live) return;
  } else {
    if constexpr (Chunked) {
#pragma unroll 1
      for (int q0 = 0; q0 < k; q0 += kChunk) {
        const int kc = first_chunk(k - q0);
        if (q0 > 0) st.next_chunk(q0, kc);
        if (live) assemble_in_shared(D_s, d0w, U_s, zT, vT, tp, C_s, b_s, tw, t, nb, kc, q0 == 0, part, kThreads / tw);
      }
    } else {
      if (live) assemble_in_shared(D_s, d0w, U_s, zT, vT, tp, C_s, b_s, tw, t, nb, k, true, part, kThreads / tw);
    }
    __syncthreads();
    if (part != 0 || !live) return;
    factor_in_shared(C_s, b_s, tw, t, nb, quad, half_logdet);
  }
  ll_blk[static_cast<size_t>(bk.obs_offset + o) * W + w] = -0.5f * quad - half_logdet;
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

// n_buckets width buckets, bucket i with pointers U[i], D[i], d0[i] and
// n_obs[i] blocks of width nb[i]; all share z and v (W, k). W walkers in
// total, Wh per point (W a multiple of Wh): every d0[i] holds W / Wh
// (n_obs[i], nb[i]) offset tables, point-major. ll_blk is (sum n_obs, W)
// scratch, out is (W,).
extern "C" int fused_block_mvn_buckets_f32(int n_buckets, const void* const* U, const void* const* D,
                                           const void* const* d0, const int* n_obs, const int* nb,
                                           const float* z, const float* v, float* ll_blk, float* out,
                                           int k, int W, int Wh, void* stream) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets || k < 1 || W < 1 || Wh < 1 || W % Wh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int offsets[kMaxBuckets];
  int total_obs = 0;
  size_t smem = 0;
  for (int i = 0; i < n_buckets; ++i) {
    if (nb[i] < 1 || nb[i] > kMaxNb || n_obs[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    offsets[i] = total_obs;
    total_obs += n_obs[i];
    const size_t need = sizeof(float) * shared_floats(nb[i], first_chunk(k));
    if (need > smem) smem = need;
  }
  // Launch order: the widest (slowest) buckets first, so they do not trail.
  Buckets table{};
  table.n = n_buckets;
  long long blocks = 0;
  for (int j = 0; j < n_buckets; ++j) {
    const int i = n_buckets - 1 - j;
    const int tiles = (W + walker_tile(nb[i]) - 1) / walker_tile(nb[i]);
    table.b[j] = Bucket{static_cast<const float*>(U[i]), static_cast<const float*>(D[i]),
                        static_cast<const float*>(d0[i]), n_obs[i], nb[i], offsets[i],
                        static_cast<int>(blocks), tiles};
    blocks += static_cast<long long>(n_obs[i]) * tiles;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool chunked = k > kChunk;
  static size_t smem_allowed[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_allowed[chunked]) {
    cudaError_t err = cudaFuncSetAttribute(chunked ? fused_block_mvn_buckets_kernel<true>
                                                   : fused_block_mvn_buckets_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[chunked] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked) {
    fused_block_mvn_buckets_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(table, z, v, ll_blk,
                                                                                              k, W, Wh);
  } else {
    fused_block_mvn_buckets_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(table, z, v, ll_blk,
                                                                                               k, W, Wh);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_over_blocks_kernel<<<(W + 127) / 128, 128, 0, s>>>(ll_blk, out, total_obs, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
