"""Analytic FLOP counts of a sampler step and of the GP fit, and the card's peak.

Port of ``bayesian_inference_tpu.utils.flops``, with the same counting
conventions, so that both packages give the same count for the same shapes:

* one fused multiply-add = 2 FLOPs; a matmul (m, k) x (k, n) = 2mkn.
* Counts follow the program structure (shared-sqdiff GP predict, bucketed
  block-MVN at the padded widths, blocked matmul-only LML), not a textbook
  formula. Elementwise transcendentals count as 1 FLOP each.
* All counts are per likelihood evaluation of W proposals; one sampler step
  evaluates two half-ensembles of W/2, that is W proposals per step.

The peak is the card's: FP32 outside the tensor cores, which is what the
port's float32 kernels and matrix products (TF32 off) can reach.
"""

from __future__ import annotations

from typing import Any

# FP32 TFLOP/s outside the tensor cores, by the start of
# ``torch.cuda.get_device_name`` (NVIDIA's data sheets, SXM parts at 700 W).
_PEAK_FP32_TFLOPS_BY_NAME = {"NVIDIA H100": 67.0}
H100_FP32_TFLOPS = _PEAK_FP32_TFLOPS_BY_NAME["NVIDIA H100"]


def device_peak_tflops(device=None) -> float:
    """FP32 (no tensor cores) peak of ``device``, a CUDA device or index
    (the current one when None), by its name; the H100's for a card the
    table does not list."""
    import torch

    name = torch.cuda.get_device_name(device)
    for key, val in _PEAK_FP32_TFLOPS_BY_NAME.items():
        if name.startswith(key):
            return val
    return H100_FP32_TFLOPS


def _shape(x) -> tuple:
    return tuple(x.shape)


def mcmc_step_flops(like: Any, n_walkers: int) -> float:
    """FLOPs per sampler step (= per W-proposal likelihood evaluation).

    ``like`` is an EmulatorLikelihood (a fitted one or
    ``mcmc/programs.likelihood_shape_spec``'s placeholder): only shapes are read.

    Components, per walker:
    * GP predict (models/gp.predict_all_shared), per group of k stacked PCs
      over N design points in d dims: cross-kernel rows k*N*(3d+8), posterior
      mean 2kN, variance ks@Kinv 2kN^2 + row-dot 2kN.
    * Block mode, per padded bucket (n_obs, nb, k1) with k1 = k_total + 1 (the
      residual-offset column counted with the factor): residual 2*nb*k1,
      covariance assembly 2*nb^2*k1, Cholesky sweep ~nb^3, forward solve and
      log-determinant ~4*nb^2.
    * Lowrank mode: one k x k capacitance system per walker, counted as the
      JAX package counts its own (M assembly ~k^2, r = G z 2k^2, two sweeps
      of k^3 + 4k^2, the z-quadratics ~2k^2), although the port's kernel
      takes both terms from one sweep.
    """
    W = float(n_walkers)
    total = 0.0
    for _cfg, posts in like.groups:
        k, N = _shape(posts.alpha)
        d = _shape(posts.X)[-1]
        total += W * k * N * (3 * d + 8)          # kernel rows
        total += W * 2 * k * N                    # mean ks@alpha
        total += W * 2 * k * N * N                # var ks@Kinv
        total += W * 2 * k * N                    # var row-dot
    if like.mode == "lowrank":
        k = _shape(like.wb.G)[0]
        total += W * (5 * k * k + 2 * (k**3 + 4 * k * k))
        return total
    for U in like.U:
        n_obs, nb, k = _shape(U)
        k1 = k + 1
        per_walker = n_obs * (
            2 * nb * k1                            # residual U@z
            + 2 * nb * nb * k1                     # covariance assembly
            + nb**3                                # rank-1 downdate sweep
            + 4 * nb * nb                          # fwd solve + quad/logdet
        )
        total += W * per_walker
    return total


def fit_iteration_flops(N: int, d: int, n_hyper: int | None = None) -> float:
    """FLOPs of one LML value + gradient evaluation for one (PC, restart)
    instance (models/gp._LMLMatmul): gram 2N^2 d + ~8N^2, blocked Cholesky
    N^3/3 + triangular inverse N^3/3, alpha 4N^2; backward: Kinv 2N^3, G/H
    ~4N^2, the length-scale contraction 2N^2 d, traces ~2N^2. ``n_hyper`` is
    accepted as in the JAX package and does not enter the count."""
    return (
        2 * N**2 * d + 8 * N**2            # gram
        + N**3 / 3 + N**3 / 3              # chol + inv(L)
        + 4 * N**2                         # alpha
        + 2 * N**3                         # Kinv (backward)
        + 4 * N**2 + 2 * N**2 * d + 2 * N**2  # grad contractions
    )


def fit_total_flops(
    N: int, d: int, k_pcs: int, n_restarts: int,
    n_iters: int, halving_iters: int = 15, halving_keep: int = 4,
) -> float:
    """Total fit FLOPs of the multi-restart schedule (models/gp_fit.fit_gps):
    R = n_restarts + 1 instances per PC run halving_iters (+1 seed
    evaluation) iterations, the top halving_keep continue for the remainder,
    then one posterior build (~3N^3) per PC. The defaults are the JAX
    package's; the port's schedule is ``GPFitSpec.halving_iters`` and
    ``GPFitSpec.halving_keep`` (15, 3)."""
    R = n_restarts + 1
    per_iter = fit_iteration_flops(N, d)
    halve = 0 < halving_keep < R and n_iters > halving_iters
    iters1 = halving_iters if halve else n_iters
    total = k_pcs * R * (iters1 + 1) * per_iter
    if halve:
        total += k_pcs * halving_keep * (n_iters - halving_iters) * per_iter
    total += k_pcs * 3 * N**3  # posterior build (chol + Kinv + alpha)
    return total
