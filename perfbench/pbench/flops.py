"""Frozen copy of the counts of ``src/bayesian_inference_tpu_torch/utils/flops.py``
at commit 7be95f0 (``mcmc_step_flops``, ``fit_iteration_flops``,
``fit_total_flops``), taking shapes instead of the likelihood object.

Conventions: one fused multiply-add is 2 FLOPs, a matmul (m, k) x (k, n)
2mkn, an elementwise transcendental 1. One sampler step evaluates W
proposals per ensemble.
"""

from __future__ import annotations

from pbench.shapes import Shapes

# The fit schedule the port ran at 7be95f0 (models/gp_fit.GPFitSpec defaults):
# every restart runs HALVING_ITERS iterations, the best HALVING_KEEP go on.
HALVING_ITERS, HALVING_KEEP = 15, 3


def step_flops(s: Shapes) -> float:
    """FLOPs of one sampler step of one ensemble of ``s.walkers``."""
    W, k, N, d = float(s.walkers), s.k, s.n_design, s.ndim
    total = W * (k * N * (3 * d + 8) + 2 * k * N + 2 * k * N * N + 2 * k * N)
    if s.mode == "lowrank":
        return total + W * (5 * k * k + 2 * (k**3 + 4 * k * k))
    k1 = k + 1
    for nb, n_obs in s.buckets:
        total += W * n_obs * (2 * nb * k1 + 2 * nb * nb * k1 + nb**3 + 4 * nb * nb)
    return total


def fit_iteration_flops(N: int, d: int) -> float:
    return (2 * N**2 * d + 8 * N**2 + N**3 / 3 + N**3 / 3 + 4 * N**2 + 2 * N**3
            + 4 * N**2 + 2 * N**2 * d + 2 * N**2)


def fit_flops(s: Shapes, halving_iters: int = HALVING_ITERS, halving_keep: int = HALVING_KEEP) -> float:
    """FLOPs of one fit of every PC: R = restarts + 1 instances, halving."""
    N, R, n_iters = s.n_design, s.restarts + 1, s.opt_iters
    per_iter = fit_iteration_flops(N, s.ndim)
    halve = 0 < halving_keep < R and n_iters > halving_iters
    iters1 = halving_iters if halve else n_iters
    total = s.k * R * (iters1 + 1) * per_iter
    if halve:
        total += s.k * halving_keep * (n_iters - halving_iters) * per_iter
    return total + s.k * 3 * N**3
