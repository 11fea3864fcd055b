"""K5, ``csrc/gp_predict.cu``: GP means and variances of the k stacked PCs at
a batch of walkers. Frozen copy of ``chip_smoke.k5_bound`` at commit 7be95f0:
per (PC, walker, design point) the distance's 4 d operations, the Matern-1.5
value's 6, the mean's 2, the variance's row product 2 N and dot 2; every
operand read once (theta, X, the length scales, constants, alpha, K^-1, prior
variances) and both (B, k) results written once."""

KERNELS = ("gp_predict_kernel",)


def cost(s) -> tuple[float, float]:
    """(FLOPs, bytes) of one evaluation of a half-step's walkers."""
    k, B, N, d = s.k, s.half_batch, s.n_design, s.ndim
    flops = k * B * N * (4 * d + 6 + 2 + 2 * N + 2) + 2 * k * B
    return flops, 4 * (B * d + N * d + k * d + k + k * N + k * N * N + k) + 4 * 2 * B * k
