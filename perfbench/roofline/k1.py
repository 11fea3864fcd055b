"""K1, ``csrc/fused_block_mvn.cu``: the block likelihood of every (walker,
observable block) pair in one launch, and its fixed-order sum. Frozen copy of
``chip_smoke.k1_bound`` at commit 7be95f0.

Per walker and block at the padded widths: the covariance assembly's
nb (nb + 1) / 2 * k FMA, the residual's nb * k, the Cholesky's nb^3 / 6 and
the forward solve's nb^2 / 2. Bytes: every operand read once (U, D, the
residual offsets, one set per point, z, v) and the (W,) result written once.
"""

# Device kernels of one evaluation; the first is counted as its launches.
KERNELS = ("fused_block_mvn_buckets_kernel", "sum_over_blocks_kernel")


def cost(s) -> tuple[float, float]:
    """(FLOPs, bytes) of one evaluation of a half-step's walkers."""
    W, k = s.half_batch, s.k
    fma = sum(n_obs * (nb * (nb + 1) / 2 * k + nb * k + nb**3 / 6 + nb**2 / 2) for nb, n_obs in s.buckets)
    operands = sum(n_obs * (nb * k + nb * nb + s.points * nb) for nb, n_obs in s.buckets)
    return 2 * W * fma, 4 * (operands + 2 * W * k + W)
