"""K4, ``csrc/tiny_mvn.cu``: Cholesky, quadratic form and half log-determinant
of each walker's k x k capacitance matrix (the lowrank likelihood). Frozen
copy of ``chip_smoke.phase_k4``'s bound at commit 7be95f0: n^3 / 3 + n^2
FLOPs an instance; M's lower triangle and r read, quad and half_logdet
written."""

KERNELS = ("tiny_mvn_kernel",)


def cost(s) -> tuple[float, float]:
    """(FLOPs, bytes) of one evaluation of a half-step's walkers."""
    B, n = s.half_batch, s.k
    return B * (n**3 / 3 + n * n), 4 * B * (n * (n + 1) / 2 + n + 2)
