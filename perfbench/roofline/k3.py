"""K3, ``csrc/diag_chol_inv.cu``: Cholesky and triangular inverse of a batch
of 64 x 64 diagonal blocks, the GP fit's factorisation. Frozen copy of
``chip_smoke.phase_k3``'s bound at commit 7be95f0: 2 n^3 / 3 FLOPs a block;
A's lower triangle read, L and L^-1 written whole."""

KERNELS = ("diag_chol_inv_kernel",)
NB = 64


def cost(batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``batch`` blocks."""
    n = NB
    return batch * 2 * n**3 / 3, 4 * batch * (n * (n + 1) / 2 + 2 * n * n)
