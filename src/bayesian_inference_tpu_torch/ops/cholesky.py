"""Batched small-matrix Cholesky + forward substitution, unrolled over columns.

Port of ``bayesian_inference_tpu.ops.cholesky``: each column step is one
rank-1 downdate over the whole batch. It is the plain PyTorch version of the
fused block-MVN kernel's factorisation (ops/fused_mvn.py).
"""

from __future__ import annotations

import torch


def tiny_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., n, n) SPD matrices, unrolled over the n columns.

    A non-positive pivot gives NaN (rsqrt of a negative), as on every other
    path of the port.
    """
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        inv_pivot = torch.rsqrt(A[..., j, j])
        col = A[..., :, j] * inv_pivot[..., None]
        col = torch.where(idx >= j, col, torch.zeros_like(col))
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def tiny_solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b for (..., n, n) lower-triangular L, (..., n) b."""
    n = L.shape[-1]
    ys = []
    for i in range(n):
        y_i = b[..., i] / L[..., i, i]
        ys.append(y_i)
        b = b - L[..., :, i] * y_i[..., None]
    return torch.stack(ys, dim=-1)


def tiny_mvn_loglike(dY: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Unnormalized MVN loglike via the unrolled factorization."""
    L = tiny_cholesky(cov)
    e = tiny_solve_lower(L, dY)
    quad = (e * e).sum(-1)
    half_logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * quad - half_logdet
