"""Batched blocked Cholesky + triangular inverse for the GP-fit batch.

Port of ``bayesian_inference_tpu.ops.blocked_cholesky``. The fit factorises
thousands of (N, N) Gram matrices per L-BFGS iteration (N ~ 200 design points,
batch ~ 2,000 PC x restart instances). Everything is batched matrix products
except the NB x NB diagonal-block factorisation, which is the hand-written
kernel ``csrc/diag_chol_inv.cu`` on CUDA:

  per panel k:
      L[k][k], invL[k][k] = diag_chol_inv(A[k][k])          (kernel)
      L[i][k]  = A[i][k] @ invL[k][k]^T                     (batched matmul)
      A[i][j] -= L[i][k] @ L[j][k]^T                        (batched matmul)
  block forward substitution for the full triangular inverse:
      invL[i][j] = -invL[i][i] @ sum_k L[i][k] @ invL[k][j] (batched matmul)

From invL, everything the log marginal likelihood and its closed-form gradient
need is matmul work (models/gp.py). The matmuls run in full float32 on the
card (the package turns TF32 off).
"""

from __future__ import annotations

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, check_cuda_operands, stream_handle

# Diagonal block size; N pads to a multiple with an identity diagonal pad.
NB = 64

KERNEL = NativeKernel("diag_chol_inv.cu", {"diag_chol_inv_f32": [P] * 3 + [I] * 2 + [P]})


def diag_chol_inv_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: library Cholesky + triangular solve of I.
    A non-positive-definite instance gives NaN (its L is undefined)."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _diag_chol_inv_cuda(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if A.ndim != 3 or A.shape[1] != A.shape[2] or not 1 <= A.shape[-1] <= NB:
        raise ValueError(f"diag_chol_inv: the CUDA kernel takes (B, n, n) with n <= {NB}, got {tuple(A.shape)}")
    check_cuda_operands("diag_chol_inv", A)
    L = torch.empty_like(A)
    Linv = torch.empty_like(A)
    KERNEL.launch(
        "diag_chol_inv_f32", A.data_ptr(), L.data_ptr(), Linv.data_ptr(),
        A.shape[0], A.shape[-1], stream_handle(A.device),
    )
    return L, Linv


def diag_chol_inv(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n, n) SPD -> (L, L^{-1}), both row-major lower triangular.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if A.device.type == "cpu":
        return diag_chol_inv_plain(A)
    if A.device.type == "cuda":
        return _diag_chol_inv_cuda(A)
    raise ValueError(f"diag_chol_inv: unsupported device {A.device}")


def blocked_chol_inv(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched (B, N, N) SPD -> (invL (B, N, N), half_logdet (B,)).

    N is padded internally to a multiple of NB with an identity diagonal pad;
    the results are sliced back exactly.
    """
    B, N, _ = K.shape
    n_pad = (-N) % NB
    if n_pad:
        Kp = torch.zeros((B, N + n_pad, N + n_pad), dtype=K.dtype, device=K.device)
        Kp[:, :N, :N] = K
        Kp[:, N:, N:] = torch.eye(n_pad, dtype=K.dtype, device=K.device)
        K = Kp
    n = K.shape[-1] // NB

    def blk(i, j):
        return K[:, i * NB : (i + 1) * NB, j * NB : (j + 1) * NB]

    A = [[blk(i, j) for j in range(i + 1)] for i in range(n)]
    L: list[list] = [[None] * n for _ in range(n)]
    Inv: list[list] = [[None] * n for _ in range(n)]
    half_logdet = torch.zeros((B,), dtype=K.dtype, device=K.device)

    for k in range(n):
        Lkk, invLkk = diag_chol_inv(A[k][k].contiguous())
        L[k][k], Inv[k][k] = Lkk, invLkk
        half_logdet = half_logdet + torch.log(torch.diagonal(Lkk, dim1=-2, dim2=-1)).sum(-1)
        for i in range(k + 1, n):
            L[i][k] = A[i][k] @ invLkk.mT
        for i in range(k + 1, n):
            for j in range(k + 1, i + 1):
                A[i][j] = A[i][j] - L[i][k] @ L[j][k].mT

    for j in range(n):
        for i in range(j + 1, n):
            S = L[i][j] @ Inv[j][j]
            for k in range(j + 1, i):
                S = S + L[i][k] @ Inv[k][j]
            Inv[i][j] = -(Inv[i][i] @ S)

    zeros = torch.zeros((B, NB, NB), dtype=K.dtype, device=K.device)
    invL = torch.cat(
        [torch.cat([Inv[i][j] if j <= i else zeros for j in range(n)], dim=2) for i in range(n)],
        dim=1,
    )
    return invL[:, :N, :N], half_logdet


def chol_inv_batched(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N, N) SPD -> (invL (..., N, N), half_logdet (...)).

    All leading dimensions fold into the one batch of ``blocked_chol_inv``,
    so every instance of a call shares one kernel launch per diagonal block.
    """
    lead, N = K.shape[:-2], K.shape[-1]
    invL, hld = blocked_chol_inv(K.reshape(-1, N, N))
    return invL.reshape(*lead, N, N), hld.reshape(lead)
