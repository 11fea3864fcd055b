"""Batched tiny-MVN log-likelihood of given residuals and covariances.

Counterpart of ``bayesian_inference_tpu.ops.pallas_mvn.block_mvn_loglike``
(which reaches the Pallas kernel ``_mvn_kernel``), with the same arguments
and result. On a CPU tensor it runs the plain version (the unrolled
factorisation, or, as the JAX package does, the dense path for blocks wider
than ``DENSE_ABOVE``); on a CUDA tensor it launches ``csrc/tiny_mvn.cu`` for
blocks up to ``MAX_NB`` wide (or raises), and takes the dense path for wider
ones, where the JAX package is dense too: the choice is made by shape,
before any launch.

The kernel returns both terms of the sweep, quad = |L^-1 dY|^2 and
half_logdet = sum log diag L, so the Woodbury likelihood (ops/mvn.py) takes
its capacitance term from one launch (``mvn_terms``).
"""

from __future__ import annotations

import math

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, check_cuda_operands, stream_handle
from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_terms
from bayesian_inference_tpu_torch.ops.mvn import mvn_terms_dense

KERNEL = NativeKernel("tiny_mvn.cu", {"tiny_mvn_f32": [P] * 4 + [I] * 2 + [P]})
MAX_NB = 64       # the widest block the CUDA kernel takes; wider ones go dense on the card
DENSE_ABOVE = 48  # the JAX package's block_mvn_loglike goes dense above this width


def mvn_terms_plain(dY: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: (quad, half_logdet) by the
    unrolled factorisation, or by the dense path above ``DENSE_ABOVE``."""
    if C.shape[-1] > DENSE_ABOVE:
        return mvn_terms_dense(dY, C)
    return tiny_mvn_terms(dY, C)


def _mvn_terms_cuda(dY: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    *lead, nb = dY.shape
    if C.shape != (*lead, nb, nb):
        raise ValueError(f"block_mvn: shape mismatch dY{tuple(dY.shape)} C{tuple(C.shape)}")
    check_cuda_operands("block_mvn", dY, C)
    if nb > MAX_NB:
        return mvn_terms_dense(dY, C)
    quad = torch.empty(lead, dtype=dY.dtype, device=dY.device)
    half_logdet = torch.empty_like(quad)
    KERNEL.launch(
        "tiny_mvn_f32", dY.data_ptr(), C.data_ptr(), quad.data_ptr(), half_logdet.data_ptr(),
        math.prod(lead), nb, stream_handle(dY.device), device=dY.device,
    )
    return quad, half_logdet


def mvn_terms(dY: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(quad, half_logdet) of (..., nb) residuals and (..., nb, nb) covariances."""
    if dY.device.type == "cpu":
        return mvn_terms_plain(dY, C)
    if dY.device.type == "cuda":
        return _mvn_terms_cuda(dY, C)
    raise ValueError(f"block_mvn_loglike: unsupported device {dY.device}")


def block_mvn_plain(dY: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The plain version of ``block_mvn_loglike``."""
    quad, half_logdet = mvn_terms_plain(dY, C)
    return -0.5 * quad - half_logdet


def block_mvn_loglike(dY: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """MVN loglike -quad/2 - half_logdet for (..., nb) residuals and
    (..., nb, nb) covariances; returns the leading shape."""
    quad, half_logdet = mvn_terms(dY, C)
    return -0.5 * quad - half_logdet
