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
half_logdet = sum log diag L (``mvn_terms``). Its second entry,
``fused_woodbury_loglike``, is the whole Woodbury likelihood of the lowrank
mode (ops/mvn.py) in one launch: the kernel builds r = b + zG and
M = G + diag(1/v) itself and adds the rest of the likelihood after the
sweep. On a CPU tensor it runs ``mvn.woodbury_loglike_plain``.
"""

from __future__ import annotations

import math

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, check_cuda_operands, stream_handle
from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_terms
from bayesian_inference_tpu_torch.ops.mvn import WoodburyNormal, mvn_terms_dense, woodbury_loglike_plain

KERNEL = NativeKernel("tiny_mvn.cu", {"tiny_mvn_f32": [P] * 4 + [I] * 2 + [P],
                                      "tiny_mvn_woodbury_f32": [P] * 7 + [I] * 3 + [P]})
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


def woodbury_rows(wn: WoodburyNormal, z: torch.Tensor, v: torch.Tensor) -> tuple[int, int]:
    """(B, per_row) of the fused launch: B walkers, and per_row consecutive
    walkers on each row of b and c0, from the shapes alone. A (k,) b serves
    all walkers of z and v (..., k); a (P, k) b serves the rows of z and v
    (P, Wh, k), Wh walkers each. Raises on shapes the kernel does not take."""
    *lead, k = z.shape
    b = wn.b
    B = math.prod(lead)
    per_point = b.dim() == 2
    ok = (v.shape == z.shape and wn.G.shape == (k, k) and b.dim() <= 2 and b.shape[-1:] == (k,)
          and wn.c0.shape == b.shape[:-1] and wn.half_logdet_D.dim() == 0
          and (not per_point or (z.dim() == 3 and z.shape[0] == b.shape[0])))
    if not ok:
        raise ValueError(f"woodbury_loglike: shape mismatch z{tuple(z.shape)} v{tuple(v.shape)} "
                         f"G{tuple(wn.G.shape)} b{tuple(b.shape)} c0{tuple(wn.c0.shape)} "
                         f"half_logdet_D{tuple(wn.half_logdet_D.shape)}")
    per_row = z.shape[1] if per_point else max(B, 1)
    return B, per_row


def _fused_woodbury_cuda(wn: WoodburyNormal, z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, per_row = woodbury_rows(wn, z, v)
    k = z.shape[-1]
    if k > MAX_NB:
        raise ValueError(f"woodbury_loglike: the kernel takes at most {MAX_NB} PCs, got {k}")
    operands = [x.contiguous() for x in (z, v, wn.G, wn.b, wn.c0, wn.half_logdet_D)]
    check_cuda_operands("woodbury_loglike", *operands)
    loglike = torch.empty(z.shape[:-1], dtype=z.dtype, device=z.device)
    if B == 0:
        return loglike
    KERNEL.launch(
        "tiny_mvn_woodbury_f32", *(x.data_ptr() for x in operands), loglike.data_ptr(), B, k, per_row,
        stream_handle(z.device), device=z.device, batch=B,
    )
    return loglike


def fused_woodbury_loglike(wn: WoodburyNormal, z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``mvn.woodbury_loglike`` of z, v (..., k), or (P, Wh, k) with per-point
    b (P, k) and c0 (P,): one launch on the card (up to ``MAX_NB`` PCs),
    the plain chain on the CPU."""
    if z.device.type == "cpu":
        return woodbury_loglike_plain(wn, z, v)
    if z.device.type == "cuda":
        return _fused_woodbury_cuda(wn, z, v)
    raise ValueError(f"woodbury_loglike: unsupported device {z.device}")
