"""Fused block-MVN log-likelihood: residual and covariance assembly, Cholesky
and log-likelihood of every (walker, observable block) pair in one kernel.

Counterpart of ``bayesian_inference_tpu.ops.pallas_mvn.fused_block_mvn_loglike``
with the same arguments and result. On a CPU tensor it runs the plain composed
path (einsum assembly + the unrolled factorisation); on a CUDA tensor it
launches ``csrc/fused_block_mvn.cu`` or raises. The kernel takes any walker
count, so one kernel serves both of the JAX package's regimes (W <= 64 and
W > 64).

A batched closure run gives every point its own residual offsets: d0 is then
(P, n_obs, nb) and the walkers (W = P * Wh) are laid out point-major, as the
JAX package's ``vmap`` over the kernel would see them.
"""

from __future__ import annotations

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, check_cuda_operands, stream_handle
from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_loglike
from bayesian_inference_tpu_torch.ops.mvn import mvn_loglike_dense

KERNEL = NativeKernel("fused_block_mvn.cu", {"fused_block_mvn_f32": [P] * 7 + [I] * 5 + [P]})
MAX_NB = 48


def fused_block_mvn_plain(U, D, d0, z, v) -> torch.Tensor:
    """The plain PyTorch version: composed assembly + unrolled factorisation
    (the library Cholesky for blocks wider than ``MAX_NB``)."""
    dY = torch.einsum("bfk,wk->wbf", U, z)
    if d0.dim() == 3:  # per-point offsets, walkers point-major
        dY = (dY.reshape(d0.shape[0], -1, *d0.shape[1:]) + d0[:, None]).reshape(dY.shape)
    else:
        dY = d0 + dY
    C = D + torch.einsum("bfk,wk,bgk->wbfg", U, v, U)
    if U.shape[1] > MAX_NB:
        return mvn_loglike_dense(dY, C).sum(-1)
    return tiny_mvn_loglike(dY, C).sum(-1)


def _fused_block_mvn_cuda(U, D, d0, z, v) -> torch.Tensor:
    n_obs, nb, k = U.shape
    W = z.shape[0]
    n_points = d0.shape[0] if d0.dim() == 3 else 1
    if nb > MAX_NB:
        raise ValueError(
            f"fused_block_mvn: block width {nb} > {MAX_NB} has no CUDA kernel yet (ROADMAP queue 2)"
        )
    if (D.shape != (n_obs, nb, nb) or d0.shape[-2:] != (n_obs, nb) or d0.dim() > 3 or W % n_points
            or z.shape != (W, k) or v.shape != (W, k)):
        raise ValueError(
            f"fused_block_mvn: shape mismatch U{tuple(U.shape)} D{tuple(D.shape)} "
            f"d0{tuple(d0.shape)} z{tuple(z.shape)} v{tuple(v.shape)}"
        )
    check_cuda_operands("fused_block_mvn", U, D, d0, z, v)
    ll_blk = torch.empty((n_obs, W), dtype=U.dtype, device=U.device)
    out = torch.empty((W,), dtype=U.dtype, device=U.device)
    KERNEL.launch(
        "fused_block_mvn_f32",
        U.data_ptr(), D.data_ptr(), d0.data_ptr(), z.data_ptr(), v.data_ptr(),
        ll_blk.data_ptr(), out.data_ptr(), n_obs, nb, k, W, W // n_points, stream_handle(U.device),
    )
    return out


def fused_block_mvn_loglike(U, D, d0, z, v) -> torch.Tensor:
    """Sum over blocks of the block-MVN log-likelihood, per walker.

    Inputs: padded block tensors U (n_obs, nb, k), D (n_obs, nb, nb),
    d0 (n_obs, nb) or (P, n_obs, nb) (see mcmc/likelihood.build_likelihood)
    and per-walker PC means/variances z, v (W, k), W = P * Wh point-major.
    Returns (W,).
    """
    if U.device.type == "cpu":
        return fused_block_mvn_plain(U, D, d0, z, v)
    if U.device.type == "cuda":
        return _fused_block_mvn_cuda(U, D, d0, z, v)
    raise ValueError(f"fused_block_mvn_loglike: unsupported device {U.device}")
