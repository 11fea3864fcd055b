"""Gaussian-process regression: log marginal likelihood, posterior, predict.

Port of ``bayesian_inference_tpu.models.gp`` (the matmul path the JAX package
runs on the TPU). Conventions match sklearn's GaussianProcessRegressor
(normalize_y=False):

  LML(theta_h) = -1/2 y^T K^-1 y - sum(log diag L) - n/2 log 2pi,
  K = kernel(X) + alpha * I
  predict mean = k*^T K^-1 y ; var = kernel.diag - k*^T K^-1 k* (clipped at 0)

Every function takes a stack of GPs (leading batch dimensions on the
``KernelParams`` leaves and on ``y``) in one call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from bayesian_inference_tpu_torch.ops.blocked_cholesky import chol_inv_batched
from bayesian_inference_tpu_torch.ops.gram import (
    KernelConfig,
    KernelParams,
    matern_from_sqdist,
    prior_variance,
    train_gram,
    train_gram_from_sqdiff,
)

_LOG_2PI = 1.8378770664093453


def _dK_dsq(cfg: KernelConfig, sq: torch.Tensor) -> torch.Tensor:
    """d(kernel)/d(scaled squared distance), elementwise, with the same sqrt
    guard as ops/gram.matern_from_sqdist. The diagonal's unbounded nu=0.5
    value is always contracted against a zero squared difference."""
    if cfg.nu is None:
        return -0.5 * torch.exp(-0.5 * sq)
    d = torch.sqrt(sq + 1e-36)
    if cfg.nu == 0.5:
        return -torch.exp(-d) / (2.0 * d)
    if cfg.nu == 1.5:
        return -1.5 * torch.exp(-math.sqrt(3.0) * d)
    if cfg.nu == 2.5:
        t = math.sqrt(5.0) * d
        return -(5.0 / 6.0) * (1.0 + t) * torch.exp(-t)
    raise ValueError(f"Unsupported Matern nu={cfg.nu}")


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


class _LMLMatmul(torch.autograd.Function):
    """LML with the blocked factorisation forward and the closed-form
    gradient backward: dLML/dK = (alpha alpha^T - K^{-1}) / 2, chained through
    the analytic dK/dtheta. No Cholesky backward, so the diagonal-block kernel
    needs no backward kernel."""

    @staticmethod
    def forward(ctx, log_ls, log_noise, log_constant, D2, y, alpha_jitter, cfg):
        params = KernelParams(log_ls, log_noise, log_constant)
        K = train_gram_from_sqdiff(cfg, params, D2, alpha_jitter)
        invL, half_logdet = chol_inv_batched(K)
        alpha = (invL.mT @ (invL @ y[..., None]))[..., 0]
        n = y.shape[-1]
        lml = -0.5 * (y * alpha).sum(-1) - half_logdet - 0.5 * n * _LOG_2PI
        ctx.cfg = cfg
        ctx.save_for_backward(log_ls, log_noise, log_constant, D2, alpha, invL)
        return lml

    @staticmethod
    def backward(ctx, g):
        log_ls, log_noise, log_constant, D2, alpha, invL = ctx.saved_tensors
        cfg = ctx.cfg
        Kinv = invL.mT @ invL
        G = 0.5 * (alpha[..., :, None] * alpha[..., None, :] - Kinv)
        w = torch.exp(-2.0 * log_ls)  # (..., d) = 1/ls^2
        sq = torch.einsum("ijk,...k->...ij", D2, w)
        H = G * _dK_dsq(cfg, sq)
        d_log_ls = g[..., None] * (-2.0) * w * torch.einsum("...ij,ijk->...k", H, D2)
        zero = torch.zeros_like(log_noise)
        d_log_noise = g * torch.exp(log_noise) * _trace(G) if cfg.with_noise else zero
        d_log_constant = g * torch.exp(log_constant) * G.sum((-2, -1)) if cfg.with_constant else zero
        d_y = -g[..., None] * alpha if ctx.needs_input_grad[4] else None
        return d_log_ls, d_log_noise, d_log_constant, None, d_y, None, None


def log_marginal_likelihood_matmul(
    cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> torch.Tensor:
    """LML of a stack of GPs from precomputed ``pairwise_sqdiff(X)`` (the
    GP-fit objective); differentiable in ``params`` (closed-form backward)."""
    return _LMLMatmul.apply(
        params.log_length_scale, params.log_noise, params.log_constant, D2, y, float(alpha_jitter), cfg
    )


@dataclass
class GPPosterior:
    """Cached factorisation of a stack of k GPs for batched prediction.

    ``Kinv`` is materialized so the predictive variance k** - k*^T Kinv k* is
    a batched matmul in the sampler. ``X`` is the one (N, d) design matrix all
    stacked GPs share.
    """

    params: KernelParams
    X: torch.Tensor          # (N, d)
    alpha: torch.Tensor      # (k, N)   K^-1 y
    Kinv: torch.Tensor       # (k, N, N)
    prior_var: torch.Tensor  # (k,)
    lml: torch.Tensor        # (k,)


def posterior_from_params_matmul(
    cfg: KernelConfig, params: KernelParams, X: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> GPPosterior:
    """Posterior of the GPs stacked on ``params``' leading axis, all on the
    design ``X`` (N, d), targets ``y`` (k, N), via the blocked factorisation."""
    K = train_gram(cfg, params, X, alpha_jitter)
    invL, half_logdet = chol_inv_batched(K)
    Kinv = invL.mT @ invL
    alpha = (Kinv @ y[..., None])[..., 0]
    n = y.shape[-1]
    lml = -0.5 * (y * alpha).sum(-1) - half_logdet - 0.5 * n * _LOG_2PI
    return GPPosterior(
        params=params, X=X, alpha=alpha, Kinv=Kinv, prior_var=prior_variance(cfg, params), lml=lml,
    )


def predict_all_shared(
    cfg: KernelConfig, posts: GPPosterior, theta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Means and variances of k stacked GPs at ``theta`` (B, d) -> ((B, k), (B, k)).

    The per-dimension squared differences to the shared design are computed
    once and contracted per GP with its length scales.
    """
    diff = theta[:, None, :] - posts.X[None, :, :]                 # (B, N, d)
    D2 = diff * diff
    w = torch.exp(-2.0 * posts.params.log_length_scale)            # (k, d)
    sq = torch.einsum("bnd,kd->kbn", D2, w)
    ks = matern_from_sqdist(sq, cfg.nu)                            # (k, B, N)
    if cfg.with_constant:
        ks = ks + torch.exp(posts.params.log_constant)[:, None, None]
    mean = torch.einsum("kbn,kn->bk", ks, posts.alpha)
    t = ks @ posts.Kinv                                            # (k, B, N)
    var = posts.prior_var[None, :] - torch.einsum("kbn,kbn->bk", t, ks)
    return mean, torch.clamp(var, min=0.0)
