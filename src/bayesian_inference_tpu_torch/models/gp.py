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
from bayesian_inference_tpu_torch.ops.gp_predict import gp_predict
from bayesian_inference_tpu_torch.ops.gram import (
    KernelConfig,
    KernelParams,
    cross_covariance,
    pairwise_sqdiff,
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


def lml_forward(cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, y: torch.Tensor, alpha_jitter: float):
    """(LML, alpha = K^-1 y, invL = L^-1) of a stack of GPs through the blocked
    factorisation; the last two are what ``lml_param_grads`` needs."""
    K = train_gram_from_sqdiff(cfg, params, D2, alpha_jitter)
    invL, half_logdet = chol_inv_batched(K)
    alpha = (invL.mT @ (invL @ y[..., None]))[..., 0]
    n = y.shape[-1]
    lml = -0.5 * (y * alpha).sum(-1) - half_logdet - 0.5 * n * _LOG_2PI
    return lml, alpha, invL


def lml_param_grads(
    cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, alpha: torch.Tensor, invL: torch.Tensor
) -> KernelParams:
    """dLML/d(log hyperparameters) in closed form: dLML/dK = (alpha alpha^T -
    K^{-1}) / 2, chained through the analytic dK/dtheta. Inactive fields get
    zeros."""
    Kinv = invL.mT @ invL
    G = 0.5 * (alpha[..., :, None] * alpha[..., None, :] - Kinv)
    w = torch.exp(-2.0 * params.log_length_scale)  # (..., d) = 1/ls^2
    sq = torch.einsum("ijk,...k->...ij", D2, w)
    H = G * _dK_dsq(cfg, sq)
    d_log_ls = (-2.0) * w * torch.einsum("...ij,ijk->...k", H, D2)
    zero = torch.zeros_like(params.log_noise)
    d_log_noise = torch.exp(params.log_noise) * _trace(G) if cfg.with_noise else zero
    d_log_constant = torch.exp(params.log_constant) * G.sum((-2, -1)) if cfg.with_constant else zero
    return KernelParams(d_log_ls, d_log_noise, d_log_constant)


def lml_value_and_grad(
    cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> tuple[torch.Tensor, KernelParams]:
    """(LML, dLML/d log theta) of a stack of GPs without autograd: the same
    two functions ``log_marginal_likelihood_matmul`` differentiates through,
    called one after the other on one thread and one stream (the GP fit's
    objective, which a stream capture can record)."""
    with torch.no_grad():
        lml, alpha, invL = lml_forward(cfg, params, D2, y, alpha_jitter)
        return lml, lml_param_grads(cfg, params, D2, alpha, invL)


class _LMLMatmul(torch.autograd.Function):
    """LML with the blocked factorisation forward (``lml_forward``) and the
    closed-form gradient backward (``lml_param_grads``). No Cholesky backward,
    so the diagonal-block kernel needs no backward kernel."""

    @staticmethod
    def forward(ctx, log_ls, log_noise, log_constant, D2, y, alpha_jitter, cfg):
        lml, alpha, invL = lml_forward(cfg, KernelParams(log_ls, log_noise, log_constant), D2, y, alpha_jitter)
        ctx.cfg = cfg
        ctx.save_for_backward(log_ls, log_noise, log_constant, D2, alpha, invL)
        return lml

    @staticmethod
    def backward(ctx, g):
        if g.is_cuda:
            # Autograd runs this on its own device thread, where no CUDA
            # context is current yet, and cuBLAS (the first call below) would
            # warn and bind one itself. A runtime call on the stream binds the
            # device's primary context to this thread first.
            torch.cuda.current_stream(g.device).query()
        log_ls, log_noise, log_constant, D2, alpha, invL = ctx.saved_tensors
        d = lml_param_grads(ctx.cfg, KernelParams(log_ls, log_noise, log_constant), D2, alpha, invL)
        d_y = -g[..., None] * alpha if ctx.needs_input_grad[4] else None
        return g[..., None] * d.log_length_scale, g * d.log_noise, g * d.log_constant, None, d_y, None, None


def log_marginal_likelihood_matmul(
    cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> torch.Tensor:
    """LML of a stack of GPs from precomputed ``pairwise_sqdiff(X)`` (the
    GP-fit objective); differentiable in ``params`` (closed-form backward)."""
    return _LMLMatmul.apply(
        params.log_length_scale, params.log_noise, params.log_constant, D2, y, float(alpha_jitter), cfg
    )


def log_marginal_likelihood_sqdiff(
    cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> torch.Tensor:
    """LML from precomputed ``pairwise_sqdiff(X)``, for one GP (``y`` (N,))
    or a stack (``y`` (..., N)). The JAX package keeps a library-Cholesky form
    under this name beside its matmul form; the port has the one blocked
    factorisation, so this is ``log_marginal_likelihood_matmul``."""
    return log_marginal_likelihood_matmul(cfg, params, D2, y, alpha_jitter)


def log_marginal_likelihood(
    cfg: KernelConfig, params: KernelParams, X: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> torch.Tensor:
    """LML of one GP, or a stack of GPs, on the design ``X`` (N, d);
    differentiable in ``params``. Device and dtype follow the tensors."""
    return log_marginal_likelihood_matmul(cfg, params, pairwise_sqdiff(X), y, alpha_jitter)


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


def posterior_from_params(
    cfg: KernelConfig, params: KernelParams, X: torch.Tensor, y: torch.Tensor, alpha_jitter: float
) -> GPPosterior:
    """Posterior of one GP (``params`` leaves without a batch axis, ``y``
    (N,)) or of a stack, on the design ``X`` (N, d): the JAX package's name
    for what the port computes through the blocked factorisation."""
    return posterior_from_params_matmul(cfg, params, X, y, alpha_jitter)


def posteriors_from_params_stacked(
    cfg: KernelConfig, params: KernelParams, X, Y_cols, alpha_jitter: float
) -> GPPosterior:
    """Posteriors of k GPs, one per entry of the stacked ``params`` and row of
    ``Y_cols`` (k, N), on the shared design ``X`` (N, d): what the JAX
    package's vmap of ``posterior_from_params`` over the stack gives. ``X``
    and ``Y_cols`` (tensors or arrays) are taken on the device and in the
    dtype of ``params``."""
    leaf = params.log_length_scale
    X = torch.as_tensor(X, dtype=leaf.dtype, device=leaf.device)
    Y_cols = torch.as_tensor(Y_cols, dtype=leaf.dtype, device=leaf.device)
    return posterior_from_params(cfg, params, X, Y_cols, alpha_jitter)


def predict(cfg: KernelConfig, post: GPPosterior, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at ``theta`` (B, d) of one GP -> ((B,), (B,)),
    or of a stack of k GPs -> ((k, B), (k, B)): the cross-covariance from
    explicit scaled differences (ops/gram.cross_covariance), not the shared
    squared differences of ``predict_all_shared``."""
    ks = cross_covariance(cfg, post.params, theta, post.X)  # (..., B, N)
    mean = (ks @ post.alpha[..., None])[..., 0]
    var = post.prior_var[..., None] - ((ks @ post.Kinv) * ks).sum(-1)
    return mean, torch.clamp(var, min=0.0)


def predict_all(cfg: KernelConfig, posts: GPPosterior, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``predict`` of k stacked GPs, laid out ((B, k), (B, k)) as
    ``predict_all_shared`` returns them."""
    mean, var = predict(cfg, posts, theta)
    return mean.mT, var.mT


def predict_all_shared(
    cfg: KernelConfig, posts: GPPosterior, theta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Means and variances of k stacked GPs at ``theta`` (B, d) -> ((B, k), (B, k)).

    The per-dimension squared differences to the shared design are computed
    once and contracted per GP with its length scales: on the card in one
    launch of the fused predict kernel (ops/gp_predict.py), on the CPU by its
    plain version.
    """
    return gp_predict(cfg, posts, theta)
