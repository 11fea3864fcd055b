"""Stationary GP kernels (Matern / RBF + optional constant + white noise).

Port of ``bayesian_inference_tpu.ops.gram`` with sklearn's semantics:

  - anisotropic (ARD) length scales: d(x,y) = ||(x - y)/ls||_2
  - Matern nu in {0.5, 1.5, 2.5}; nu=None means RBF (exp(-d^2/2))
  - ConstantKernel adds a constant everywhere (sum kernel)
  - WhiteKernel contributes noise_level * I on the training Gram and to the
    prior (diagonal) variance, but zero to cross-covariance

``KernelParams`` leaves may carry leading batch dimensions (one GP per
principal component, times restarts during the fit); every function here
broadcasts over them, so a stack of GPs is one call, not a loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class KernelConfig:
    """Static kernel structure (hashable)."""

    nu: float | None = 1.5  # None => RBF
    with_noise: bool = True
    with_constant: bool = False


@dataclass
class KernelParams:
    """Log-space kernel hyperparameters. Inactive fields (per KernelConfig)
    are carried as zeros and ignored."""

    log_length_scale: torch.Tensor  # (..., ndim)
    log_noise: torch.Tensor         # (...,)  white-noise level (variance), log
    log_constant: torch.Tensor      # (...,)  constant kernel value, log

    @classmethod
    def create(cls, length_scale, noise=1.0, constant=1.0, device="cuda", dtype: torch.dtype | None = None) -> "KernelParams":
        """Log-space parameters from natural-scale values (numbers, arrays or
        tensors), as tensors on ``device`` (float32 on CUDA, float64 on the
        CPU when ``dtype`` is None)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: torch finds no CUDA device; pass device='cpu' to run on the CPU")
        dtype = dtype or (torch.float64 if device.type == "cpu" else torch.float32)

        def log(x):
            return torch.log(torch.as_tensor(x, dtype=dtype, device=device))

        return cls(log_length_scale=log(length_scale), log_noise=log(noise), log_constant=log(constant))


def _scaled_sqdist(X1: torch.Tensor, X2: torch.Tensor, length_scale: torch.Tensor) -> torch.Tensor:
    """||(x-y)/ls||^2 for all pairs; (..., n1, n2).

    Computed from explicit differences, never as a^2 + b^2 - 2ab: the expansion
    cancels catastrophically in float32 when pair distances are small next to
    the coordinates, and that noise reaches the GP mean through K^{-1} y.
    """
    A = X1 / length_scale[..., None, :]
    B = X2 / length_scale[..., None, :]
    diff = A[..., :, None, :] - B[..., None, :, :]
    return (diff * diff).sum(-1)


def pairwise_sqdiff(X: torch.Tensor) -> torch.Tensor:
    """Per-dimension squared differences (x_ik - x_jk)^2; (n, n, ndim).

    Shared by every fit instance: an instance's scaled squared distance is the
    contraction ``einsum('ijk,k->ij', D2, 1/ls^2)``.
    """
    diff = X[:, None, :] - X[None, :, :]
    return diff * diff


def _sqdist_from_sqdiff(D2: torch.Tensor, length_scale: torch.Tensor) -> torch.Tensor:
    w = 1.0 / (length_scale * length_scale)
    return torch.einsum("ijk,...k->...ij", D2, w)


def matern_from_sqdist(sq: torch.Tensor, nu: float | None) -> torch.Tensor:
    """Covariance from squared scaled distance. nu=None selects RBF."""
    if nu is None:
        return torch.exp(-0.5 * sq)
    # sqrt is non-differentiable at 0; the guard keeps the diagonal finite.
    d = torch.sqrt(sq + 1e-36)
    if nu == 0.5:
        return torch.exp(-d)
    if nu == 1.5:
        t = math.sqrt(3.0) * d
        return (1.0 + t) * torch.exp(-t)
    if nu == 2.5:
        t = math.sqrt(5.0) * d
        return (1.0 + t + t * t / 3.0) * torch.exp(-t)
    raise ValueError(f"Unsupported Matern nu={nu} (use 0.5, 1.5, 2.5, or None for RBF)")


def _add_diag(K: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + diag[..., None, None] * eye


def _white_diag(cfg: KernelConfig, params: KernelParams, alpha_jitter, like: torch.Tensor) -> torch.Tensor:
    """noise_level + alpha per GP. The jitter enters as a scalar operand, not
    as a tensor made from a host value, so a stream capture can record it."""
    if cfg.with_noise:
        return torch.exp(params.log_noise) + alpha_jitter
    return torch.full((), alpha_jitter, dtype=like.dtype, device=like.device)


def train_gram_from_sqdiff(
    cfg: KernelConfig, params: KernelParams, D2: torch.Tensor, alpha_jitter=0.0
) -> torch.Tensor:
    """Training Gram from precomputed pairwise_sqdiff(X) (fit hot path)."""
    ls = torch.exp(params.log_length_scale)
    K = matern_from_sqdist(_sqdist_from_sqdiff(D2, ls), cfg.nu)
    if cfg.with_constant:
        K = K + torch.exp(params.log_constant)[..., None, None]
    return _add_diag(K, _white_diag(cfg, params, alpha_jitter, K))


def cross_covariance(cfg: KernelConfig, params: KernelParams, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """k(X1, X2) without the white-noise term; (..., n1, n2)."""
    ls = torch.exp(params.log_length_scale)
    K = matern_from_sqdist(_scaled_sqdist(X1, X2, ls), cfg.nu)
    if cfg.with_constant:
        K = K + torch.exp(params.log_constant)[..., None, None]
    return K


def train_gram(cfg: KernelConfig, params: KernelParams, X: torch.Tensor, alpha_jitter=0.0) -> torch.Tensor:
    """Full training Gram: k(X, X) + (noise_level + alpha) * I."""
    K = cross_covariance(cfg, params, X, X)
    return _add_diag(K, _white_diag(cfg, params, alpha_jitter, K))


def prior_variance(cfg: KernelConfig, params: KernelParams, dtype: torch.dtype | None = None) -> torch.Tensor:
    """kernel.diag(x) for any x: 1 from Matern/RBF, plus the constant and
    white-noise levels when active (GPR's alpha is excluded, as in sklearn).
    ``dtype``: the precision of the unit term, and so of the result when it
    is wider than the parameters' (the parameters' own when None)."""
    v = torch.ones_like(params.log_noise, dtype=dtype)
    if cfg.with_constant:
        v = v + torch.exp(params.log_constant)
    if cfg.with_noise:
        v = v + torch.exp(params.log_noise)
    return v
