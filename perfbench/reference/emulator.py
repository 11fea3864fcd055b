"""PCA and Gaussian-process emulators in float64, from their definitions.

PCA: features standardised (mean, population standard deviation), singular
value decomposition, scores U S; explained variance s^2 / (n - 1) over the
first ``max_n_components_to_calculate`` components. A component's sign is
arbitrary; nothing compared depends on it.

The arithmetic runs in the precision of the design tensor (float64 for the
reference; the control runs the same code a precision lower).

GP per principal component (scikit-learn's GaussianProcessRegressor with a
Matern(nu) * 1 + WhiteKernel kernel and jitter alpha, normalize_y False):
K = Matern(X / ls) + (noise + alpha) I; LML = -y^T K^-1 y / 2 - log det K / 2
- n log(2 pi) / 2; predictive mean k*^T K^-1 y and variance
1 + noise - k*^T K^-1 k* (the white noise is in the prior variance, alpha is
not), clipped at 0.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F64 = torch.float64


@dataclasses.dataclass
class PCA:
    mean: np.ndarray
    scale: np.ndarray
    components: np.ndarray          # (n_comp, F)
    explained_variance: np.ndarray  # (n_comp,)
    scores: np.ndarray              # (n_train, n_comp)


def pca(Y: np.ndarray, max_components: int) -> PCA:
    Y = np.asarray(Y, np.float64)
    mean = Y.mean(axis=0)
    scale = Y.std(axis=0)
    scale[scale == 0.0] = 1.0
    U, s, Vt = np.linalg.svd((Y - mean) / scale, full_matrices=False)
    k = min(max_components, s.shape[0])
    return PCA(mean, scale, Vt[:k], (s**2 / (Y.shape[0] - 1))[:k], (U * s)[:, :k])


def matern(r: torch.Tensor, nu: float) -> torch.Tensor:
    """Matern correlation at scaled distance r."""
    if nu == 0.5:
        return torch.exp(-r)
    if nu == 1.5:
        t = math.sqrt(3.0) * r
        return (1.0 + t) * torch.exp(-t)
    if nu == 2.5:
        t = math.sqrt(5.0) * r
        return (1.0 + t + t * t / 3.0) * torch.exp(-t)
    raise ValueError(f"Matern nu={nu} is not one of 0.5, 1.5, 2.5")


def scaled_distance(A: torch.Tensor, B: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """||(a - b) / ls|| for A (n, d), B (m, d), length scales ls (..., d) -> (..., n, m)."""
    diff = A[:, None, :] - B[None, :, :]
    return torch.sqrt(torch.einsum("nmd,...d->...nm", diff * diff, 1.0 / (ls * ls)))


@dataclasses.dataclass
class GPs:
    """k GPs on one design: log length scales (k, d), log noise (k,)."""

    nu: float
    alpha_jitter: float
    X: torch.Tensor       # (N, d)
    y: torch.Tensor       # (k, N) training targets (PC scores)
    log_ls: torch.Tensor  # (k, d)
    log_noise: torch.Tensor  # (k,)

    def gram(self, log_ls=None, log_noise=None) -> torch.Tensor:
        log_ls = self.log_ls if log_ls is None else log_ls
        log_noise = self.log_noise if log_noise is None else log_noise
        K = matern(scaled_distance(self.X, self.X, torch.exp(log_ls)), self.nu)
        eye = torch.eye(self.X.shape[0], dtype=self.X.dtype, device=self.X.device)
        return K + (torch.exp(log_noise) + self.alpha_jitter)[..., None, None] * eye

    def lml(self, log_ls=None, log_noise=None, y=None) -> torch.Tensor:
        """Log marginal likelihood of each GP (of a batch of hyperparameters
        sharing the leading axes of ``log_ls``)."""
        y = self.y if y is None else y
        L = torch.linalg.cholesky(self.gram(log_ls, log_noise))
        a = torch.cholesky_solve(y[..., None], L)[..., 0]
        n = y.shape[-1]
        return (-0.5 * (y * a).sum(-1) - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
                - 0.5 * n * math.log(2.0 * math.pi))

    def posterior(self):
        """(K^-1 y (k, N), K^-1 (k, N, N))."""
        L = torch.linalg.cholesky(self.gram())
        eye = torch.eye(self.X.shape[0], dtype=self.X.dtype, device=self.X.device).expand_as(L)
        Kinv = torch.cholesky_solve(eye, L)
        return torch.cholesky_solve(self.y[..., None], L)[..., 0], Kinv

    def predictor(self):
        alpha, Kinv = self.posterior()
        ls = torch.exp(self.log_ls)
        prior_var = 1.0 + torch.exp(self.log_noise)

        def predict(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            """theta (B, d) -> means and variances (B, k)."""
            ks = matern(scaled_distance(theta, self.X, ls), self.nu)  # (k, B, N)
            mean = torch.einsum("kbn,kn->bk", ks, alpha)
            var = prior_var[None, :] - torch.einsum("kbn,knm,kbm->bk", ks, Kinv, ks)
            return mean, torch.clamp(var, min=0.0)

        return predict
