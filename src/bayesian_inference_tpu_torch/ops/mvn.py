"""Batched multivariate-normal log-likelihood: dense and Woodbury low-rank.

Port of ``bayesian_inference_tpu.ops.mvn``. logp = -1/2 y^T C^-1 y
- 1/2 log det C; the -n/2 log 2pi constant is dropped.

The Woodbury path uses the structure of the MCMC covariance

    C(theta) = D + U diag(v(theta)) U^T

with D = Sigma_unexplained + diag(sigma_data^2) constant and dense and U
(n_features, k) of rank k = n_pc. One Cholesky of D, once, reduces every
walker's likelihood from O(F^3) to O(k^3): the only per-walker factorisation
is that of the k x k capacitance matrix M = G + diag(1/v), done by the
tiny-MVN kernel (ops/tiny_mvn.py). It is an exact identity, not an
approximation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_terms


def mvn_terms_dense(dY: torch.Tensor, cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(quad, half_logdet) of (..., F) residuals and (..., F, F) covariances.

    Small trailing dimensions use the unrolled factorisation, larger ones the
    library Cholesky (a host-side path: on CUDA no kernel wrapper reaches it).
    A matrix that is not positive definite gives NaN.
    """
    if cov.shape[-1] <= 32:
        return tiny_mvn_terms(dY, cov)
    L, info = torch.linalg.cholesky_ex(cov)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    e = torch.linalg.solve_triangular(L, dY[..., None], upper=False)[..., 0]
    return (e * e).sum(-1), torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def mvn_loglike_dense(dY: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Unnormalized MVN loglike for (..., F) residuals and (..., F, F) covariances."""
    quad, half_logdet = mvn_terms_dense(dY, cov)
    return -0.5 * quad - half_logdet


@dataclass
class WoodburyNormal:
    """Precomputed pieces of the low-rank-plus-constant Gaussian likelihood.

    With e0 = L_D^{-1} d0 (d0 = constant part of the residual) and
    W = L_D^{-1} U:

      quad(z, v) = c0 + 2 b.z + z.G.z - (b + G z)^T (diag(1/v) + G)^{-1} (b + G z)
      logdet(v)  = 2*half_logdet_D + sum(log v) + logdet(diag(1/v) + G)

    Only (b, c0, d0) depend on the data vector; ``with_d0`` rebuilds them for
    new data vectors (closure pseudodata) against the cached factor. After a
    ``with_d0`` of a (P, F) batch, b is (P, k), c0 (P,) and d0 (P, F): one
    set per point of a batched closure run.
    """

    b: torch.Tensor              # (k,)    W^T e0
    G: torch.Tensor              # (k, k)  W^T W = U^T D^-1 U
    c0: torch.Tensor             # ()      e0^T e0
    half_logdet_D: torch.Tensor  # ()
    U: torch.Tensor              # (F, k)
    d0: torch.Tensor             # (F,)    constant residual offset (m0 - y_data)
    L_D: torch.Tensor            # (F, F)  Cholesky factor of the constant covariance
    W: torch.Tensor              # (F, k)  L_D^{-1} U

    def with_d0(self, d0: torch.Tensor) -> "WoodburyNormal":
        """The same likelihood for the residual offset ``d0``: (F,), or (P, F)
        for one offset per point. Each point's (b, c0) comes from the formulas
        of ``build_woodbury`` applied to its own row, so a batched closure
        evaluation matches a per-point build."""
        if d0.dim() == 1:
            b, c0 = _data_pieces(self.L_D, self.W, d0)
        else:
            b, c0 = (torch.stack(x) for x in zip(*(_data_pieces(self.L_D, self.W, row) for row in d0)))
        return dataclasses.replace(self, b=b, c0=c0, d0=d0)


def _data_pieces(L_D: torch.Tensor, W: torch.Tensor, d0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, c0) = (W^T e0, e0^T e0) with e0 = L_D^-1 d0, for one (F,) offset."""
    e0 = torch.linalg.solve_triangular(L_D, d0[:, None], upper=False)[:, 0]
    return W.T @ e0, e0 @ e0


def build_woodbury(D: torch.Tensor, U: torch.Tensor, d0: torch.Tensor) -> WoodburyNormal:
    """One-time O(F^3) setup (library Cholesky and triangular solves);
    everything per walker afterwards is O(k^3)."""
    L_D = torch.linalg.cholesky(D)
    W = torch.linalg.solve_triangular(L_D, U, upper=False)
    b, c0 = _data_pieces(L_D, W, d0)
    return WoodburyNormal(
        b=b, G=W.T @ W, c0=c0, half_logdet_D=torch.log(torch.diagonal(L_D)).sum(),
        U=U, d0=d0, L_D=L_D, W=W,
    )


def woodbury_loglike(wn: WoodburyNormal, z: torch.Tensor, v: torch.Tensor, terms=None) -> torch.Tensor:
    """Loglike of PC-space means and variances z, v (..., k).

    With per-point pieces (b of shape (P, k)), z and v are (P, Wh, k). The
    capacitance term +1/2 r^T M^-1 r - 1/2 log det M, with r = b + G z and
    M = G + diag(1/v), is one sweep of the tiny-MVN kernel over all walkers
    (+quad/2 - half_logdet of (r, M)); the JAX package needs two calls of its
    kernel for it (2 loglike(0, M) - loglike(r, M)). ``terms``: another
    function of (r, M) giving (quad, half_logdet) in the kernel's place.
    """
    from bayesian_inference_tpu_torch.ops.tiny_mvn import mvn_terms

    terms = terms or mvn_terms
    b, c0 = wn.b, wn.c0
    if b.dim() == 2:
        b, c0 = b[:, None, :], c0[:, None]
    zG = z @ wn.G
    M = wn.G + torch.diag_embed(1.0 / v)
    quad_M, half_logdet_M = terms(b + zG, M)
    rest = (
        c0
        + 2.0 * (b * z).sum(-1)
        + (zG * z).sum(-1)
        + 2.0 * wn.half_logdet_D
        + torch.log(v).sum(-1)
    )
    return 0.5 * quad_M - half_logdet_M - 0.5 * rest
