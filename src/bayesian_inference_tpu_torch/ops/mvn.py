"""Batched dense multivariate-normal log-likelihood (port of
``bayesian_inference_tpu.ops.mvn.mvn_loglike_dense``).

logp = -1/2 y^T C^-1 y - 1/2 log det C; the -n/2 log 2pi constant is dropped.
The Woodbury (lowrank) path of the JAX module is not ported yet.
"""

from __future__ import annotations

import torch

from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_loglike


def mvn_loglike_dense(dY: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Unnormalized MVN loglike for (..., F) residuals and (..., F, F) covariances.

    Small trailing dimensions use the unrolled factorisation, larger ones the
    library Cholesky (a host-side path: on CUDA the block likelihood never
    reaches it, see ops/fused_mvn.py).
    """
    if cov.shape[-1] <= 32:
        return tiny_mvn_loglike(dY, cov)
    L, info = torch.linalg.cholesky_ex(cov)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    e = torch.linalg.solve_triangular(L, dY[..., None], upper=False)[..., 0]
    quad = (e * e).sum(-1)
    half_logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * quad - half_logdet
