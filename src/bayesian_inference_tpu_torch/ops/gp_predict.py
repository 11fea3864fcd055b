"""Means and variances of k stacked GPs on one shared design, at B points.

The JAX package computes this in ``bayesian_inference_tpu.models.gp.
predict_all_shared`` as a few einsums that XLA fuses (it has no Pallas
kernel). Here it is ``csrc/gp_predict.cu`` (K5): the cross-covariance, the
mean and the variance k** - k*^T K^-1 k* in one launch, with the
cross-covariance kept on the chip. ``models/gp.predict_all_shared`` routes
through ``gp_predict``: on CPU tensors it runs ``gp_predict_plain`` (the
library and elementwise calls), on CUDA tensors it launches the kernel or
raises. The kernel takes float32 operands, any number of PCs and points, up
to 16 input dimensions and designs of up to 1,279 points (its shared-memory
tile); it refuses more.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, check_cuda_operands, stream_handle
from bayesian_inference_tpu_torch.ops.gram import KernelConfig, matern_from_sqdist

if TYPE_CHECKING:
    from bayesian_inference_tpu_torch.models.gp import GPPosterior

KERNEL = NativeKernel("gp_predict.cu", {"gp_predict_f32": [P] * 9 + [I] * 6 + [P]})
_NU_CODE = {None: 0, 0.5: 1, 1.5: 3, 2.5: 5}


def gp_predict_plain(cfg: KernelConfig, posts: GPPosterior, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the per-dimension squared differences to the
    shared design once, contracted per GP with its length scales."""
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


def _gp_predict_cuda(cfg: KernelConfig, posts: GPPosterior, theta: torch.Tensor):
    if cfg.nu not in _NU_CODE:
        raise ValueError(f"Unsupported Matern nu={cfg.nu} (use 0.5, 1.5, 2.5, or None for RBF)")
    log_ls, log_c = posts.params.log_length_scale, posts.params.log_constant
    X, alpha, Kinv, prior_var = posts.X, posts.alpha, posts.Kinv, posts.prior_var
    if theta.dim() != 2 or alpha.dim() != 2:
        raise ValueError(f"gp_predict: theta {tuple(theta.shape)}, alpha {tuple(alpha.shape)}; the kernel takes "
                         "(B, d) points and (k, N) weights")
    (B, d), (k, N) = theta.shape, alpha.shape
    shapes = {"X": (X, (N, d)), "log_length_scale": (log_ls, (k, d)), "log_constant": (log_c, (k,)),
              "Kinv": (Kinv, (k, N, N)), "prior_var": (prior_var, (k,))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"gp_predict: {name} {tuple(x.shape)}, expected {shape} for theta {tuple(theta.shape)} "
                             f"and alpha {tuple(alpha.shape)}")
    operands = [x.contiguous() for x in (theta, X, log_ls, log_c, alpha, Kinv, prior_var)]
    check_cuda_operands("gp_predict", *operands)
    mean = torch.empty((B, k), dtype=theta.dtype, device=theta.device)
    var = torch.empty_like(mean)
    if B == 0:
        return mean, var
    KERNEL.launch(
        "gp_predict_f32", *(x.data_ptr() for x in operands), mean.data_ptr(), var.data_ptr(), B, N, d, k,
        _NU_CODE[cfg.nu], int(cfg.with_constant), stream_handle(theta.device), device=theta.device, batch=B,
    )
    return mean, var


def gp_predict(cfg: KernelConfig, posts: GPPosterior, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Means and variances of the k GPs stacked on ``posts`` (design ``posts.X``
    (N, d) shared by all) at ``theta`` (B, d) -> ((B, k), (B, k)), the
    variance clamped at 0."""
    if theta.device.type == "cpu":
        return gp_predict_plain(cfg, posts, theta)
    if theta.device.type == "cuda":
        return _gp_predict_cuda(cfg, posts, theta)
    raise ValueError(f"gp_predict: unsupported device {theta.device}")
