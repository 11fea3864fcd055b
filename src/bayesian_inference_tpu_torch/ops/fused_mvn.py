"""Fused block-MVN log-likelihood: residual and covariance assembly, Cholesky
and log-likelihood of every (walker, observable block) pair in one kernel.

Counterpart of ``bayesian_inference_tpu.ops.pallas_mvn.fused_block_mvn_loglike``
with the same arguments and result, plus ``fused_block_mvn_loglike_buckets``,
which takes the likelihood's width buckets together: on the card that is one
launch of ``csrc/fused_block_mvn.cu`` for all of them (and one of its
fixed-order sum), where the JAX package makes one call per bucket. On CPU
tensors both run the plain composed path (einsum assembly + the unrolled
factorisation); on CUDA tensors they launch the kernel or raise. The kernel
takes any walker count and any number of PCs, so one kernel serves both of
the JAX package's regimes (W <= 64 and W > 64).

Buckets wider than ``MAX_NB`` go to the dense path (composed assembly and
the library Cholesky) on either device, exactly where the JAX package's
``fused_block_mvn_loglike`` goes dense; the choice is made by shape before
any launch, and their sums are added, in bucket order, to the one launch's.

A batched closure run gives every point its own residual offsets: d0 is then
(P, n_obs, nb) and the walkers (W = P * Wh) are laid out point-major, as the
JAX package's ``vmap`` over the kernel would see them.
"""

from __future__ import annotations

import ctypes

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, check_cuda_operands, stream_handle
from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_loglike
from bayesian_inference_tpu_torch.ops.mvn import mvn_loglike_dense

KERNEL = NativeKernel("fused_block_mvn.cu", {"fused_block_mvn_buckets_f32": [I] + [P] * 9 + [I] * 3 + [P]})
MAX_NB = 48       # the widest bucket the CUDA kernel takes; wider ones go dense, as in the JAX package
MAX_BUCKETS = 8


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


def fused_block_mvn_buckets_plain(Us, Ds, d0s, z, v) -> torch.Tensor:
    """The plain version of the all-bucket call: the buckets' plain sums, added in bucket order."""
    ll = None
    for U, D, d0 in zip(Us, Ds, d0s):
        term = fused_block_mvn_plain(U, D, d0, z, v)
        ll = term if ll is None else ll + term
    return ll


def _fused_block_mvn_cuda(Us, Ds, d0s, z, v) -> torch.Tensor:
    W, k = z.shape
    n_points = d0s[0].shape[0] if d0s[0].dim() == 3 else 1
    for U, D, d0 in zip(Us, Ds, d0s):
        n_obs, nb, _ = U.shape
        per_point = d0.shape[0] if d0.dim() == 3 else 1
        if (U.shape[2] != k or D.shape != (n_obs, nb, nb) or d0.shape[-2:] != (n_obs, nb) or d0.dim() > 3
                or per_point != n_points or W % n_points or v.shape != (W, k)):
            raise ValueError(
                f"fused_block_mvn: shape mismatch U{tuple(U.shape)} D{tuple(D.shape)} "
                f"d0{tuple(d0.shape)} z{tuple(z.shape)} v{tuple(v.shape)}"
            )
    check_cuda_operands("fused_block_mvn", *Us, *Ds, *d0s, z, v)
    kernel = [i for i, U in enumerate(Us) if U.shape[1] <= MAX_NB]
    if len(kernel) > MAX_BUCKETS:
        raise ValueError(f"fused_block_mvn: {len(kernel)} buckets; the CUDA kernel takes at most {MAX_BUCKETS}")
    out = None
    if kernel:
        Ks, KDs, Kd0s = ([ts[i] for i in kernel] for ts in (Us, Ds, d0s))
        n = len(kernel)
        # Host arrays of the buckets' pointers and sizes; the kernel reads them
        # as launch arguments, so they need to live only for the call.
        arrays = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in ts)) for ts in (Ks, KDs, Kd0s)]
        arrays += [(ctypes.c_int * n)(*(U.shape[i] for U in Ks)) for i in (0, 1)]
        ll_blk = torch.empty((sum(U.shape[0] for U in Ks), W), dtype=z.dtype, device=z.device)
        out = torch.empty((W,), dtype=z.dtype, device=z.device)
        KERNEL.launch(
            "fused_block_mvn_buckets_f32", n, *(ctypes.addressof(a) for a in arrays), z.data_ptr(), v.data_ptr(),
            ll_blk.data_ptr(), out.data_ptr(), k, W, W // n_points, stream_handle(z.device), device=z.device,
        )
    for i in range(len(Us)):
        if i not in kernel:
            term = fused_block_mvn_plain(Us[i], Ds[i], d0s[i], z, v)
            out = term if out is None else out + term
    return out


def fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v) -> torch.Tensor:
    """Sum over every bucket's blocks of the block-MVN log-likelihood, per walker.

    Inputs: the likelihood's bucket tuples (see
    mcmc/likelihood.build_likelihood): U (n_obs_b, nb_b, k), D (n_obs_b, nb_b,
    nb_b), d0 (n_obs_b, nb_b) or, for every bucket alike, (P, n_obs_b, nb_b);
    and per-walker PC means/variances z, v (W, k), W = P * Wh point-major.
    Returns (W,). On the card: one launch for all buckets, summed per walker
    in bucket order, then block order.
    """
    if not Us or not len(Us) == len(Ds) == len(d0s):
        raise ValueError(f"fused_block_mvn: {len(Us)} / {len(Ds)} / {len(d0s)} bucket tensors")
    device = z.device
    if device.type == "cpu":
        return fused_block_mvn_buckets_plain(Us, Ds, d0s, z, v)
    if device.type == "cuda":
        return _fused_block_mvn_cuda(Us, Ds, d0s, z, v)
    raise ValueError(f"fused_block_mvn_loglike: unsupported device {device}")


def fused_block_mvn_loglike(U, D, d0, z, v) -> torch.Tensor:
    """Sum over blocks of the block-MVN log-likelihood, per walker: the
    all-bucket call with one bucket.

    Inputs: padded block tensors U (n_obs, nb, k), D (n_obs, nb, nb),
    d0 (n_obs, nb) or (P, n_obs, nb) (see mcmc/likelihood.build_likelihood)
    and per-walker PC means/variances z, v (W, k), W = P * Wh point-major.
    Returns (W,).
    """
    return fused_block_mvn_loglike_buckets((U,), (D,), (d0,), z, v)
