"""Multi-restart GP hyperparameter optimisation, batched across PCs x restarts.

Port of ``bayesian_inference_tpu.models.gp_fit``: every (principal component,
restart) pair runs the same L-BFGS iteration at once, one batched LML +
closed-form gradient per iteration (models/gp.py, with kernel K3 under it).

Bounded optimisation: hyperparameters live in log space (sklearn's
kernel.theta); the box is enforced by the reparameterisation
theta_h = lo + (hi - lo) * sigmoid(u). Restart starting points are uniform in
the log-space box, as in sklearn. Successive halving: every restart runs
``HALVING_ITERS`` iterations, the best ``HALVING_KEEP`` per PC are polished
for the remaining ``n_iters - HALVING_ITERS`` (the schedule the JAX package's
fit study settled on, docs/fit_schedule_study.json).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesian_inference_tpu_torch.models.gp import (
    GPPosterior,
    log_marginal_likelihood_matmul,
    posterior_from_params_matmul,
)
from bayesian_inference_tpu_torch.ops.gram import KernelConfig, KernelParams, pairwise_sqdiff

HALVING_ITERS, HALVING_KEEP = 15, 3


def pack_params(cfg: KernelConfig, params: KernelParams) -> torch.Tensor:
    """The active hyperparameters flattened to sklearn's kernel.theta order,
    (..., P): [log length scales..., log constant?, log noise?]; the inverse
    of ``unpack_params``."""
    parts = [params.log_length_scale]
    if cfg.with_constant:
        parts.append(params.log_constant[..., None])
    if cfg.with_noise:
        parts.append(params.log_noise[..., None])
    return torch.cat(parts, dim=-1)


def unpack_params(cfg: KernelConfig, flat: torch.Tensor, ndim: int) -> KernelParams:
    """(..., P) in sklearn's kernel.theta order [log ls..., log constant?, log noise?]."""
    zero = torch.zeros_like(flat[..., 0])
    i = ndim
    log_const = zero
    if cfg.with_constant:
        log_const = flat[..., i]
        i += 1
    log_noise = flat[..., i] if cfg.with_noise else zero
    return KernelParams(log_length_scale=flat[..., :ndim], log_noise=log_noise, log_constant=log_const)


@dataclass
class GPFitSpec:
    """Everything needed to fit the stack of per-PC GPs."""

    cfg: KernelConfig
    theta0: np.ndarray  # (P,) initial log hyperparameters (sklearn's first run)
    log_lo: np.ndarray  # (P,) log-space bounds
    log_hi: np.ndarray  # (P,)
    n_restarts: int = 50
    n_iters: int = 100
    alpha_jitter: float = 1e-10


def _to_log_theta(lo: torch.Tensor, hi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return lo + (hi - lo) * torch.sigmoid(u)


def _to_u(lo: torch.Tensor, hi: torch.Tensor, log_theta: torch.Tensor) -> torch.Tensor:
    frac = torch.clamp((log_theta - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(frac) - torch.log1p(-frac)


class _Objective:
    """Batched negative LML in the u parameterisation, with its gradient.

    A non-finite LML (ill-conditioned Gram at extreme hyperparameters) maps
    to +inf with a zero gradient, as in the JAX package.
    """

    def __init__(self, spec: GPFitSpec, D2: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
        self.spec, self.D2, self.lo, self.hi = spec, D2, lo, hi

    def __call__(self, u: torch.Tensor, Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            u = u.detach().requires_grad_(True)
            params = unpack_params(self.spec.cfg, _to_log_theta(self.lo, self.hi, u), self.D2.shape[-1])
            lml = log_marginal_likelihood_matmul(self.spec.cfg, params, self.D2, Y, self.spec.alpha_jitter)
            (g_lml,) = torch.autograd.grad(lml.sum(), u)
        lml = lml.detach()
        finite = torch.isfinite(lml)
        v = torch.where(finite, -lml, torch.inf)
        g = torch.where(finite[:, None], -g_lml, 0.0)
        return v, _finite_or_zero(g)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


class BatchedLBFGS:
    """L-BFGS direction with memory ``m`` for a batch of independent problems.

    Reproduces ``optax.scale_by_lbfgs(memory_size=m)`` (scale_init_precond on)
    per row: the memory update from the (params, grad) sequence it is fed,
    the gamma scaling (the capped inverse gradient norm on the first call),
    and the two-loop recursion over the ring buffer, newest pair first.
    ``update`` returns P @ g, to be subtracted.
    """

    def __init__(self, u0: torch.Tensor, memory_size: int = 8):
        B, P = u0.shape
        self.m = memory_size
        self.count = 0
        self.params = torch.zeros_like(u0)
        self.updates = torch.zeros_like(u0)
        self.dW = torch.zeros((memory_size, B, P), dtype=u0.dtype, device=u0.device)
        self.dU = torch.zeros_like(self.dW)
        self.rho = torch.zeros((memory_size, B), dtype=u0.dtype, device=u0.device)

    def update(self, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        m, idx, prev = self.m, self.count % self.m, (self.count - 1) % self.m
        if self.count > 0:
            dp = u - self.params
            du = g - self.updates
            vd = (du * dp).sum(-1)
            weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
            den = (du * du).sum(-1)
            gamma = torch.where(den > 0.0, vd / den, 1.0)
        else:
            dp = du = torch.zeros_like(u)
            weight = torch.zeros_like(u[:, 0])
            gamma = torch.clamp(torch.rsqrt((g * g).sum(-1)), max=1.0)
        self.dW[prev], self.dU[prev], self.rho[prev] = dp, du, weight

        order = [(idx + i) % m for i in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * (self.dW[i] * vec).sum(-1)
            vec = vec - alphas[i][:, None] * self.dU[i]
        vec = gamma[:, None] * vec
        for i in order:
            beta = self.rho[i] * (self.dU[i] * vec).sum(-1)
            vec = vec + (alphas[i] - beta)[:, None] * self.dW[i]

        self.count += 1
        self.params, self.updates = u, g
        return vec


def _optimize(u0: torch.Tensor, Y: torch.Tensor, obj: _Objective, n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """L-BFGS from each row of u0 (B, P); returns (best_u, best_neg_lml).

    Each iteration takes the full step along the L-BFGS direction (the JAX
    package's studies found it reaches the same optima as a multi-trial line
    search); its gradient seeds the next iteration. A row whose step is
    non-finite stays put, and the running best means an uphill step never
    degrades the result.
    """
    v, g = obj(u0, Y)
    u, best_u, best_v = u0, u0, v
    lbfgs = BatchedLBFGS(u0)
    for _ in range(n_iters):
        u_n = u - lbfgs.update(g, u)
        v_n, g_n = obj(u_n, Y)
        bad = ~torch.isfinite(v_n)
        u_n = torch.where(bad[:, None], u, u_n)
        v_n = torch.where(bad, v, v_n)
        g_n = _finite_or_zero(torch.where(bad[:, None], g, g_n))
        improved = v_n < best_v
        best_u = torch.where(improved[:, None], u_n, best_u)
        best_v = torch.where(improved, v_n, best_v)
        u, g, v = u_n, g_n, v_n
    return best_u, best_v


def fit_gps(
    spec: GPFitSpec,
    X: torch.Tensor,
    Y_pc: torch.Tensor,
    generator: torch.Generator | None = None,
    rand_logs: torch.Tensor | None = None,
) -> GPPosterior:
    """Fit one GP per column of Y_pc (N, k); returns the stacked GPPosterior.

    For each PC: one run from spec.theta0 plus spec.n_restarts runs from
    uniform-in-log-bounds starting points (drawn from ``generator``, or given
    as ``rand_logs`` (k, n_restarts, P)); the best LML wins (sklearn
    semantics). Device and dtype follow ``X``.
    """
    dev, dt = X.device, X.dtype
    N, k = Y_pc.shape
    lo, hi, theta0 = (torch.as_tensor(np.asarray(a), dtype=dt, device=dev) for a in (spec.log_lo, spec.log_hi, spec.theta0))
    P = theta0.shape[0]
    R = spec.n_restarts + 1

    if rand_logs is None:
        rand = torch.rand((k, spec.n_restarts, P), generator=generator, dtype=dt, device=dev)
        rand_logs = lo + (hi - lo) * rand
    u0 = torch.cat(
        [_to_u(lo, hi, theta0).expand(k, 1, P), _to_u(lo, hi, rand_logs.to(device=dev, dtype=dt))], dim=1
    )

    explore = HALVING_KEEP < R and spec.n_iters > HALVING_ITERS
    obj = _Objective(spec, pairwise_sqdiff(X), lo, hi)
    Yt = Y_pc.T

    pool_u, pool = u0, R
    if explore:
        u1, v1 = _optimize(pool_u.reshape(k * pool, P), Yt.repeat_interleave(pool, 0), obj, HALVING_ITERS)
        top = torch.argsort(v1.reshape(k, pool), dim=1, stable=True)[:, :HALVING_KEEP]
        pool_u = torch.take_along_dim(u1.reshape(k, pool, P), top[:, :, None], dim=1)
        pool = HALVING_KEEP
    n_polish = spec.n_iters - (HALVING_ITERS if explore else 0)
    u2, v2 = _optimize(pool_u.reshape(k * pool, P), Yt.repeat_interleave(pool, 0), obj, n_polish)
    best = torch.argmin(v2.reshape(k, pool), dim=1)
    best_u = u2.reshape(k, pool, P)[torch.arange(k, device=dev), best]

    params = unpack_params(spec.cfg, _to_log_theta(lo, hi, best_u), X.shape[1])
    return posterior_from_params_matmul(spec.cfg, params, X, Yt, spec.alpha_jitter)


def spec_from_reference_config(
    cfg: KernelConfig,
    param_min,
    param_max,
    length_scale_bounds_factor=(0.01, 100.0),
    noise_level: float = 0.25,
    noise_level_bounds=(1e-4, 1.0),
    constant_value: float = 1.0,
    constant_value_bounds=(1e-3, 10.0),
    n_restarts: int = 50,
    n_iters: int = 100,
    alpha_jitter: float = 1e-10,
) -> GPFitSpec:
    """GPFitSpec with the reference's kernel initialisation: initial length
    scale = prior range (max - min), bounds = outer(range, factor)."""
    ls0 = np.asarray(param_max, np.float64) - np.asarray(param_min, np.float64)
    lo_parts = [np.log(ls0 * length_scale_bounds_factor[0])]
    hi_parts = [np.log(ls0 * length_scale_bounds_factor[1])]
    theta0_parts = [np.log(ls0)]
    if cfg.with_constant:
        lo_parts.append(np.log([constant_value_bounds[0]]))
        hi_parts.append(np.log([constant_value_bounds[1]]))
        theta0_parts.append(np.log([constant_value]))
    if cfg.with_noise:
        lo_parts.append(np.log([noise_level_bounds[0]]))
        hi_parts.append(np.log([noise_level_bounds[1]]))
        theta0_parts.append(np.log([noise_level]))
    return GPFitSpec(
        cfg=cfg,
        theta0=np.concatenate(theta0_parts),
        log_lo=np.concatenate(lo_parts),
        log_hi=np.concatenate(hi_parts),
        n_restarts=n_restarts,
        n_iters=n_iters,
        alpha_jitter=alpha_jitter,
    )
