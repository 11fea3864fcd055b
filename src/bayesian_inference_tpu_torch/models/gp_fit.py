"""Multi-restart GP hyperparameter optimisation, batched across PCs x restarts.

Port of ``bayesian_inference_tpu.models.gp_fit``: every (principal component,
restart) pair runs the same L-BFGS iteration at once, one batched LML +
closed-form gradient per iteration (models/gp.py, with kernel K3 under it).

Bounded optimisation: hyperparameters live in log space (sklearn's
kernel.theta); the box is enforced by the reparameterisation
theta_h = lo + (hi - lo) * sigmoid(u). Restart starting points are uniform in
the log-space box, as in sklearn. Successive halving (``GPFitSpec``): every
restart runs a rung's iterations, the best few per PC go on to the next rung,
and the last survivors are polished for the remaining iterations.

The JAX package compiles the whole fit into one program. Here each stage (a
rung, the polish) runs its iterations through a ``FitProgram``: on CUDA one
captured graph of one L-BFGS iteration on static buffers, replayed once per
iteration; on the CPU the same body, eagerly. The iteration holds no host
state (the L-BFGS memory is kept newest first by shifting, the first
iteration is told apart by a device flag) and makes no call to autograd. The
eager loop (``fit_gps(eager=True)``) dispatches the same iteration op by op
from fresh tensors and gives the same result bit for bit. A capture that
fails raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from bayesian_inference_tpu_torch.models.gp import (
    GPPosterior,
    lml_value_and_grad,
    posterior_from_params_matmul,
)
from bayesian_inference_tpu_torch.ops import _native
from bayesian_inference_tpu_torch.ops.gram import KernelConfig, KernelParams, pairwise_sqdiff
from bayesian_inference_tpu_torch.parallel.mesh import Mesh, shard_leading_axis
from bayesian_inference_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

WARMUP_ITERATIONS = 3
# Programs kept for reuse, least recently used dropped first. One program's
# graph holds the intermediates of a whole LML evaluation at its batch (a few
# (B, N, N) tensors), so the bound is small.
MAX_FIT_PROGRAMS = 4


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
    """Everything needed to fit the stack of per-PC GPs.

    Successive halving: every restart runs ``halving_iters`` L-BFGS
    iterations, then only the best ``halving_keep`` restarts per PC continue
    for the remaining ``n_iters - halving_iters``; ``halving_keep=0`` disables
    it (every restart runs all ``n_iters``). ``halving_schedule``, when not
    empty, replaces that single rung by several: ((iters_1, keep_1),
    (iters_2, keep_2), ...) runs iters_1 iterations on the full pool, keeps
    the best keep_1 per PC, runs iters_2 more, keeps keep_2, and so on; the
    remaining ``n_iters - sum(iters_r)`` polish the last survivors. The
    defaults (15, 3) are the schedule the JAX package's fit study settled on
    (docs/fit_schedule_study.json).

    ``trial_steps``: the step sizes along the L-BFGS direction tried per
    iteration, all in one widened batch (K x the stage's batch); the lowest
    objective wins per instance. The default is the single full step.
    """

    cfg: KernelConfig
    theta0: np.ndarray  # (P,) initial log hyperparameters (sklearn's first run)
    log_lo: np.ndarray  # (P,) log-space bounds
    log_hi: np.ndarray  # (P,)
    n_restarts: int = 50
    n_iters: int = 100
    alpha_jitter: float = 1e-10
    halving_iters: int = 15
    halving_keep: int = 3
    halving_schedule: tuple = ()
    trial_steps: tuple = (1.0,)


def halving_rungs(spec: GPFitSpec) -> tuple[tuple[int, int], ...]:
    """The fit's exploration rungs ((iterations, keep), ...): the explicit
    ``halving_schedule``, else one rung from ``halving_iters`` /
    ``halving_keep``, else none. A rung that would not prune (keep >= the
    pool it gets) is dropped. Raises when the rungs leave no iteration for
    the polish."""
    R = spec.n_restarts + 1
    schedule = tuple(spec.halving_schedule)
    if not schedule and 0 < spec.halving_keep < R and spec.n_iters > spec.halving_iters:
        schedule = ((spec.halving_iters, spec.halving_keep),)
    rungs, pool = [], R
    for rung_iters, rung_keep in schedule:
        if 0 < rung_keep < pool:
            rungs.append((int(rung_iters), int(rung_keep)))
            pool = int(rung_keep)
    explore_iters = sum(it for it, _ in rungs)
    if rungs and explore_iters >= spec.n_iters:
        raise ValueError(f"halving schedule spends {explore_iters} iters, >= n_iters={spec.n_iters}")
    return tuple(rungs)


def _to_log_theta(lo: torch.Tensor, hi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return lo + (hi - lo) * torch.sigmoid(u)


def _to_u(lo: torch.Tensor, hi: torch.Tensor, log_theta: torch.Tensor) -> torch.Tensor:
    frac = torch.clamp((log_theta - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(frac) - torch.log1p(-frac)


class _Objective:
    """Batched negative LML in the u parameterisation, with its gradient:
    the closed-form dLML/d log theta (models/gp.lml_value_and_grad) chained
    through the box by hand, d log theta / du = (hi - lo) s (1 - s) with
    s = sigmoid(u). No autograd.

    A non-finite LML (ill-conditioned Gram at extreme hyperparameters) maps
    to +inf with a zero gradient, as in the JAX package.
    """

    def __init__(self, cfg: KernelConfig, alpha_jitter: float, D2: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
        self.cfg, self.alpha_jitter, self.D2, self.lo, self.hi = cfg, float(alpha_jitter), D2, lo, hi

    def __call__(self, u: torch.Tensor, Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s = torch.sigmoid(u)
        width = self.hi - self.lo
        params = unpack_params(self.cfg, self.lo + width * s, self.D2.shape[-1])
        lml, grads = lml_value_and_grad(self.cfg, params, self.D2, Y, self.alpha_jitter)
        g_lml = pack_params(self.cfg, grads) * (width * s * (1.0 - s))
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
    and the two-loop recursion, newest pair first. ``update`` returns P @ g,
    to be subtracted.

    All state lives in tensors that ``update`` rewrites in place, and no
    Python value changes between calls, so a captured graph of one call
    serves every later one: the memory is kept newest first by shifting it
    one slot per call, and a device flag marks the first call. Unfilled
    slots hold zeros and contribute exact zeros.
    """

    def __init__(self, u0: torch.Tensor, memory_size: int = 8):
        B, P = u0.shape
        self.m = memory_size
        self.params = torch.zeros_like(u0)
        self.updates = torch.zeros_like(u0)
        self.dW = torch.zeros((memory_size, B, P), dtype=u0.dtype, device=u0.device)
        self.dU = torch.zeros_like(self.dW)
        self.rho = torch.zeros((memory_size, B), dtype=u0.dtype, device=u0.device)
        self.first = torch.ones((), dtype=torch.bool, device=u0.device)

    def reset(self) -> None:
        """Forget the memory: the next ``update`` is a first call again."""
        for buf in (self.params, self.updates, self.dW, self.dU, self.rho):
            buf.zero_()
        self.first.fill_(True)

    def update(self, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        first = self.first
        dp = torch.where(first, 0.0, u - self.params)
        du = torch.where(first, 0.0, g - self.updates)
        vd = (du * dp).sum(-1)
        weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
        den = (du * du).sum(-1)
        gamma = torch.where(
            first, torch.clamp(torch.rsqrt((g * g).sum(-1)), max=1.0), torch.where(den > 0.0, vd / den, 1.0)
        )
        self.dW.copy_(torch.cat([dp[None], self.dW[:-1]]))
        self.dU.copy_(torch.cat([du[None], self.dU[:-1]]))
        self.rho.copy_(torch.cat([weight[None], self.rho[:-1]]))

        vec, alphas = g, []
        for i in range(self.m):  # newest to oldest
            alphas.append(self.rho[i] * (self.dW[i] * vec).sum(-1))
            vec = vec - alphas[i][:, None] * self.dU[i]
        vec = gamma[:, None] * vec
        for i in reversed(range(self.m)):
            beta = self.rho[i] * (self.dU[i] * vec).sum(-1)
            vec = vec + (alphas[i] - beta)[:, None] * self.dW[i]

        self.params.copy_(u)
        self.updates.copy_(g)
        self.first.fill_(False)
        return vec


def _iteration(obj: _Objective, lbfgs: BatchedLBFGS, steps: torch.Tensor, Y_wide: torch.Tensor,
               u, g, v, best_u, best_v):
    """One L-BFGS iteration of a batch (B, P): the direction, every trial
    step along it evaluated (value and gradient) in one (K B) batch against
    ``Y_wide`` (K B, N), the lowest objective per row taken; its gradient
    seeds the next iteration. A row whose every trial is non-finite stays
    put, and the running best means an uphill step never degrades the
    result. Returns the new (u, g, v, best_u, best_v)."""
    K, (B, P) = steps.shape[0], u.shape
    direction = lbfgs.update(g, u)
    cands = u[None] - steps[:, None, None] * direction[None]          # (K, B, P)
    vals, grads = obj(cands.reshape(K * B, P), Y_wide)
    vals, grads = vals.reshape(K, B), grads.reshape(K, B, P)
    j = torch.argmin(vals, dim=0)                                      # (B,)
    rows = j[None, :, None].expand(1, B, P)
    u_n, g_n, v_n = cands.gather(0, rows)[0], grads.gather(0, rows)[0], vals.gather(0, j[None])[0]
    bad = ~torch.isfinite(v_n)
    u_n = torch.where(bad[:, None], u, u_n)
    v_n = torch.where(bad, v, v_n)
    g_n = _finite_or_zero(torch.where(bad[:, None], g, g_n))
    improved = v_n < best_v
    best_u = torch.where(improved[:, None], u_n, best_u)
    best_v = torch.where(improved, v_n, best_v)
    return u_n, g_n, v_n, best_u, best_v


def _optimize(u0: torch.Tensor, Y: torch.Tensor, obj: _Objective, steps: torch.Tensor,
              n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The eager loop: L-BFGS from each row of u0 (B, P), every op dispatched
    from here on fresh tensors; returns (best_u, best_neg_lml)."""
    v, g = obj(u0, Y)
    state = (u0, g, v, u0, v)
    lbfgs = BatchedLBFGS(u0)
    Y_wide = Y.repeat(steps.shape[0], 1)
    for _ in range(n_iters):
        state = _iteration(obj, lbfgs, steps, Y_wide, *state)
    return state[3], state[4]


class FitProgram:
    """The L-BFGS iteration of one stage shape as a device program.

    It owns static buffers for the iterate, its gradient and value, the
    running best, the L-BFGS memory, the targets, the design's squared
    differences and the box, and ``_step`` reads and writes only those.
    ``compile`` runs three warm-up iterations on a side stream (so that no
    kernel is built and nothing is set for the first time inside a capture)
    and then, on CUDA, captures one iteration as a graph. ``run`` loads a
    stage's operands, evaluates the starting points once eagerly, and replays
    the graph once per iteration; the kernels' launch counts follow the
    replays. On the CPU ``run`` calls ``_step`` eagerly.
    """

    def __init__(self, cfg: KernelConfig, alpha_jitter: float, trial_steps: tuple, B: int, N: int, d: int, P: int,
                 dtype: torch.dtype, device: torch.device):
        def buffer(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.B, self.device = B, torch.device(device)
        self._steps = torch.tensor([float(s) for s in trial_steps], dtype=dtype, device=device)
        K = self._steps.shape[0]
        self._D2, self._lo, self._hi = buffer(N, N, d), buffer(P), buffer(P)
        self._Y = buffer(K, B, N)
        self._obj = _Objective(cfg, alpha_jitter, self._D2, self._lo, self._hi)
        # u, g, v, best_u, best_v
        self._state = [buffer(B, P), buffer(B, P), buffer(B), buffer(B, P), buffer(B)]
        self._lbfgs = BatchedLBFGS(self._state[0])
        self._graph = None
        self._launches_per_iteration: dict = {}
        self.compile_seconds: float | None = None

    def _step(self) -> None:
        """The program's body: one iteration on the static buffers."""
        new = _iteration(self._obj, self._lbfgs, self._steps, self._Y.flatten(0, 1), *self._state)
        for buf, value in zip(self._state, new):
            buf.copy_(value)

    def compile(self) -> None:
        """On CUDA, warm up and capture the iteration; on the CPU there is
        nothing to build. A failure raises."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERATIONS):
                    self._step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            with _native.captured_launches() as record:
                with torch.cuda.graph(graph, stream=side):
                    self._step()
            self._graph, self._launches_per_iteration = graph, record
        self.compile_seconds = time.perf_counter() - t0

    @property
    def captured(self) -> bool:
        """True when ``run`` replays a captured CUDA graph, False when it
        runs the iteration eagerly (the CPU)."""
        return self._graph is not None

    def run(self, u0: torch.Tensor, Y: torch.Tensor, D2: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
        """L-BFGS from each row of ``u0`` (B, P) against the targets ``Y``
        (B, N); returns (best_u, best_neg_lml) in new tensors."""
        global _replays
        if self.compile_seconds is None:
            raise RuntimeError("FitProgram: call compile() first")
        if tuple(u0.shape) != tuple(self._state[0].shape) or tuple(Y.shape) != tuple(self._Y.shape[1:]):
            raise ValueError(f"FitProgram.run: u0 {tuple(u0.shape)} and Y {tuple(Y.shape)}, built for "
                             f"{tuple(self._state[0].shape)} and {tuple(self._Y.shape[1:])}")
        self._D2.copy_(D2)
        self._lo.copy_(lo)
        self._hi.copy_(hi)
        self._Y.copy_(Y)  # once per trial step
        v0, g0 = self._obj(u0, Y)
        for buf, value in zip(self._state, (u0, g0, v0, u0, v0)):
            buf.copy_(value)
        self._lbfgs.reset()
        if self.captured:
            for _ in range(n_iters):
                self._graph.replay()
            _native.count_replays(self._launches_per_iteration, n_iters)
            _replays += n_iters
        else:
            for _ in range(n_iters):
                self._step()
        return self._state[3].clone(), self._state[4].clone()


_PROGRAMS: OrderedDict[tuple, FitProgram] = OrderedDict()
# Fit programs built in this process, and the replays of their captured
# iteration graphs (one per L-BFGS iteration).
_built = 0
_replays = 0


@profiling.counter_source
def _program_counts() -> dict[str, int]:
    return {"captures.fit": _built, "replays.fit": _replays}


def fit_program(cfg: KernelConfig, alpha_jitter: float, trial_steps: tuple, B: int, N: int, d: int, P: int,
                dtype: torch.dtype, device: torch.device) -> FitProgram:
    """The compiled program for this stage shape, from the module's cache
    (at most ``MAX_FIT_PROGRAMS``, the least recently used dropped before a
    new one is built, so that its memory is free by then)."""
    global _built
    key = (cfg, float(alpha_jitter), tuple(float(s) for s in trial_steps), B, N, d, P, dtype, torch.device(device))
    program = _PROGRAMS.get(key)
    if program is not None:
        _PROGRAMS.move_to_end(key)
        return program
    while len(_PROGRAMS) >= MAX_FIT_PROGRAMS:
        _PROGRAMS.popitem(last=False)
    with profiling.annotate("capture.fit"):
        program = FitProgram(*key)
        program.compile()
    _PROGRAMS[key] = program
    _built += 1
    logger.info(
        f"fit program ready (batch {len(key[2])} x {B}, N={N}, d={d}, P={P}; "
        + ("one captured CUDA graph per L-BFGS iteration" if program.captured else "eager iterations on the CPU")
        + f"): {program.compile_seconds:.2f}s"
    )
    return program


def fit_program_stats() -> dict[str, int]:
    """How many fit programs the cache holds and how many were built so far."""
    return {"cached": len(_PROGRAMS), "built": _built}


def clear_fit_programs() -> None:
    """Drop every cached fit program (and with it its buffers and graph)."""
    _PROGRAMS.clear()


@profiling.annotate("fit_gps")
def fit_gps(
    spec: GPFitSpec,
    X: torch.Tensor,
    Y_pc: torch.Tensor,
    generator: torch.Generator | None = None,
    rand_logs: torch.Tensor | None = None,
    eager: bool = False,
    mesh: Mesh | None = None,
) -> GPPosterior:
    """Fit one GP per column of Y_pc (N, k); returns the stacked GPPosterior.

    For each PC: one run from spec.theta0 plus spec.n_restarts runs from
    uniform-in-log-bounds starting points (drawn from ``generator``, or given
    as ``rand_logs`` (k, n_restarts, P)); the best LML wins (sklearn
    semantics). Device and dtype follow ``X``. Every stage runs through its
    ``FitProgram``; ``eager=True`` runs the eager loop instead (the reference
    the programs are held against).

    ``mesh``: a ``parallel.mesh.Mesh`` whose first device holds ``X``. The
    flattened instance axis (PCs x restarts) of every stage is split over its
    devices, each running the stage's ``FitProgram`` for its share (on a card
    a captured graph of its own, through kernel K3); the instances are
    independent, so nothing crosses between devices inside a stage. A rung's
    choice of survivors needs every instance's LML: the shares are gathered
    on the first device once per stage. A mesh of one device runs exactly as
    no mesh.
    """
    dev, dt = X.device, X.dtype
    if mesh is not None and mesh.devices[0] != dev:
        raise ValueError(f"fit_gps: the mesh starts on {mesh.devices[0]}, X lies on {dev}")
    N, k = Y_pc.shape
    lo, hi, theta0 = (torch.as_tensor(np.asarray(a), dtype=dt, device=dev) for a in (spec.log_lo, spec.log_hi, spec.theta0))
    P = theta0.shape[0]
    R = spec.n_restarts + 1
    rungs = halving_rungs(spec)

    if rand_logs is None:
        rand = torch.rand((k, spec.n_restarts, P), generator=generator, dtype=dt, device=dev)
        rand_logs = lo + (hi - lo) * rand
    u0 = torch.cat(
        [_to_u(lo, hi, theta0).expand(k, 1, P), _to_u(lo, hi, rand_logs.to(device=dev, dtype=dt))], dim=1
    )

    D2 = pairwise_sqdiff(X)
    Yt = Y_pc.T
    operands: dict[torch.device, tuple] = {dev: (D2, lo, hi)}  # the stages' shared operands, per device

    def run_on(device, u_flat, Y_flat, n_iters):
        """One stage's iterations for the instances ``u_flat``, on ``device``."""
        if device not in operands:
            operands[device] = tuple(t.to(device, non_blocking=True) for t in operands[dev])
        D2_d, lo_d, hi_d = operands[device]
        if eager:
            obj = _Objective(spec.cfg, spec.alpha_jitter, D2_d, lo_d, hi_d)
            steps = torch.tensor([float(s) for s in spec.trial_steps], dtype=dt, device=device)
            return _optimize(u_flat, Y_flat, obj, steps, n_iters)
        program = fit_program(spec.cfg, spec.alpha_jitter, spec.trial_steps, u_flat.shape[0], N, X.shape[1], P,
                              dt, device)
        return program.run(u_flat, Y_flat, D2_d, lo_d, hi_d, n_iters)

    def run_stage(u_flat, Y_flat, n_iters):
        if mesh is None or mesh.size == 1:
            return run_on(dev, u_flat, Y_flat, n_iters)
        # Every share is enqueued on its device before the first is gathered.
        shares = [run_on(d, u_i, Y_i, n_iters)
                  for d, u_i, Y_i in zip(mesh.devices, shard_leading_axis(u_flat, mesh),
                                         shard_leading_axis(Y_flat, mesh)) if u_i.shape[0]]
        return tuple(torch.cat([t.to(dev, non_blocking=True) for t in ts]) for ts in zip(*shares))

    def optimize(pool_u: torch.Tensor, pool: int, n_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``n_iters`` iterations from the (k, pool, P) starting points: one
        stage, its span ending with the device drained."""
        with profiling.annotate("fit.stage"):
            out = run_stage(pool_u.reshape(k * pool, P), Yt.repeat_interleave(pool, 0), n_iters)
            profiling.drain(dev)
        return out

    pool_u, pool = u0, R
    for rung_iters, rung_keep in rungs:
        u1, v1 = optimize(pool_u, pool, rung_iters)
        top = torch.argsort(v1.reshape(k, pool), dim=1, stable=True)[:, :rung_keep]
        pool_u = torch.take_along_dim(u1.reshape(k, pool, P), top[:, :, None], dim=1)
        pool = rung_keep
    u2, v2 = optimize(pool_u, pool, spec.n_iters - sum(it for it, _ in rungs))
    best = torch.argmin(v2.reshape(k, pool), dim=1)
    best_u = u2.reshape(k, pool, P)[torch.arange(k, device=dev), best]
    how = ("the eager loop" if eager else "one captured CUDA graph per iteration" if dev.type == "cuda"
           else "program iterations run eagerly on the CPU")
    if mesh is not None and mesh.size > 1:
        how += f", the instances split over {mesh.size} mesh devices ({mesh.distinct} distinct)"
    logger.info(f"GP fit iterations: {k} PCs x {R} restarts, rungs (iterations, keep) {list(rungs)}, "
                f"{len(spec.trial_steps)} trial step(s), {spec.n_iters} iterations in all; {how}")

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
