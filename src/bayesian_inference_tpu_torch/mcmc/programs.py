"""The sampler's chunk of steps as one device program, built before the fit.

Port of ``bayesian_inference_tpu.mcmc.programs``. The JAX package compiles the
sampler's n-step ``lax.scan`` ahead of time, with the likelihood as a runtime
operand, so one executable serves every fitted likelihood of the same shapes.
Here the program is a captured CUDA graph of one ensemble step
(``stretch.step_at``) that reads its step index from a device counter and
advances it itself: ``chunk`` replays it once per step, so the host issues one
graph launch per step where the eager loop (``stretch.run_chunk``) dispatches
every op of the step. One graph serves every chunk length.

Operand style: the program owns static buffers for the likelihood's tensors,
the sampler state, a chunk's draws and its outputs, and the graph reads and
writes only those. ``chunk`` copies a likelihood of the same shapes into them,
once per likelihood, not per step. So a program captured from a zero-valued
placeholder likelihood (``likelihood_shape_spec``, shapes from the config and
the observables alone) serves the likelihood a later fit produces; a
likelihood of other shapes raises.

The draws of a chunk are still pregenerated from the generator outside the
graph (``stretch.pregen_rands``), so the random stream, and with it every
checkpoint record, is that of the eager loop: a program's chain, log-probs and
acceptance equal ``run_chunk``'s bit for bit.

On the CPU there is no graph: the program runs the same step code eagerly on
the same buffers. On CUDA a capture that fails raises; nothing falls back to
the eager loop. The capture runs on a side stream after three warm-up steps
there, so that no kernel is built and no attribute set for the first time
inside a capture. The kernels' launch counts follow the replays
(``ops/_native.captured_launches``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Sequence

import numpy as np
import torch

from bayesian_inference_tpu_torch.io import observables as obs_io
from bayesian_inference_tpu_torch.mcmc import stretch
from bayesian_inference_tpu_torch.mcmc.likelihood import MODES, EmulatorLikelihood, build_likelihood
from bayesian_inference_tpu_torch.mcmc.stretch import EnsembleState
from bayesian_inference_tpu_torch.ops import _native

logger = logging.getLogger(__name__)

WARMUP_STEPS = 3


def logp_operand(like: EmulatorLikelihood, x: torch.Tensor) -> torch.Tensor:
    """Operand-style log-posterior: the likelihood is an argument."""
    return like.log_posterior(x)


# --------------------------------------------------------------------------------------
# A likelihood as a flat list of tensors
# --------------------------------------------------------------------------------------

def _leaves(obj) -> list[torch.Tensor]:
    """Every tensor of a likelihood (dataclasses and tuples, in field order)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [leaf for f in dataclasses.fields(obj) for leaf in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [leaf for o in obj for leaf in _leaves(o)]
    return []


def _map_leaves(obj, fn):
    """``obj`` with every tensor replaced by ``fn(tensor)``; the rest as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _map_leaves(getattr(obj, f.name), fn) for f in dataclasses.fields(obj)}
        )
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_leaves(o, fn) for o in obj)
    return obj


def _signature(like: EmulatorLikelihood) -> tuple:
    """What a program is specialised to: the mode, each group's kernel
    structure, and every tensor's shape, dtype and device."""
    return (
        like.mode,
        tuple(cfg for cfg, _ in like.groups),
        tuple((tuple(t.shape), t.dtype, t.device) for t in _leaves(like)),
    )


def _with_point_offsets(like: EmulatorLikelihood, n_points: int) -> EmulatorLikelihood:
    """``like`` with zero residual offsets for ``n_points`` points, shaped as
    ``like.with_d0`` of a batch shapes them: block mode d0 (P, n_obs_b, nb)
    per bucket; lowrank mode b (P, k), c0 (P,), d0 (P, F). A likelihood that
    already holds offsets for ``n_points`` points comes back as it is."""
    def per_point(t):
        return t.new_zeros((n_points, *t.shape))

    offsets = like.d0[0] if like.mode == "block" else like.wb.d0
    if offsets.dim() == (3 if like.mode == "block" else 2):
        if offsets.shape[0] != n_points:
            raise ValueError(f"SamplerPrograms: the likelihood holds offsets for {offsets.shape[0]} points, "
                             f"n_points is {n_points}")
        return like
    if like.mode == "block":
        return dataclasses.replace(like, d0=tuple(per_point(d) for d in like.d0))
    wb = like.wb
    return dataclasses.replace(like, wb=dataclasses.replace(wb, b=per_point(wb.b), c0=per_point(wb.c0),
                                                            d0=per_point(wb.d0)))


def dense_routes(like: EmulatorLikelihood) -> list[str]:
    """The parts of ``like``'s evaluation that take the dense path (the
    library Cholesky) beside or instead of a kernel launch, chosen by shape as
    the wrappers choose them (ops/fused_mvn.py, ops/tiny_mvn.py)."""
    from bayesian_inference_tpu_torch.ops import fused_mvn, tiny_mvn

    if like.mode == "block":
        return [f"bucket nb={U.shape[1]}" for U in like.U if U.shape[1] > fused_mvn.MAX_NB]
    k = like.wb.G.shape[0]
    limit = tiny_mvn.MAX_NB if like.theta_min.device.type == "cuda" else tiny_mvn.DENSE_ABOVE
    return [f"capacitance k={k}"] if k > limit else []


# --------------------------------------------------------------------------------------
# Shape spec without a fit
# --------------------------------------------------------------------------------------

def _placeholder_group_artifact(group_config, observables: dict[str, Any] | None = None) -> dict[str, Any]:
    """A zero-valued emulator artifact with the exact shapes the fit would
    produce (schema: models/emulator.py::_artifact_from_fit). Only the keys
    that build_likelihood, posterior_from_artifact and
    compute_emulator_cov_unexplained read are filled. ``observables``: the
    already-read observables dict (read from the group's h5 file when None)."""
    Y = obs_io.predictions_matrix_from_h5(
        group_config.output_dir, filename=group_config.observables_filename,
        observable_filter=group_config.observable_filter, observables=observables,
    )
    design = obs_io.design_array_from_h5(
        group_config.output_dir, filename=group_config.observables_filename, observables=observables
    )
    n, d = design.shape
    F = Y.shape[1]
    n_comp = min(n, F)
    if group_config.max_n_components_to_calculate:
        n_comp = min(n_comp, group_config.max_n_components_to_calculate)
    k = group_config.n_pc
    cfg = group_config.kernel_config()
    return {
        "PCA": {
            "mean": np.zeros(F),
            "scale": np.ones(F),
            "components": np.zeros((n_comp, F)),
            "explained_variance": np.ones(n_comp),
            "explained_variance_ratio": np.full(n_comp, 1.0 / n_comp),
            "singular_values": np.ones(n_comp),
        },
        "emulators": {
            "kernel": {"nu": cfg.nu, "with_noise": cfg.with_noise, "with_constant": cfg.with_constant},
            "alpha_jitter": group_config.alpha,
            "X": np.zeros((n, d)),
            "params": {
                "log_length_scale": np.zeros((k, d)),
                "log_noise": np.zeros(k),
                "log_constant": np.zeros(k),
            },
            "alpha": np.zeros((k, n)),
            "Kinv": np.zeros((k, n, n)),
            "prior_var": np.ones(k),
            "lml": np.zeros(k),
        },
        "n_pc": k,
    }


def likelihood_shape_spec(
    emulation_config,
    theta_min: Sequence[float],
    theta_max: Sequence[float],
    mode: str = "block",
    device="cuda",
    dtype: torch.dtype | None = None,
    observables: dict[str, Any] | None = None,
) -> EmulatorLikelihood:
    """A zero-valued likelihood with the tensor shapes and dtypes of the one a
    future fit will produce, built through the real ``build_likelihood``. The
    placeholder itself is the spec: ``SamplerPrograms`` reads its shapes and
    captures on a copy of it."""
    from bayesian_inference_tpu_torch.models.emulator import GroupSliceMap

    placeholder = {
        name: _placeholder_group_artifact(cfg, observables)
        for name, cfg in emulation_config.emulation_groups_config.items()
    }
    n_features = GroupSliceMap.learn(emulation_config, observables=observables).n_features
    return build_likelihood(
        emulation_config, placeholder, {"y": np.zeros(n_features), "y_err": np.ones(n_features)},
        theta_min=theta_min, theta_max=theta_max, mode=mode, device=device, dtype=dtype, observables=observables,
    )


# --------------------------------------------------------------------------------------
# The programs
# --------------------------------------------------------------------------------------

class SamplerPrograms:
    """The sampler's ``init`` and n-step ``chunk`` for one (likelihood shapes,
    walkers, dimension[, points]).

    ``like_spec``: a likelihood of the shapes to serve (a fitted one, or
    ``likelihood_shape_spec``'s placeholder), with one set of residual
    offsets. ``n_points=P`` gives the batched program of the closure batch:
    state leaves (P, W, ...), one offset set per point (the shapes of
    ``like_spec.with_d0`` of P offsets), and ``chunk`` returns what
    ``run_chunk_batched`` returns; without it, what ``run_chunk`` returns.
    ``chunk_sizes`` sizes the draw and output buffers to the longest chunk; a
    longer chunk runs in pieces of that length.
    """

    def __init__(self, like_spec: EmulatorLikelihood, n_walkers: int, ndim: int, chunk_sizes: Sequence[int],
                 n_points: int | None = None):
        if like_spec.mode not in MODES:
            raise ValueError(f"unknown likelihood mode {like_spec.mode!r}; expected one of {MODES}")
        if n_walkers % 2:
            raise ValueError("n_walkers must be even")
        sizes = sorted({int(n) for n in chunk_sizes if n > 0})
        if not sizes:
            raise ValueError("SamplerPrograms needs at least one positive chunk size")
        self.n_walkers, self.ndim, self.n_points = n_walkers, ndim, n_points
        self.mode = like_spec.mode
        self.capacity = sizes[-1]
        if n_points is not None:
            like_spec = _with_point_offsets(like_spec, n_points)
        self._like = _map_leaves(like_spec, torch.clone)
        self._signature = _signature(self._like)
        self._loaded: EmulatorLikelihood | None = None
        self.device = self._like.theta_min.device
        dt = self._like.theta_min.dtype
        lead = () if n_points is None else (n_points,)
        W, half, n = n_walkers, n_walkers // 2, self.capacity

        def buffer(shape, dtype=dt, fill=0.0):
            return torch.full(shape, fill, dtype=dtype, device=self.device)

        self._state = EnsembleState(
            coords=buffer((*lead, W, ndim)), log_prob=buffer((*lead, W)),
            n_accepted=buffer((*lead, W), torch.int32, 0),
        )
        # Draws start as valid ones (identity permutation, partner 0, u = 1/2),
        # so that the warm-up steps index in range.
        identity = torch.arange(W, device=self.device).expand(n, *lead, W).contiguous()
        self._rands = {
            "perm": identity, "inv": identity.clone(),
            "u_z": buffer((n, *lead, 2, half), fill=0.5),
            "partners": buffer((n, *lead, 2, half), torch.long, 0),
            "u_acc": buffer((n, *lead, 2, half), fill=0.5),
        }
        self._outputs = stretch.chunk_outputs(n, self._state)
        self._t = torch.zeros(1, dtype=torch.long, device=self.device)
        self._graph = None
        self._launches_per_step: dict = {}
        self.compile_seconds: float | None = None

    # -- compilation -------------------------------------------------------------
    def _step(self) -> None:
        """The program's body: the ensemble step at the counter, on the static
        buffers, and the counter's advance."""
        new = stretch.step_at(self._state, self._rands, self._outputs, self._t, self._like.log_posterior)
        for buf, value in zip(self._state, new):
            buf.copy_(value)
        self._t.add_(1)

    def compile(self) -> None:
        """On CUDA, warm up and capture the step; on the CPU there is nothing
        to build. A failure raises."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            self._t.zero_()
            graph = torch.cuda.CUDAGraph()
            with _native.captured_launches() as record:
                with torch.cuda.graph(graph, stream=side):
                    self._step()
            self._graph, self._launches_per_step = graph, record
        self.compile_seconds = time.perf_counter() - t0
        dense = dense_routes(self._like)
        logger.info(
            f"sampler programs ready ({self.mode}, {self.n_walkers} walkers"
            + (f" x {self.n_points} points" if self.n_points is not None else "")
            + f", chunks up to {self.capacity} steps; "
            + ("one captured CUDA graph per step" if self.captured else "eager steps on the CPU")
            + (f"; dense routes in the step: {dense}" if dense else "")
            + f"): {self.compile_seconds:.2f}s"
        )

    def ok(self) -> bool:
        """True once ``compile`` has run (it raises where it fails)."""
        return self.compile_seconds is not None

    @property
    def captured(self) -> bool:
        """True when ``chunk`` replays a captured CUDA graph (on CUDA, after
        ``compile``), False when it runs the step code eagerly (the CPU)."""
        return self._graph is not None

    def serves(self, like: EmulatorLikelihood, n_walkers: int, ndim: int, n_points: int | None = None) -> bool:
        """Whether this handle was built for such a run: the same walkers,
        dimension and point count, and a likelihood of ``like``'s mode, kernel
        structure, tensor shapes, dtypes and device."""
        return (self.n_walkers, self.ndim, self.n_points) == (n_walkers, ndim, n_points) and (
            _signature(like) == self._signature)

    # -- execution ---------------------------------------------------------------
    def _load(self, like: EmulatorLikelihood) -> None:
        """Copy ``like`` into the static buffers, unless it is the object
        copied last (so hand in a new likelihood, not one changed in place)."""
        if not self.ok():
            raise RuntimeError("SamplerPrograms: call compile() first")
        if like is self._loaded:
            return
        if _signature(like) != self._signature:
            raise ValueError(
                "SamplerPrograms: the likelihood's mode, kernels or tensor shapes differ from those the program "
                "was built for"
            )
        for buf, value in zip(_leaves(self._like), _leaves(like)):
            buf.copy_(value)
        self._loaded = like

    def init(self, like: EmulatorLikelihood, x0: torch.Tensor) -> EnsembleState:
        """The initial state at ``x0``: one log-posterior evaluation through
        the program's likelihood buffers, run eagerly."""
        self._load(like)
        if tuple(x0.shape) != tuple(self._state.coords.shape):
            raise ValueError(f"SamplerPrograms.init: x0 {tuple(x0.shape)}, built for {tuple(self._state.coords.shape)}")
        return stretch.init_state(self._like.log_posterior, x0)

    def chunk(self, state: EnsembleState, like: EmulatorLikelihood, n_steps: int, generator=None,
              rands: dict[str, torch.Tensor] | None = None):
        """Advance ``state`` by ``n_steps``: (final state, (chain, log-probs,
        per-step mean acceptance)), as ``run_chunk`` returns them
        (``run_chunk_batched`` with ``n_points``), in new tensors.

        Draws come from ``rands`` when given, else from ``generator``: one
        ``torch.Generator``, or with ``n_points`` one per point.
        """
        self._load(like)
        if tuple(state.coords.shape) != tuple(self._state.coords.shape):
            raise ValueError(
                f"SamplerPrograms.chunk: state {tuple(state.coords.shape)}, built for {tuple(self._state.coords.shape)}"
            )
        if rands is None:
            dt = state.coords.dtype
            if self.n_points is None:
                if not isinstance(generator, torch.Generator):
                    raise ValueError("SamplerPrograms.chunk needs a generator or injected draws")
                rands = stretch.pregen_rands(n_steps, self.n_walkers, generator, dt)
            else:
                if generator is None or len(generator) != self.n_points:
                    raise ValueError("SamplerPrograms.chunk needs one generator per point or injected draws")
                rands = stretch.pregen_rands_batched(n_steps, self.n_walkers, generator, dt)
        for buf, value in zip(self._state, state):
            buf.copy_(value)
        pieces = []
        for start in range(0, n_steps, self.capacity):
            m = min(self.capacity, n_steps - start)
            for k, buf in self._rands.items():
                buf[:m].copy_(rands[k][start:start + m])
            self._t.zero_()
            if self.captured:
                for _ in range(m):
                    self._graph.replay()
                _native.count_replays(self._launches_per_step, m)
            else:
                for _ in range(m):
                    self._step()
            pieces.append(tuple(out[:m].clone() for out in self._outputs))
        outputs = pieces[0] if len(pieces) == 1 else tuple(torch.cat(p) for p in zip(*pieces))
        return EnsembleState(*(buf.clone() for buf in self._state)), outputs


def chunk_sizes_for_config(config, checkpoint_every: int | None = None) -> list[int]:
    """The chunk lengths ``run_mcmc`` dispatches for this config: the two
    burn-in halves and the production chunks at this cadence."""
    from bayesian_inference_tpu_torch.mcmc.runner import _chunk_sizes

    nburn0 = config.n_burn_steps // 2
    sizes = {nburn0, config.n_burn_steps - nburn0, *_chunk_sizes(config.n_sampling_steps, 0, checkpoint_every)}
    return sorted(s for s in sizes if s > 0)


def prewarm_sampler_programs(
    config,
    mode: str | None = None,
    checkpoint_every: int | None = None,
    device="cuda",
    observables: dict[str, Any] | None = None,
    n_points: int | None = None,
) -> SamplerPrograms | None:
    """Build the MCMC's programs ahead of ``run_mcmc`` (or, with ``n_points``,
    of ``run_closure_batch`` over that many points).

    Needs the observables (for shapes: the configured h5 file, or the
    already-read dict) but not the fit. Pass the result as ``programs=``.
    Returns None for an unknown mode.
    """
    from bayesian_inference_tpu_torch.mcmc.runner import _existing_observables_file
    from bayesian_inference_tpu_torch.models.emulator import resolve_device
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig

    mode = mode or config.likelihood_mode
    if mode not in MODES:
        return None
    device = resolve_device(device)
    emulation_config = EmulationConfig.from_config_file(
        analysis_name=config.analysis_name, parameterization=config.parameterization,
        analysis_config=config.analysis_config, config_file=config.config_file, config=config.config,
    )
    if observables is None:
        # Shapes must come from a file that exists now: the preprocessed file
        # may not be written yet when the programs are built before that stage.
        obs_filename = _existing_observables_file(config)
        emulation_config.observables_filename = obs_filename
        for group_config in emulation_config.emulation_groups_config.values():
            group_config.observables_filename = obs_filename
    box = config.parameterization_spec()
    spec = likelihood_shape_spec(
        emulation_config, theta_min=np.asarray(box["min"], float), theta_max=np.asarray(box["max"], float),
        mode=mode, device=device, observables=observables,
    )
    programs = SamplerPrograms(spec, n_walkers=config.n_walkers, ndim=len(box["names"]),
                               chunk_sizes=chunk_sizes_for_config(config, checkpoint_every), n_points=n_points)
    programs.compile()
    return programs
