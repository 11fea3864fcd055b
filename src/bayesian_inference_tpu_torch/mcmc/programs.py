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

The stretch move's options (``a``, ``randomize_split``, ``store_chain``,
``thin``) are fixed at construction. A captured graph bakes Python scalars in,
so ``a`` is part of the program's identity, like the walker count: ``serves``
compares it and a run with another ``a`` builds its own program. As a baked
scalar the default leaves the captured kernels what they were; a device
operand would only buy reuse between runs that differ in ``a``, and one run
never does. With ``thin`` one replay is ``thin`` sub-steps and one output row:
the device counter indexes the output rows and the draw rows follow from it,
the draw buffers hold ``capacity`` rows and the output buffers
``capacity // thin``. Without ``store_chain`` the program has no chain and no
log-prob buffer, and nothing of them is written or copied out.
``randomize_split`` changes the draws only, not the graph.

With a ``mesh`` (parallel/mesh.py) of more than one device the program is
split, because a CUDA graph cannot span cards:

  - one analysis (no ``n_points``): the walker batch of each half-step is
    sharded over the mesh, each shard against its device's replica of the
    likelihood buffers. Where every mesh entry names the program's own card
    the whole step is still one captured graph; over distinct cards the step
    runs eagerly with the sharded log-posterior, and ``captured`` is False.
  - the closure batch (``n_points``): the points are split over the mesh and
    each device gets a program of its own for its share, a captured graph on
    a card; the shares meet only at a chunk's end, when the outputs are
    gathered on the first device. The host enqueues one share's chunk after
    the other, so the cards overlap as far as their launch queues reach.

A mesh of one device runs exactly as no mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from bayesian_inference_tpu_torch.io import observables as obs_io
from bayesian_inference_tpu_torch.mcmc import stretch
from bayesian_inference_tpu_torch.mcmc.likelihood import MODES, EmulatorLikelihood, build_likelihood
from bayesian_inference_tpu_torch.mcmc.stretch import EnsembleState
from bayesian_inference_tpu_torch.ops import _native
from bayesian_inference_tpu_torch.parallel.mesh import Mesh, make_sharded_log_prob, map_tensors, replicate
from bayesian_inference_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

WARMUP_STEPS = 3

# Sampler programs built in this process (``compile`` calls; a point-sharded
# program counts its shares), for ``sampler_program_stats``, and the replays
# of their captured step graphs (one per output row).
_built = 0
_replays = 0


@profiling.counter_source
def _program_counts() -> dict[str, int]:
    return {"captures.sampler": _built, "replays.sampler": _replays}


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


_map_leaves = map_tensors


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


def _point_share(like: EmulatorLikelihood, lo: int, hi: int, device) -> EmulatorLikelihood:
    """``like`` (offsets for P points) with the offsets of points lo..hi only,
    every tensor on ``device``."""
    if like.mode == "block":
        share = dataclasses.replace(like, d0=tuple(d[lo:hi] for d in like.d0))
    else:
        wb = like.wb
        share = dataclasses.replace(like, wb=dataclasses.replace(wb, b=wb.b[lo:hi], c0=wb.c0[lo:hi], d0=wb.d0[lo:hi]))
    return _map_leaves(share, lambda t: t.to(device, non_blocking=True))


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
    walkers, dimension[, points], move options[, mesh]).

    ``like_spec``: a likelihood of the shapes to serve (a fitted one, or
    ``likelihood_shape_spec``'s placeholder), with one set of residual
    offsets. ``n_points=P`` gives the batched program of the closure batch:
    state leaves (P, W, ...), one offset set per point (the shapes of
    ``like_spec.with_d0`` of P offsets), and ``chunk`` returns what
    ``run_chunk_batched`` returns; without it, what ``run_chunk`` returns.
    ``chunk_sizes`` sizes the draw and output buffers to the longest chunk
    (rounded down to a multiple of ``thin``); a longer chunk runs in pieces of
    that length.

    ``a``, ``randomize_split``, ``store_chain``, ``thin``: the stretch move's
    options, with ``stretch.run_chunk``'s meanings, fixed for the program.
    ``mesh``: see the module's notes; with ``n_points`` it must divide the
    point count (the runner pads the batch).
    """

    def __init__(self, like_spec: EmulatorLikelihood, n_walkers: int, ndim: int, chunk_sizes: Sequence[int],
                 n_points: int | None = None, a: float = stretch.STRETCH_A, randomize_split: bool = True,
                 store_chain: bool = True, thin: int = 1, mesh: Mesh | None = None):
        if like_spec.mode not in MODES:
            raise ValueError(f"unknown likelihood mode {like_spec.mode!r}; expected one of {MODES}")
        if n_walkers % 2:
            raise ValueError("n_walkers must be even")
        sizes = sorted({int(n) for n in chunk_sizes if n > 0})
        if not sizes:
            raise ValueError("SamplerPrograms needs at least one positive chunk size")
        if thin < 1 or sizes[-1] < thin:
            raise ValueError(f"thin {thin} must be positive and no longer than the longest chunk {sizes[-1]}")
        self.n_walkers, self.ndim, self.n_points = n_walkers, ndim, n_points
        self.a, self.randomize_split, self.store_chain, self.thin = float(a), bool(randomize_split), bool(store_chain), thin
        self.mesh = mesh
        self.mode = like_spec.mode
        self.capacity = sizes[-1] // thin * thin
        self.device = like_spec.theta_min.device
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"SamplerPrograms: the mesh starts on {mesh.devices[0]}, the likelihood lies on {self.device}")
        if n_points is not None:
            like_spec = _with_point_offsets(like_spec, n_points)
        self._signature = _signature(like_spec)
        self._loaded: EmulatorLikelihood | None = None
        self._graph = None
        self._launches_per_step: dict = {}
        self.graph_nodes: dict[str, int] | None = None
        self.compile_seconds: float | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._parts: list[SamplerPrograms] = []
        self._shares: list[EmulatorLikelihood] = []
        sharded = mesh is not None and mesh.size > 1
        if sharded and n_points is not None:
            if n_points % mesh.size:
                raise ValueError(f"SamplerPrograms: {n_points} points do not split evenly over {mesh.size} mesh "
                                 "devices; pad the batch to a multiple")
            share = n_points // mesh.size
            self._parts = [
                SamplerPrograms(_point_share(like_spec, i * share, (i + 1) * share, d), n_walkers, ndim, sizes,
                                n_points=share, a=a, randomize_split=randomize_split, store_chain=store_chain,
                                thin=thin)
                for i, d in enumerate(mesh.devices)
            ]
            return
        self._like = _map_leaves(like_spec, torch.clone)
        # One likelihood buffer set per mesh entry; the first is self._like.
        self._replicas = replicate(self._like, mesh) if sharded else [self._like]
        self._log_prob = make_sharded_log_prob(self._replicas, mesh) if sharded else self._like.log_posterior
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
        self._outputs = stretch.chunk_outputs(n // thin, self._state, store_chain)
        self._t = torch.zeros(1, dtype=torch.long, device=self.device)

    @property
    def options(self) -> tuple:
        """(a, randomize_split, store_chain, thin)."""
        return self.a, self.randomize_split, self.store_chain, self.thin

    # -- compilation -------------------------------------------------------------
    def _step(self) -> None:
        """The program's body: one output row (``thin`` ensemble steps) at the
        counter, on the static buffers, and the counter's advance."""
        new = stretch.step_at(self._state, self._rands, self._outputs, self._t, self._log_prob, self.a, self.thin)
        for buf, value in zip(self._state, new):
            buf.copy_(value)
        self._t.add_(1)

    def _graph_possible(self) -> bool:
        """A CUDA graph cannot span cards: the step is captured on a card
        unless the walker batch is sharded over distinct ones."""
        return self.device.type == "cuda" and (self.mesh is None or self.mesh.distinct == 1)

    @profiling.annotate("capture.sampler")
    def compile(self) -> None:
        """On CUDA, warm up and capture the step; on the CPU, and where the
        walker batch is sharded over distinct cards, there is nothing to
        build. A failure raises. The captured graph's nodes by type go to
        ``graph_nodes`` and to the open root call's counters
        (``graph_nodes.sampler.<type>``)."""
        global _built
        t0 = time.perf_counter()
        if self._parts:
            for part in self._parts:
                part.compile()
        elif self._graph_possible():
            torch.cuda.synchronize(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            self._t.zero_()
            # Kept uninstantiated until its nodes are read.
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with _native.captured_launches() as record:
                with torch.cuda.graph(graph, stream=side):
                    self._step()
            self.graph_nodes = profiling.graph_nodes(graph)
            for kind, n in self.graph_nodes.items():
                profiling.count(f"graph_nodes.sampler.{kind}", n)
            graph.instantiate()
            self._graph, self._launches_per_step = graph, record
        if not self._parts:
            _built += 1
        self.compile_seconds = time.perf_counter() - t0
        dense = dense_routes(self._parts[0]._like if self._parts else self._like)
        logger.info(
            f"sampler programs ready ({self.mode}, {self.n_walkers} walkers"
            + (f" x {self.n_points} points" if self.n_points is not None else "")
            + f", chunks up to {self.capacity} steps"
            + (f", thin {self.thin}" if self.thin > 1 else "")
            + ("" if self.store_chain else ", no chain stored")
            + f"; {self.how()}"
            + (f"; dense routes in the step: {dense}" if dense else "")
            + f"): {self.compile_seconds:.2f}s"
        )

    def how(self) -> str:
        """How ``chunk`` runs, in words (for the logs)."""
        per = "step" if self.thin == 1 else f"{self.thin} steps"
        if self._parts:
            return (f"the points split over {self.mesh.size} mesh devices ({self.mesh.distinct} distinct), each share "
                    + (f"one captured CUDA graph per {per}" if self.captured else "eager steps"))
        split = (f", the walker batch sharded over {self.mesh.size} mesh entries"
                 if self.mesh is not None and self.mesh.size > 1 else "")
        if self.captured:
            return f"one captured CUDA graph per {per}" + split
        if self.device.type == "cuda":
            return f"eager steps{split} ({self.mesh.distinct} distinct cards: a graph cannot span them)"
        return "eager steps on the CPU" + split

    def compile_async(self) -> "SamplerPrograms":
        """Start ``compile`` on a daemon thread and return the handle at once;
        every other method waits for the build, and a build that failed
        raises from them.

        On CUDA the build may overlap host work only (reading tables, the
        host PCA, preprocessing). The capture runs in the global capture
        mode: while it lasts, a device allocation or synchronisation made by
        any other thread invalidates it and the build raises. So start no
        fit, likelihood build or sampler on the card from another thread
        before ``ok()`` has returned."""
        def build():
            try:
                self.compile()
            except BaseException as e:  # re-raised by _wait on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=build, daemon=True, name="sampler-prewarm")
        self._thread.start()
        return self

    def _wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise RuntimeError("SamplerPrograms: the build failed") from self._error

    def ok(self) -> bool:
        """True once ``compile`` has run (it raises where it fails); waits
        for a build started by ``compile_async``."""
        self._wait()
        return self.compile_seconds is not None

    @property
    def captured(self) -> bool:
        """True when ``chunk`` replays captured CUDA graphs (on CUDA, after
        ``compile``; of a point-sharded program, every share's), False when
        it runs the step code eagerly (the CPU; a walker batch sharded over
        distinct cards)."""
        if self._parts:
            return all(part.captured for part in self._parts)
        return self._graph is not None

    def serves(self, like: EmulatorLikelihood, n_walkers: int, ndim: int, n_points: int | None = None,
               a: float = stretch.STRETCH_A, randomize_split: bool = True, store_chain: bool = True, thin: int = 1,
               mesh: Mesh | None = None) -> bool:
        """Whether this handle was built for such a run: the same walkers,
        dimension, point count, move options and mesh, and a likelihood of
        ``like``'s mode, kernel structure, tensor shapes, dtypes and device."""
        return (
            (self.n_walkers, self.ndim, self.n_points) == (n_walkers, ndim, n_points)
            and self.options == (float(a), bool(randomize_split), bool(store_chain), thin)
            and self.mesh == mesh
            and _signature(like) == self._signature
        )

    # -- execution ---------------------------------------------------------------
    def _load(self, like: EmulatorLikelihood) -> None:
        """Copy ``like`` into the static buffers (of every replica or share),
        unless it is the object copied last (so hand in a new likelihood, not
        one changed in place)."""
        if not self.ok():
            raise RuntimeError("SamplerPrograms: call compile() first")
        if like is self._loaded:
            return
        if _signature(like) != self._signature:
            raise ValueError(
                "SamplerPrograms: the likelihood's mode, kernels or tensor shapes differ from those the program "
                "was built for"
            )
        if self._parts:
            share = self.n_points // len(self._parts)
            self._shares = [_point_share(like, i * share, (i + 1) * share, part.device)
                            for i, part in enumerate(self._parts)]
        else:
            for replica in self._replicas:
                for buf, value in zip(_leaves(replica), _leaves(like)):
                    buf.copy_(value)
        self._loaded = like

    def _split_points(self, x: torch.Tensor, dim: int = 0) -> list[torch.Tensor]:
        """The point axis ``dim`` of ``x`` in equal shares, each on its part's device."""
        return [s.to(part.device, non_blocking=True)
                for s, part in zip(torch.chunk(x, len(self._parts), dim=dim), self._parts)]

    def _gather_points(self, pieces: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        return torch.cat([p.to(self.device, non_blocking=True) for p in pieces], dim=dim)

    def init(self, like: EmulatorLikelihood, x0: torch.Tensor) -> EnsembleState:
        """The initial state at ``x0``: one log-posterior evaluation through
        the program's likelihood buffers, run eagerly."""
        self._load(like)
        if self._parts:
            if tuple(x0.shape) != (self.n_points, self.n_walkers, self.ndim):
                raise ValueError(f"SamplerPrograms.init: x0 {tuple(x0.shape)}, built for "
                                 f"{(self.n_points, self.n_walkers, self.ndim)}")
            states = [part.init(share, x) for part, share, x in zip(self._parts, self._shares, self._split_points(x0))]
            return EnsembleState(*(self._gather_points(leaf) for leaf in zip(*states)))
        if tuple(x0.shape) != tuple(self._state.coords.shape):
            raise ValueError(f"SamplerPrograms.init: x0 {tuple(x0.shape)}, built for {tuple(self._state.coords.shape)}")
        return stretch.init_state(self._log_prob, x0)

    def chunk(self, state: EnsembleState, like: EmulatorLikelihood, n_steps: int, generator=None,
              rands: dict[str, torch.Tensor] | None = None):
        """Advance ``state`` by ``n_steps``: (final state, (chain, log-probs,
        acceptance)), as ``run_chunk`` returns them with the program's options
        (``run_chunk_batched`` with ``n_points``; the acceptance alone without
        ``store_chain``), in new tensors.

        Draws come from ``rands`` when given, else from ``generator``: one
        ``torch.Generator``, or with ``n_points`` one per point.
        """
        global _replays
        self._load(like)
        shape = (self.n_walkers, self.ndim) if self.n_points is None else (self.n_points, self.n_walkers, self.ndim)
        if tuple(state.coords.shape) != shape:
            raise ValueError(f"SamplerPrograms.chunk: state {tuple(state.coords.shape)}, built for {shape}")
        if n_steps % self.thin:
            raise ValueError(f"thin {self.thin} must divide n_steps {n_steps}")
        if rands is None:
            dt = state.coords.dtype
            if self.n_points is None:
                if not isinstance(generator, torch.Generator):
                    raise ValueError("SamplerPrograms.chunk needs a generator or injected draws")
                rands = stretch.pregen_rands(n_steps, self.n_walkers, generator, dt, self.randomize_split)
            else:
                if generator is None or len(generator) != self.n_points:
                    raise ValueError("SamplerPrograms.chunk needs one generator per point or injected draws")
                rands = stretch.pregen_rands_batched(n_steps, self.n_walkers, generator, dt, self.randomize_split)
        if self._parts:
            return self._chunk_parts(state, n_steps, rands)
        for buf, value in zip(self._state, state):
            buf.copy_(value)
        pieces = []
        for start in range(0, n_steps, self.capacity):
            m = min(self.capacity, n_steps - start)
            for k, buf in self._rands.items():
                buf[:m].copy_(rands[k][start:start + m])
            self._t.zero_()
            rows = m // self.thin
            if self.captured:
                for _ in range(rows):
                    self._graph.replay()
                _native.count_replays(self._launches_per_step, rows)
                _replays += rows
            else:
                for _ in range(rows):
                    self._step()
            pieces.append(tuple(out[:rows].clone() for out in self._outputs))
        outputs = pieces[0] if len(pieces) == 1 else tuple(torch.cat(p) for p in zip(*pieces))
        return EnsembleState(*(buf.clone() for buf in self._state)), (outputs if self.store_chain else outputs[0])

    def _chunk_parts(self, state: EnsembleState, n_steps: int, rands: dict[str, torch.Tensor]):
        """``chunk`` of a point-sharded program: every share advances on its
        device from its slice of the state and of the draws; states and
        outputs are gathered on the first device when all are enqueued."""
        states = zip(*(self._split_points(leaf) for leaf in state))
        draws = zip(*(self._split_points(rands[k], dim=1) for k in self._rands_keys))
        results = [
            part.chunk(EnsembleState(*s), share, n_steps, rands=dict(zip(self._rands_keys, r)))
            for part, share, s, r in zip(self._parts, self._shares, states, draws)
        ]
        final = EnsembleState(*(self._gather_points(leaf) for leaf in zip(*(r[0] for r in results))))
        if not self.store_chain:
            return final, self._gather_points([r[1] for r in results], dim=1)
        return final, tuple(self._gather_points(out, dim=1) for out in zip(*(r[1] for r in results)))

    _rands_keys = ("perm", "inv", "u_z", "partners", "u_acc")


def sampler_program_stats() -> dict[str, int]:
    """How many sampler programs were built so far (the counterpart of
    ``gp_fit.fit_program_stats``; a point-sharded program counts its shares)."""
    return {"built": _built}


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
    dtype: torch.dtype | None = None,
    mesh: Mesh | None = None,
    dispatch_chunk: int | None = None,
) -> SamplerPrograms | None:
    """Build the MCMC's programs ahead of ``run_mcmc`` (or, with ``n_points``,
    of ``run_closure_batch`` over that many points, whose buffers are sized
    for the production chunks that run dispatches: pass its
    ``checkpoint_every`` and ``dispatch_chunk``).

    Needs the observables (for shapes: the configured h5 file, or the
    already-read dict) but not the fit. Pass the result as ``programs=``.
    Returns None for an unknown mode. ``dtype``: the likelihood's precision
    (the device's default when None), as the run's own ``dtype``. ``mesh``:
    the run's mesh; its first device is the programs' device, and with
    ``n_points`` the point count is padded to a multiple of the mesh size as
    ``run_closure_batch`` pads it.
    """
    from bayesian_inference_tpu_torch.mcmc.runner import (
        _chunk_sizes,
        _closure_dispatch_chunk,
        _existing_observables_file,
        _mesh_device,
    )
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig

    mode = mode or config.likelihood_mode
    if mode not in MODES:
        return None
    device = _mesh_device(device, mesh)
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
        mode=mode, device=device, dtype=dtype, observables=observables,
    )
    ndim = len(box["names"])
    sizes = chunk_sizes_for_config(config, checkpoint_every)
    if n_points is not None:
        if mesh is not None:
            n_points += (-n_points) % mesh.size
        n_total = config.n_sampling_steps
        chunk = _closure_dispatch_chunk(n_total, n_points, config.n_walkers, ndim, spec.theta_min.element_size(),
                                        dispatch_chunk, checkpoint_every)
        sizes = [config.n_burn_steps // 2, *_chunk_sizes(n_total, 0, chunk)]
    programs = SamplerPrograms(spec, n_walkers=config.n_walkers, ndim=ndim, chunk_sizes=sizes, n_points=n_points,
                               mesh=mesh)
    programs.compile()
    return programs
