#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``bayesian_inference_tpu_torch``) on one GPU.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``src/.../csrc/`` (one
``nvcc`` per source, all at once), holds each one against its plain PyTorch
version at the shapes of the paths that run it, then drives those paths at
production width through the entry points a user calls, each with the kernel
launch counts set to 0 just before it and read just after:

- the sampler programs (``mcmc/programs.SamplerPrograms``, a captured CUDA
  graph of the ensemble step, through which both runners run every chunk)
  against the eager loop (``stretch.run_chunk`` / ``run_chunk_batched``): 200
  steps from one state and one set of draws, block and lowrank mode and the
  30-point batch in both, bit for bit, from a program captured on the
  fitted likelihood and from one captured on the zero-valued placeholder of
  the same shapes; the replay-aware launch counts; then both timed in turns
  (eager, program, program, eager), with the step's analytic FLOPs
  (``utils/flops.py``), the capture's seconds and the program's peak bytes;
- the fit programs (``models/gp_fit.FitProgram``, a captured CUDA graph of
  one L-BFGS iteration per stage shape, through which ``fit_gps`` runs every
  stage) against the eager loop (``fit_gps(eager=True)``) at production
  width (41 PCs x 51 restarts, 60 iterations): hyperparameters, LML, alpha
  and K^-1 bit for bit for the default schedule, two trial steps and a
  two-rung halving schedule; K3's launches by batch size through the
  replays; both timed in turns with the profiler's device-busy time, the
  kernels per iteration, capture seconds and peak bytes; and one group's
  5-fold cross-validation eager and through the programs;
- fit then sample: ``fit_emulators`` -> ``build_likelihood`` (block mode) ->
  ``run_mcmc``;
- one lowrank (Woodbury) analysis: ``run_mcmc(mode="lowrank")`` on the same
  fitted emulators;
- the closure-test batch: ``run_closure_batch`` over the 30 validation
  points, in lowrank and in block mode;
- the stretch move's options through the sampler programs (``thin``, ``a``,
  ``randomize_split``, ``store_chain``): program against eager loop bit for
  bit, block and lowrank, one analysis and the 30-point batch; thinned
  against unthinned ms per step in turns; peak bytes with and without the
  chain stored;
- the memory-bounded closure batch: production in four ``dispatch_chunk``
  slabs against one chunk under the same injected draws (final state bit for
  bit, the device statistics over the list of slabs, peak bytes of both);
- the device mesh (``parallel/mesh.py``) on the one card: ``get_mesh()``
  against ``mesh=None`` bit for bit, then a mesh naming the card four times
  (the sharded log-posterior, ``run_mcmc``, the closure batch padded from 30
  to 32 points, ``fit_gps(mesh=)``); a run over several cards is not
  measured;
- the main path at its full length, once: ``fit_emulators`` -> ``run_mcmc``
  with 100 walkers and 1,000 + 50,000 steps, with seconds per phase, steps
  per second and peak bytes;
- posterior parity (``scripts/parity_check_torch.py``), block and lowrank
  mode: ``run_mcmc`` on the slice's emulators (f32, the kernels, the port's
  own generator) against an independent numpy stretch move on the float64
  likelihood without the kernels, KS and quantile gates on the tau-thinned
  marginals;
- the steer entry point, ``SteerAnalysis(config=..., write=False)``: table
  ingest -> preprocessing -> fit -> 5-fold CV of every group -> MCMC
  checkpointed every 500 steps -> closure batch; then an MCMC run and a
  closure batch cut during their third chunk and resumed, against
  uninterrupted runs, and production with and without chunking.

Each kernel's line gives its device time beside its bound (the larger of
its FP32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s, the H100
SXM's published peaks) and the share of the bound it reaches: K3 at the
fit's three batch sizes, K4 at the lowrank batch sizes and at the widest
capacitance matrix it takes (64 PCs), beside one library call of the same
function (``MultivariateNormal.log_prob``; K1 has none: it assembles
C = D + U diag(v) U^T inside, and no one call computes that). The fit checks
K3's launches by batch size, counted through the fit programs' replays; the
steer prints them. In block mode every likelihood evaluation is one launch
of K1 for all width buckets; each path checks that its K1 launches equal its
block-mode evaluations, counted as its eager evaluations plus two per step a
program replayed.

One line per phase; the line before the last is the card's name and power
limit as ``nvidia-smi`` reports them, the line before that the kernels' JSON
record, and the last line ``{"ok": true, ...}``. Any failed check raises, so
the script exits non-zero and prints no result. It also exits non-zero
without a CUDA device or outside a repository checkout.

The run needs no ``h5py`` and no ``yaml``: the configuration is a dict, the
observables come straight from the table ingest, the emulator artifacts stay
in memory and the runners are called with ``write=False``. What it writes
(tables, the runners' checkpoints) goes under ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
WORK_DIR = REPO / "build" / "chip_smoke"

# Production widths (bench.py): three emulation groups with 5 + 11 + 25 PCs
# over the synthetic production table set, 50 + 1 restarts, 60 L-BFGS
# iterations, 100 walkers. Sampling is cut to 2 x 100 burn-in and 2,000
# production steps; the closure batch to 1,000 (lowrank) and 500 (block)
# production steps over the 30 validation points [200, 230).
PRODUCTION_GROUPS = {
    "jet_group": {"n_pc": 5, "observable_list": ["jet__pt_"]},
    "substructure_groomed_group": {"n_pc": 11, "observable_list": ["chjet__zg_", "chjet__tg_"]},
    "substructure_Dz_group": {"n_pc": 25, "observable_list": ["jet__Dz_"]},
}
ANALYSIS, PARAMETERIZATION = "smoke", "exponential"
N_RESTARTS, N_OPT_ITERS = 50, 60
N_WALKERS, N_BURN, N_STEPS = 100, 200, 2000
CLOSURE_STEPS = {"lowrank": 1000, "block": 500}
N_PCS = 41
# The steer phase: 5-fold CV of every group, and the MCMC production
# checkpointed every 500 steps. The steer's MCMC and closure stages share one
# MCMC config, so its closure batch also runs 2,000 steps (checkpointed every
# quarter, as the steer does); the closure resume check runs at 500 steps.
STEER_CV_K, STEER_CHECKPOINT_EVERY = 5, 500
# The programs phase: its own quick fit (4 restarts, 20 iterations) at
# production width, the bit-equality run, and the timed turns (the eager
# turns run fewer steps to stay inside the script's time).
PROGRAM_FIT = {"n_restarts": 4, "n_opt_iters": 20}
PROGRAM_CHECK_STEPS, PROGRAM_TIMED_STEPS, PROGRAM_EAGER_STEPS = 200, 2000, 500
PROGRAM_PROFILED_STEPS = 100  # the profiler window that gives the device-busy time per step
# The fit-programs phase: the schedules held against the eager loop beside
# the default one, the iterations profiled per stage, and the group whose
# 5-fold CV runs eager and through the programs (the widest: 25 PCs).
FIT_TRIAL_STEPS = (1.0, 0.3)
FIT_TWO_RUNGS = ((5, 8), (10, 3))
FIT_PROFILED_ITERS = 20
FIT_CV_GROUP = "substructure_Dz_group"
# The options phase: the thinned case held against the eager loop, and the
# steps of the batch's timed turns (the analysis' turns run PROGRAM_TIMED_STEPS).
OPTION_THINNED = {"thin": 4, "a": 1.5, "randomize_split": False}
OPTION_BATCH_TIMED_STEPS = 1000
# The memory-bounded closure batch: production steps and the chunks they run in.
SLAB_STEPS, SLAB_CHUNKS = 1200, 4
# The mesh phase: how often the mesh names the one card, and the closure steps.
MESH_ENTRIES, MESH_CLOSURE_STEPS = 4, 300
# The mesh fit is held to the unsharded fit's LMLs (LML_TOL_NAT) after this
# many iterations of every restart; after the whole schedule to a looser bar,
# see MESH_FIT_PATH_TOL_NAT.
MESH_FIT_SHORT_ITERS = 3
# The main path at its full length (bench.py's north-star workload).
FULL_BURN, FULL_STEPS = 1000, 50_000
# The parity phase (scripts/parity_check_torch.py), block and lowrank mode:
# ours, run_mcmc at 100 walkers (f32, the kernels), against the numpy stretch
# move on the float64 likelihood without the kernels. The reference runs
# PARITY_REF_BURN + up to PARITY_REF_STEPS steps, fewer production steps
# where its budget in seconds per mode (PARITY_REF_BUDGET_S), at the time of
# one evaluation measured first, does not hold them; ours runs PARITY_BURN +
# PARITY_STEPS steps, at least as many. Measured on an H100 (700 W): one
# float64 evaluation of 50 walkers takes 1.9 ms (block) and 1.5 ms (lowrank)
# on the card, 4-124 ms on its host; tau is 67-69 (block) and 103-110
# (lowrank) steps.
PARITY_BURN, PARITY_STEPS = 1000, 12_000
PARITY_REF_BURN, PARITY_REF_STEPS = 1000, 6000
PARITY_REF_BUDGET_S = {"block": 60.0, "lowrank": 35.0}
# Production with and without chunking is timed in turns: the steer's own
# (chunked) run, then this many (one chunk, chunked) pairs, then one chunk.
STEER_TIMING_PAIRS = 3

# Tolerances, each with its reason:
# - K3 (f32 Cholesky and inverse of Matern grams, condition numbers up to
#   ~2e5), normwise per instance against the float64 plain version: f32
#   factorisations of these blocks land within ~3e-5 (L) and ~8e-4 (L^-1) of
#   float64. Against the f32 plain version, whose own error adds to the
#   kernel's, the bound is twice that.
K3_TOL_L, K3_TOL_LINV = 1e-4, 2e-3
# - K1 (f32 assembly + 8-24-wide Cholesky, summed over 144 blocks): the plain
#   f32 path lies within ~1e-7 of float64 relative to the largest |ll|.
K1_TOL = 1e-5
# - K4 (f32 41 x 41 capacitance matrices M = G + diag(1/v)), per instance,
#   |ll - ll_64| / (|quad_64| / 2 + |half_logdet_64|): the f32 sweep carries
#   about cond(M) * eps of relative error into each term, and these M reach
#   condition numbers of ~1e3.
K4_TOL = 1e-4
# - The slice's log-posterior at 64 posterior points, f32 kernels against the
#   float64 plain path on the same emulators: the f32 GP predictive variance
#   k** - k*^T K^-1 k* cancels against ||K^-1|| ~ 1/noise. The same bar holds
#   the lowrank log-posterior, whose Woodbury quadratic c0 + 2 b.z + z G z -
#   r^T M^-1 r also cancels in f32.
LOGP_TOL = 1e-3
# - The closure batch's log-posterior of each point against a likelihood
#   built for that point alone, both f32 on the card at the same positions:
#   the same algorithm, rounded differently by cuBLAS at the two batch shapes.
CLOSURE_LOGP_TOL = 1e-4
# - Device tau (f32 torch.fft) against the host estimator on the downloaded
#   chains (f32 scipy FFT, f64 walker sums): both compute the exact linear ACF;
#   rounding can move Sokal's window by a lag near its edge. Split-R-hat:
#   f32 moments after global centering against the host's f64 sums.
TAU_RTOL, RHAT_ATOL = 1e-2, 1e-4
# - The f32 fit's LML at its optimum against a float64 recompute at the same
#   hyperparameters: the repo's fit-parity bar (docs/fit_schedule_study.json).
LML_TOL_NAT = 0.1
# - The mesh fit against the unsharded fit after the whole schedule, both f32
#   on the card: a share's batched GEMMs round differently from the whole
#   batch's, 60 L-BFGS iterations amplify that, and near ties in a rung's
#   ranking pick other survivors, so a PC can end in another optimum.
#   Measured on an H100: median |delta| 6e-5 nat, one of 41 PCs off by 1.37
#   nat on LMLs of ~256. Held: the median within LML_TOL_NAT, at most a tenth
#   of the PCs beyond it, and none beyond this bar. A share fed another PC's
#   targets would be off by tens of nats.
MESH_FIT_PATH_TOL_NAT = 5.0
ACCEPTANCE_RANGE = (0.05, 0.9)
# - The parity reference's float64 likelihood (library Cholesky) against the
#   kernels' plain version (the unrolled factorisation) at the same points,
#   max |delta| / max |lp|: two float64 factorisations of the same matrices.
#   Measured on an H100: 1.5e-16 (block), 1.1e-15 (lowrank).
REF_VS_UNROLLED_TOL = 1e-12
# - ``predict`` on the card (f32 GP predict and covariance) against the same
#   call on the CPU in float64, from the same artifacts: central values as
#   max |err| / max |value|, the covariance diagonal per entry relative. The
#   f32 GP variance k** - k*^T K^-1 k* cancels (most at the training design
#   points), and the truncation covariance adds to it. Measured on an H100:
#   central 2.1e-7 / 1.4e-7, diagonal 1.3e-4 / 1.1e-4 (195 design points /
#   100 posterior samples); the bars are under 10x those.
PREDICT_TOL_CENTRAL, PREDICT_TOL_DIAG = 2e-6, 1e-3

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# FP32 outside the tensor cores, and HBM3. A kernel's bound is the larger of
# its operations over the first and its bytes (each input read once, each
# output written once) over the second.
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events).

    The card first runs a spin kernel of about 5 ms, during which the host
    queues all the calls, so a kernel shorter than its wrapper's host
    overhead is timed on the device and not at the rate the host launches it.
    """
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel_fn, plain_fn, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, n_bytes: float) -> dict:
    """The least time the card could take for ``flops`` operations moving
    ``n_bytes`` bytes, and which of the two sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": n_bytes}


def timed(ms: float, plain_ms: float, b: dict, library_ms: float | None = None, **extra) -> dict:
    """A kernel's entry of the JSON record: its times beside its bound."""
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "share_of_bound": b["bound_ms"] / ms, "library_ms": library_ms, **extra}


def bound_text(ms: float, b: dict) -> str:
    return (f"bound {1e3 * b['bound_ms']:.2f} us ({b['bound_by']}: {b['flops'] / 1e6:.1f} MFLOP, "
            f"{b['bytes'] / 1e6:.3f} MB), share of bound {b['bound_ms'] / ms:.2%}")


@contextlib.contextmanager
def count_evaluations():
    """Count likelihood evaluations by mode while the block runs: every eager
    call of ``log_likelihood`` (not those a stream capture records, which run
    nothing), and two per step that a sampler program replays as a graph."""
    from bayesian_inference_tpu_torch.mcmc.likelihood import EmulatorLikelihood
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms

    inner, inner_chunk = EmulatorLikelihood.log_likelihood, SamplerPrograms.chunk
    calls = {"block": 0, "lowrank": 0}

    def counted(self, theta):
        if not torch.cuda.is_current_stream_capturing():
            calls[self.mode] += 1
        return inner(self, theta)

    def counted_chunk(self, state, like, n_steps, *args, **kwargs):
        if self.captured and not self._parts:  # a point-sharded program's shares count themselves
            calls[self.mode] += 2 * n_steps
        return inner_chunk(self, state, like, n_steps, *args, **kwargs)

    EmulatorLikelihood.log_likelihood = counted
    SamplerPrograms.chunk = counted_chunk
    try:
        yield calls
    finally:
        EmulatorLikelihood.log_likelihood = inner
        SamplerPrograms.chunk = inner_chunk


def check_k1_per_evaluation(launches: dict, calls: dict, path: str) -> None:
    """K1 runs once per block-mode likelihood evaluation: one launch for all buckets."""
    check(launches["fused_block_mvn"] == calls["block"],
          f"{path}: {launches['fused_block_mvn']} K1 launches for {calls['block']} block-mode evaluations")


def normwise_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max over instances of max|a - ref| / max|ref|."""
    diff = (a.double() - ref.double()).abs().amax((-2, -1))
    return float((diff / ref.double().abs().amax((-2, -1))).max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def counts(kernels) -> dict[str, int]:
    return {name: k.launches for name, k in kernels.items()}


def matern_blocks(B: int, n: int, device, seed: int = 0) -> torch.Tensor:
    """(B, n, n) float64 SPD Matern-1.5 grams (+ white noise) of random designs,
    with hyperparameters drawn from the GP fit's whole search box."""
    from bayesian_inference_tpu_torch.io.synthetic import THETA_MAX, THETA_MIN
    from bayesian_inference_tpu_torch.ops.gram import KernelConfig, KernelParams, train_gram

    rng = np.random.default_rng(seed)
    X = THETA_MIN + (THETA_MAX - THETA_MIN) * rng.random((B, n, 6))
    log_ls = np.log(THETA_MAX - THETA_MIN) + rng.uniform(np.log(0.01), np.log(100.0), (B, 6))
    log_noise = rng.uniform(np.log(1e-4), np.log(1.0), B)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    params = KernelParams(t(log_ls), t(log_noise), t(np.zeros(B)))
    return train_gram(KernelConfig(nu=1.5), params, t(X), 1e-6)


# K3's batch sizes on the main path: the fit's exploration (41 PCs x 51
# restarts), polish (41 x 3) and posterior (41) stages, and its launches at
# each per fit (1 + 15, 1 + 45 and 1 LML evaluations, 4 diagonal blocks each).
# A fit that builds its two programs first adds their warm-up iterations.
K3_BATCHES = (41 * 51, 41 * 3, 41)
K3_FIT_LAUNCHES = {41 * 51: 64, 41 * 3: 184, 41: 4}
K3_BLOCKS = 4  # diagonal blocks of the N = 195 gram, padded to 256


def k3_fit_launches_with_warmup() -> dict[int, int]:
    """K3's launches by batch of a production fit that builds both its programs."""
    from bayesian_inference_tpu_torch.models.gp_fit import WARMUP_ITERATIONS

    warm = K3_BLOCKS * WARMUP_ITERATIONS
    return {41 * 51: 64 + warm, 41 * 3: 184 + warm, 41: 4}


@contextlib.contextmanager
def count_k3_batches():
    """K3's launches by batch size while the block runs, filled in when it
    ends: the wrapper's own count by batch, which follows graph replays."""
    from collections import Counter

    from bayesian_inference_tpu_torch.ops import blocked_cholesky as bc

    before = Counter(bc.KERNEL.launches_by_batch)
    batches = Counter()
    try:
        yield batches
    finally:
        batches.update(bc.KERNEL.launches_by_batch - before)


def phase_k3(device, reps: int = 20) -> list[dict]:
    """K3 (diag_chol_inv) against its plain version and the library route at
    the fit's batch sizes, largest first."""
    from bayesian_inference_tpu_torch.ops import blocked_cholesky as bc

    n = bc.NB
    results = []
    for B in K3_BATCHES:
        A64 = matern_blocks(B, n, device)
        A = A64.float().contiguous()
        L, Linv = bc.diag_chol_inv(A)
        torch.cuda.synchronize()
        Lp, Linvp = bc.diag_chol_inv_plain(A)
        L64, Linv64 = bc.diag_chol_inv_plain(A64)
        err = {
            "L_rel": normwise_rel(L, Lp),
            "Linv_rel": normwise_rel(Linv, Linvp),
            "L_rel_f64_kernel": normwise_rel(L, L64),
            "L_rel_f64_plain": normwise_rel(Lp, L64),
            "Linv_rel_f64_kernel": normwise_rel(Linv, Linv64),
            "Linv_rel_f64_plain": normwise_rel(Linvp, Linv64),
        }
        max_abs = float(max((L - Lp).abs().max(), (Linv - Linvp).abs().max()))
        check(bool(torch.isfinite(L).all() and torch.isfinite(Linv).all()), "K3: non-finite factor of an SPD block")
        for key, tol in (("L_rel_f64_kernel", K3_TOL_L), ("Linv_rel_f64_kernel", K3_TOL_LINV),
                         ("L_rel", 2 * K3_TOL_L), ("Linv_rel", 2 * K3_TOL_LINV)):
            check(err[key] <= tol, f"K3 B={B}: {key} = {err[key]:.3g} > {tol}")
        L2, Linv2 = bc.diag_chol_inv(A)
        repeat = bool(torch.equal(L, L2) and torch.equal(Linv, Linv2))
        check(repeat, f"K3 B={B}: repeated launches are not bit-equal")

        # A block that is not positive definite must come back as NaN, and only it.
        bad = A[:4].clone()
        bad[1] = -bad[1]
        Lb, Linvb = bc.diag_chol_inv(bad)
        torch.cuda.synchronize()
        check(bool(torch.isnan(Lb[1]).any() and torch.isnan(Linvb[1]).any())
              and bool(torch.isfinite(Lb[[0, 2, 3]]).all() and torch.isfinite(Linvb[[0, 2, 3]]).all()),
              "K3: a non-SPD block must yield NaN without touching its neighbours")

        eye = torch.eye(n, dtype=A.dtype, device=device).expand_as(A)

        def library():  # the library route: cholesky_ex, then solve_triangular of I
            return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(A)[0], eye, upper=False)

        ms, plain_ms = time_pair(lambda: bc.diag_chol_inv(A), lambda: bc.diag_chol_inv_plain(A), reps)
        library_ms = cuda_ms(library, reps)
        # Cholesky + triangular inverse; read A's lower triangle (all a Cholesky
        # needs), write L and L^-1 whole (zeros above the diagonal included)
        b = bound(B * 2 * n**3 / 3, 4 * B * (n * (n + 1) / 2 + 2 * n * n))
        print(f"K3 diag_chol_inv ({B}, {n}, {n}) f32: normwise rel err vs float64 plain: kernel "
              f"L {err['L_rel_f64_kernel']:.3g} (tol {K3_TOL_L}) / L^-1 {err['Linv_rel_f64_kernel']:.3g} "
              f"(tol {K3_TOL_LINV}), plain f32 L {err['L_rel_f64_plain']:.3g} / L^-1 "
              f"{err['Linv_rel_f64_plain']:.3g}; kernel vs plain f32: L {err['L_rel']:.3g} / L^-1 "
              f"{err['Linv_rel']:.3g} (tol twice the above), max abs err {max_abs:.3g}; bit-equal on repeat; "
              f"non-SPD -> NaN ok; kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, library (cholesky_ex + "
              f"solve_triangular) {library_ms:.4f} ms/call; {bound_text(ms, b)}", flush=True)
        results.append({"max_abs_err": max_abs, **timed(ms, plain_ms, b, library_ms, shape=f"({B}, {n}, {n})")})
    return results


def mvn_buckets(W: int, device, dtype, seed: int = 1, k: int = N_PCS, n_points: int = 0, extra_widths=()):
    """Bucketed block-likelihood operands shaped like the production buckets
    ({8: 40, 16: 96, 24: 8} blocks, k PCs) and per-walker PC means/variances.
    With ``n_points``, each bucket's d0 is (n_points, n_obs_b, nb), one offset
    table per point, and the W walkers are split evenly over the points.
    ``extra_widths``: blocks of these widths besides the production ones."""
    from bayesian_inference_tpu_torch.mcmc.likelihood import bucketize_blocks

    rng = np.random.default_rng(seed)
    widths = [*rng.integers(1, 9, 40), *rng.integers(9, 17, 96), *rng.integers(17, 25, 8), *extra_widths]
    colscale = np.exp(-np.arange(k) / 10.0)
    U = [rng.normal(size=(w, k)) * colscale * 0.2 for w in widths]
    D = []
    for w in widths:
        A = rng.normal(size=(w, w)) * 0.05
        D.append(A @ A.T + np.diag(rng.uniform(0.005, 0.05, w)))
    d0 = [rng.normal(size=(max(n_points, 1), w)) * 0.2 for w in widths]
    z = rng.normal(size=(W, k)) * colscale
    v = rng.uniform(1e-3, 0.1, (W, k)) * colscale
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    Ub, Db, _ = bucketize_blocks(U, D, [x[0] for x in d0])
    per_point = [bucketize_blocks(U, D, [x[p] for x in d0])[2] for p in range(max(n_points, 1))]
    d0b = [np.stack(b) for b in zip(*per_point)] if n_points else per_point[0]
    return [(t(u), t(dd), t(o)) for u, dd, o in zip(Ub, Db, d0b)], t(z), t(v)


def k1_bound(buckets, z, v) -> dict:
    """K1's bound at these operands: per walker and block, the assembly's
    nb (nb + 1) / 2 * k FMA, the residual's nb * k, the Cholesky's nb^3 / 6 and
    the forward solve's nb^2 / 2 (padded widths, as the buckets hold them);
    every operand read once and the (W,) result written once."""
    W, k = z.shape
    fma = sum(n_obs * (nb * (nb + 1) / 2 * k + nb * k + nb**3 / 6 + nb**2 / 2)
              for n_obs, nb, _ in (b[0].shape for b in buckets))
    n_bytes = 4 * (sum(t.numel() for b in buckets for t in b) + z.numel() + v.numel() + W)
    return bound(2 * W * fma, n_bytes)


def phase_k1(device, W: int, reps: int = 50) -> dict:
    """K1 (fused_block_mvn_loglike_buckets: every bucket in one launch) against
    its plain version: f32 on the card, with the plain version in float64 as
    the reference."""
    from bayesian_inference_tpu_torch.ops import fused_mvn

    buckets, z, v = mvn_buckets(W, device, torch.float32)
    buckets64, z64, v64 = mvn_buckets(W, device, torch.float64)
    check([b[0].shape[:2] for b in buckets] == [(40, 8), (96, 16), (8, 24)], "K1: unexpected bucket layout")
    Us, Ds, d0s = zip(*buckets)

    def kernel():
        return fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)

    def plain():
        return fused_mvn.fused_block_mvn_buckets_plain(Us, Ds, d0s, z, v)

    before = fused_mvn.KERNEL.launches
    ll = kernel()
    torch.cuda.synchronize()
    check(fused_mvn.KERNEL.launches == before + 1, "K1: the all-bucket call is not one launch")
    ll_plain = plain()
    ll64 = fused_mvn.fused_block_mvn_buckets_plain(*zip(*buckets64), z64, v64)
    scale = float(ll64.abs().max())
    rel = float((ll.double() - ll64).abs().max()) / scale
    rel_plain = float((ll_plain.double() - ll64).abs().max()) / scale
    max_abs = float((ll - ll_plain).abs().max())
    check(ll.shape == (W,) and bool(torch.isfinite(ll).all()), "K1: non-finite or misshapen log-likelihood")
    check(rel <= K1_TOL, f"K1: W={W} differs from the float64 plain path by {rel:.3g} > {K1_TOL}")
    check(bool(torch.equal(ll, kernel())), "K1: repeated launches are not bit-equal")
    ms, plain_ms = time_pair(kernel, plain, reps)
    b = k1_bound(buckets, z, v)
    print(f"K1 fused_block_mvn W={W}, buckets nb 8/16/24 x 40/96/8 blocks, k=41, f32: max abs err vs plain f32 "
          f"{max_abs:.3g}; max err / max|ll| vs float64: kernel {rel:.3g}, plain f32 {rel_plain:.3g} "
          f"(tol {K1_TOL}); bit-equal on repeat; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"per likelihood evaluation (one all-bucket call); {bound_text(ms, b)}", flush=True)
    return {"max_abs_err": max_abs, **timed(ms, plain_ms, b, shape=f"W={W}, nb 8/16/24 x 40/96/8, k=41")}


def phase_k1_points(device, P: int = 30, Wh: int = 50, reps: int = 20) -> dict:
    """K1 with one residual-offset table per point (the block-mode closure
    batch): P * Wh walkers in one launch per bucket, against P single-point
    launches (bit-equal) and against the plain version."""
    from bayesian_inference_tpu_torch.ops import fused_mvn

    W = P * Wh
    buckets, z, v = mvn_buckets(W, device, torch.float32, seed=3, n_points=P)
    buckets64, z64, v64 = mvn_buckets(W, device, torch.float64, seed=3, n_points=P)
    check([b[2].shape for b in buckets] == [(P, 40, 8), (P, 96, 16), (P, 8, 24)], "K1 points: d0 layout")
    Us, Ds, d0s = zip(*buckets)

    def kernel():
        return fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)

    def plain():
        return fused_mvn.fused_block_mvn_buckets_plain(Us, Ds, d0s, z, v)

    ll = kernel()
    single = torch.cat([
        fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, tuple(d0[p].contiguous() for d0 in d0s),
                                                  z[p * Wh:(p + 1) * Wh].contiguous(),
                                                  v[p * Wh:(p + 1) * Wh].contiguous())
        for p in range(P)
    ])
    torch.cuda.synchronize()
    ll_plain = plain()
    ll64 = fused_mvn.fused_block_mvn_buckets_plain(*zip(*buckets64), z64, v64)
    rel = float((ll.double() - ll64).abs().max()) / float(ll64.abs().max())
    max_abs = float((ll - ll_plain).abs().max())
    ms, plain_ms = time_pair(kernel, plain, reps)
    b = k1_bound(buckets, z, v)
    print(f"K1 fused_block_mvn per-point d0, P={P} x Wh={Wh} walkers, production buckets, f32: bit-equal to {P} "
          f"single-point launches: {bool(torch.equal(ll, single))}; max abs err vs plain f32 {max_abs:.3g}; "
          f"max err / max|ll| vs float64 {rel:.3g} (tol {K1_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"per likelihood evaluation (one all-bucket call); {bound_text(ms, b)}", flush=True)
    check(ll.shape == (W,) and bool(torch.isfinite(ll).all()), "K1 points: non-finite or misshapen result")
    check(bool(torch.equal(ll, single)), "K1 points: not bit-equal to single-point launches")
    check(rel <= K1_TOL, f"K1 points: differs from the float64 plain path by {rel:.3g} > {K1_TOL}")
    check(bool(torch.equal(ll, kernel())), "K1 points: repeated launches are not bit-equal")
    return {"max_abs_err": max_abs, **timed(ms, plain_ms, b, shape=f"P={P} x Wh={Wh}, nb 8/16/24 x 40/96/8, k=41")}


def phase_k1_widths(device, W: int = N_WALKERS // 2, reps: int = 50) -> tuple[dict, dict]:
    """K1 at the widths JAX computes and the kernel once refused: the
    production buckets beside one 56-wide bucket (one K1 launch for the
    three narrow ones, the dense path for the wide one, as JAX goes dense
    above 48), and the production buckets at k = 160 PCs (staged 128 at a
    time), each against the float64 plain version. Returns (the k = 160
    entry of the kernels record, the dense route's times)."""
    from bayesian_inference_tpu_torch.ops import fused_mvn

    buckets, z, v = mvn_buckets(W, device, torch.float32, extra_widths=(56,))
    buckets64, z64, v64 = mvn_buckets(W, device, torch.float64, extra_widths=(56,))
    check([b[0].shape[:2] for b in buckets] == [(40, 8), (96, 16), (8, 24), (1, 56)],
          "K1 widths: unexpected bucket layout")
    Us, Ds, d0s = zip(*buckets)
    before = fused_mvn.KERNEL.launches
    ll = fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)
    torch.cuda.synchronize()
    launches = fused_mvn.KERNEL.launches - before
    ll64 = fused_mvn.fused_block_mvn_buckets_plain(*zip(*buckets64), z64, v64)
    rel = float((ll.double() - ll64).abs().max()) / float(ll64.abs().max())
    repeat = bool(torch.equal(ll, fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)))

    def mixed():
        return fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)

    def narrow():
        return fused_mvn.fused_block_mvn_loglike_buckets(Us[:3], Ds[:3], d0s[:3], z, v)

    def dense():  # the 56-wide bucket alone: no launch, the dense path
        return fused_mvn.fused_block_mvn_loglike_buckets(Us[3:], Ds[3:], d0s[3:], z, v)

    mixed_ms, narrow_ms = time_pair(mixed, narrow, reps)
    dense_ms = cuda_ms(dense, reps)
    b_dense = k1_bound(buckets[3:], z, v)
    print(f"K1 widths: production buckets + one nb=56 bucket, W={W}, k=41, f32: {launches} K1 launch for the call "
          f"(the 56-wide bucket dense, as JAX above 48); max err / max|ll| vs float64 {rel:.3g} (tol {K1_TOL}); "
          f"bit-equal on repeat: {repeat}; whole call {mixed_ms:.4f} ms, its three narrow buckets alone (one K1 "
          f"launch) {narrow_ms:.4f} ms, the 56-wide bucket alone (dense, no kernel) {dense_ms:.4f} ms; dense "
          f"{bound_text(dense_ms, b_dense)}", flush=True)
    check(launches == 1, f"K1 widths: {launches} K1 launches for one call with a 56-wide bucket")
    check(ll.shape == (W,) and bool(torch.isfinite(ll).all()), "K1 widths: non-finite or misshapen result")
    check(rel <= K1_TOL, f"K1 widths: differs from the float64 plain path by {rel:.3g} > {K1_TOL}")
    check(repeat, "K1 widths: repeated calls are not bit-equal")
    dense_route = {"shape": f"W={W}, one 56-wide block, k=41", "ms": dense_ms, "bound_ms": b_dense["bound_ms"],
                   "bound_by": b_dense["bound_by"], "whole_call_ms": mixed_ms, "narrow_buckets_ms": narrow_ms}

    k = 160
    buckets, z, v = mvn_buckets(W, device, torch.float32, k=k)
    buckets64, z64, v64 = mvn_buckets(W, device, torch.float64, k=k)
    Us, Ds, d0s = zip(*buckets)

    def kernel():
        return fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)

    def plain():
        return fused_mvn.fused_block_mvn_buckets_plain(Us, Ds, d0s, z, v)

    before = fused_mvn.KERNEL.launches
    ll = kernel()
    torch.cuda.synchronize()
    launches = fused_mvn.KERNEL.launches - before
    ll_plain = plain()
    ll64 = fused_mvn.fused_block_mvn_buckets_plain(*zip(*buckets64), z64, v64)
    rel = float((ll.double() - ll64).abs().max()) / float(ll64.abs().max())
    max_abs = float((ll - ll_plain).abs().max())
    repeat = bool(torch.equal(ll, kernel()))
    ms, plain_ms = time_pair(kernel, plain, reps)
    b = k1_bound(buckets, z, v)
    print(f"K1 fused_block_mvn W={W}, production buckets, k={k} (PCs staged 128 at a time), f32: {launches} launch; "
          f"max abs err vs plain f32 {max_abs:.3g}; max err / max|ll| vs float64 {rel:.3g} (tol {K1_TOL}); "
          f"bit-equal on repeat: {repeat}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {bound_text(ms, b)}",
          flush=True)
    check(launches == 1, f"K1 k={k}: {launches} launches for one call")
    check(ll.shape == (W,) and bool(torch.isfinite(ll).all()), f"K1 k={k}: non-finite or misshapen result")
    check(rel <= K1_TOL, f"K1 k={k}: differs from the float64 plain path by {rel:.3g} > {K1_TOL}")
    check(repeat, f"K1 k={k}: repeated launches are not bit-equal")
    return {"max_abs_err": max_abs, **timed(ms, plain_ms, b, shape=f"W={W}, nb 8/16/24 x 40/96/8, k={k}")}, dense_route


def capacitance_operands(B: int, device, dtype, seed: int = 4, k: int = N_PCS, F: int = 1644):
    """(r, M) shaped like the lowrank likelihood's capacitance solve:
    M = G + diag(1/v), G = W^T W of a (F, k) factor with decaying column
    scales, v the GP variances of B walkers, r = b + G z."""
    rng = np.random.default_rng(seed)
    colscale = np.exp(-np.arange(k) / 10.0)
    Wf = rng.normal(size=(F, k)) * colscale * 0.05
    G = Wf.T @ Wf
    v = rng.uniform(1e-3, 0.1, (B, k)) * colscale
    z = rng.normal(size=(B, k)) * colscale
    b = rng.normal(size=k)
    M = G + np.einsum("bk,kj->bkj", 1.0 / v, np.eye(k))
    r = b + z @ G
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return t(r), t(M)


def phase_k4(device, reps: int = 50) -> list[dict]:
    """K4 (block_mvn_loglike) at the lowrank batch sizes, B = 1,500 (30
    closure points x 50) and 50 (one analysis, half-ensemble), with the
    production k = 41 PCs; then at k = 64, the widest capacitance matrix the
    kernel takes, against the float64 plain version (the dense path there)."""
    from bayesian_inference_tpu_torch.ops import tiny_mvn

    results = []
    for B, n in ((1500, N_PCS), (50, N_PCS), (50, tiny_mvn.MAX_NB)):
        r, M = capacitance_operands(B, device, torch.float32, k=n)
        r64, M64 = capacitance_operands(B, device, torch.float64, k=n)
        ll = tiny_mvn.block_mvn_loglike(r, M)
        quad, half_logdet = tiny_mvn.mvn_terms(r, M)
        torch.cuda.synchronize()
        ll_plain = tiny_mvn.block_mvn_plain(r, M)
        quad64, hld64 = tiny_mvn.mvn_terms_plain(r64, M64)
        ll64 = -0.5 * quad64 - hld64
        scale = 0.5 * quad64.abs() + hld64.abs()
        rel = float(((ll.double() - ll64).abs() / scale).max())
        rel_plain = float(((ll_plain.double() - ll64).abs() / scale).max())
        # the Woodbury combination +quad/2 - half_logdet from the same sweep
        wrel = float(((0.5 * quad.double() - half_logdet.double() - (0.5 * quad64 - hld64)).abs() / scale).max())
        max_abs = float((ll - ll_plain).abs().max())
        cond = torch.linalg.cond(M64)
        repeat = bool(torch.equal(ll, tiny_mvn.block_mvn_loglike(r, M)))

        bad = M[:8].clone()
        bad[3] = -bad[3]
        ll_bad = tiny_mvn.block_mvn_loglike(r[:8].contiguous(), bad)
        torch.cuda.synchronize()
        nan_ok = bool(torch.isnan(ll_bad[3])) and bool(torch.isfinite(ll_bad[[0, 1, 2, 4, 5, 6, 7]]).all())

        # the kernel's function as the lowrank likelihood calls it: (quad, half_logdet)
        ms, plain_ms = time_pair(lambda: tiny_mvn.mvn_terms(r, M), lambda: tiny_mvn.mvn_terms_plain(r, M), reps)
        # One library call computes the same function (Cholesky, quadratic
        # form and log det of each instance), timed in turns with the kernel.
        zeros = torch.zeros(n, dtype=r.dtype, device=device)

        def library():
            return torch.distributions.MultivariateNormal(zeros, covariance_matrix=M, validate_args=False).log_prob(r)

        _, library_ms = time_pair(lambda: tiny_mvn.mvn_terms(r, M), library, reps)
        library_err = float((library().double() + 0.5 * n * math.log(2 * math.pi) - ll64).abs().div(scale).max())
        # Cholesky + solve; read M's lower triangle and r, write quad and half_logdet
        b = bound(B * (n**3 / 3 + n * n), 4 * B * (n * (n + 1) / 2 + n + 2))
        print(f"K4 block_mvn B={B} capacitance M = G + diag(1/v), k={n} (cond {float(cond.min()):.3g}.."
              f"{float(cond.max()):.3g}), f32: max per-instance err / (|quad|/2 + |half_logdet|) vs float64: "
              f"kernel {rel:.3g}, plain f32 {rel_plain:.3g}, Woodbury combination {wrel:.3g} (tol {K4_TOL}); "
              f"max abs err vs plain f32 {max_abs:.3g}; non-SPD -> NaN in that instance only: {nan_ok}; "
              f"bit-equal on repeat: {repeat}; kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, library "
              f"MultivariateNormal.log_prob {library_ms:.4f} ms/call (its err vs float64 {library_err:.3g}); "
              f"{bound_text(ms, b)}", flush=True)
        what = f"K4 at B={B}, k={n}"
        check(ll.shape == (B,) and bool(torch.isfinite(ll).all()), f"{what}: non-finite or misshapen result")
        check(rel <= K4_TOL and wrel <= K4_TOL, f"{what}: differs from float64 by {max(rel, wrel):.3g} > {K4_TOL}")
        check(nan_ok, "K4: a non-SPD instance must yield NaN without touching its neighbours")
        check(repeat, "K4: repeated launches are not bit-equal")
        results.append({"max_abs_err": max_abs, **timed(ms, plain_ms, b, library_ms, shape=f"B={B}, {n} x {n}")})
    return results


def phase_k4_wide(device, B: int = 50, n: int = 72, reps: int = 50) -> dict:
    """Capacitance matrices wider than K4 takes (72 PCs): on the card the
    wrapper takes the dense path, as JAX does above 48, launching no kernel;
    held against the float64 plain version with K4's bar. Returns the dense
    route's times."""
    from bayesian_inference_tpu_torch.ops import tiny_mvn

    r, M = capacitance_operands(B, device, torch.float32, k=n)
    r64, M64 = capacitance_operands(B, device, torch.float64, k=n)
    before = tiny_mvn.KERNEL.launches
    quad, half_logdet = tiny_mvn.mvn_terms(r, M)
    torch.cuda.synchronize()
    launches = tiny_mvn.KERNEL.launches - before
    quad64, hld64 = tiny_mvn.mvn_terms_plain(r64, M64)
    scale = 0.5 * quad64.abs() + hld64.abs()
    ll = -0.5 * quad.double() - half_logdet.double()
    rel = float(((ll - (-0.5 * quad64 - hld64)).abs() / scale).max())
    wrel = float(((0.5 * quad.double() - half_logdet.double() - (0.5 * quad64 - hld64)).abs() / scale).max())
    ms = cuda_ms(lambda: tiny_mvn.mvn_terms(r, M), reps)
    b = bound(B * (n**3 / 3 + n * n), 4 * B * (n * (n + 1) / 2 + n + 2))
    print(f"K4 widths: B={B} capacitance matrices of k={n} PCs, f32 on the card: {launches} K4 launches (dense, as "
          f"JAX above 48); max per-instance err / (|quad|/2 + |half_logdet|) vs float64: loglike {rel:.3g}, Woodbury "
          f"combination {wrel:.3g} (tol {K4_TOL}); dense route {ms:.4f} ms/call; {bound_text(ms, b)}", flush=True)
    check(launches == 0, f"K4 widths: {launches} K4 launches at k={n}")
    check(bool(torch.isfinite(quad).all() and torch.isfinite(half_logdet).all()), "K4 widths: non-finite terms")
    check(rel <= K4_TOL and wrel <= K4_TOL, f"K4 widths: differs from float64 by {max(rel, wrel):.3g} > {K4_TOL}")
    return {"shape": f"B={B}, {n} x {n}", "ms": ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def production_config(work_dir: Path, table_dir: Path, n_walkers: int, n_burn: int, n_steps: int,
                      n_restarts: int) -> dict:
    """The top-level configuration dict bench.py writes for its production profile."""
    from bayesian_inference_tpu_torch.io.synthetic import THETA_MAX, THETA_MIN

    emulators = {
        name: {
            "force_retrain": True,
            "n_pc": g["n_pc"],
            "max_n_components_to_calculate": 30,
            "kernels": {
                "active": ["matern", "noise"],
                "matern": {"nu": 1.5, "length_scale_bounds_factor": [0.01, 100]},
                "noise": {"type": "white", "args": {"noise_level": 0.25, "noise_level_bounds": [0.0001, 1]}},
            },
            "GPR": {"n_restarts": n_restarts, "alpha": 1.0e-6},
            "observable_list": g["observable_list"],
        }
        for name, g in PRODUCTION_GROUPS.items()
    }
    analysis = {
        "parameterizations": [PARAMETERIZATION],
        "sqrts_list": [200, 2760, 5020],
        "centrality_range": [0, 10],
        "parameterization": {
            PARAMETERIZATION: {
                "names": ["alpha_s", "Q0", "c_1", "c_2", "tau_0", "c_3"],
                "min": THETA_MIN.tolist(),
                "max": THETA_MAX.tolist(),
            }
        },
        "validation_indices": [200, 230],
        "design_points_to_exclude": [17, 43],
        "parameters": {
            "emulators": emulators,
            "mcmc": {"n_walkers": n_walkers, "n_burn_steps": n_burn, "n_sampling_steps": n_steps,
                     "n_logging_steps": 1000},
        },
    }
    return {
        "output_dir": str(work_dir / "output"),
        "observable_table_dir": str(table_dir),
        "observable_config_dir": str(table_dir),
        "observables_filename": "observables.h5",
        "analyses": {ANALYSIS: analysis},
    }


def mcmc_config(n_steps: int):
    """The production MCMC config with ``n_steps`` production steps."""
    config = production_config(WORK_DIR, WORK_DIR / "production_tables", N_WALKERS, N_BURN, n_steps, N_RESTARTS)
    return mcmc_config_for(config, n_steps)


def mcmc_config_for(config: dict, n_steps: int):
    """The MCMC config of ``config``'s analysis, with ``n_steps`` production steps."""
    import copy

    from bayesian_inference_tpu_torch.pipeline.configs import MCMCConfig

    config = copy.deepcopy(config)
    analysis = config["analyses"][ANALYSIS]
    analysis["parameters"]["mcmc"]["n_sampling_steps"] = n_steps
    return MCMCConfig(ANALYSIS, PARAMETERIZATION, analysis, config=config)


def production_data() -> dict:
    """The production-width inputs every path phase shares: the synthetic
    production tables, ingested in memory, and the configs over them."""
    from bayesian_inference_tpu_torch.io.synthetic import make_production_tables
    from bayesian_inference_tpu_torch.io.tables import initialize_observables_dict_from_tables
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig, MCMCConfig

    t = time.perf_counter()
    table_dir = WORK_DIR / "production_tables"
    make_production_tables(table_dir)
    config = production_config(WORK_DIR, table_dir, N_WALKERS, N_BURN, N_STEPS, N_RESTARTS)
    analysis = config["analyses"][ANALYSIS]
    observables = initialize_observables_dict_from_tables(str(table_dir), analysis, PARAMETERIZATION)
    emu = EmulationConfig.from_config_file(ANALYSIS, PARAMETERIZATION, analysis, config=config)
    mcmc = MCMCConfig(ANALYSIS, PARAMETERIZATION, analysis, config=config)
    n_obs = len(observables["Prediction"])
    n_features = sum(np.atleast_2d(p["y"]).shape[0] for p in observables["Prediction"].values())
    n_design = observables["Design"].shape[0]
    print(f"data: {n_obs} observables / {n_features} features / design ({n_design}, "
          f"{observables['Design'].shape[1]}) from the synthetic production tables, "
          f"{time.perf_counter() - t:.2f} s (set-up)", flush=True)
    return {"table_dir": table_dir, "observables": observables, "emu": emu, "mcmc": mcmc}


def wall_ms_per_step(fn, n_steps: int) -> float:
    """Host-clock milliseconds per step of ``fn()``, a run of ``n_steps``
    sampler steps, the device drained before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / n_steps


def profiled_device_rows(fn) -> list[tuple[float, int, str]]:
    """(device microseconds, launches, name) of every kernel and copy that
    ``torch.profiler`` saw on the card while ``fn()`` ran, largest first.
    Only the profiler's device rows count: a host op's row repeats the time
    of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)


def device_ms_per_step(fn, n_steps: int, top: int = 8) -> tuple[float | None, str]:
    """Device-busy milliseconds per step of ``fn()``, a run of ``n_steps``
    sampler steps: the summed duration of every kernel and copy that
    ``torch.profiler`` saw on the card (one stream, so they do not overlap);
    and the ``top`` kernels by that time, as "name ms/step (launches/step)".
    (None, "") when the profiler reports no device time."""
    rows = profiled_device_rows(fn)
    busy_us = sum(us for us, _, _ in rows)
    if busy_us <= 0:
        return None, ""
    kernels = ", ".join(f"{key[:48]} {us / 1e3 / n_steps:.4f} ({count / n_steps:.1f})" for us, count, key in rows[:top])
    n_kernels = sum(count for _, count, _ in rows) / n_steps
    return busy_us / 1e3 / n_steps, f"{n_kernels:.1f} kernels and copies per step; {kernels}"


def same_chunk(a, b) -> dict[str, bool]:
    """Bit equality of two chunk results (final state, (chain, log-probs, acceptance))."""
    (sa, ya), (sb, yb) = a, b
    names = ("coords", "final_log_prob", "n_accepted", "chain", "log_prob", "acceptance")
    return {n: bool(torch.equal(x, y)) for n, x, y in zip(names, (*sa, *ya), (*sb, *yb))}


def phase_programs(device, kernels, data: dict) -> dict:
    """The sampler programs against the eager loop at production width (41
    PCs, 100 walkers; 30 points x 100 walkers for the batch), on emulators
    fitted here with a short schedule: bit equality over 200 steps, from a
    program captured on the fitted likelihood and from one captured on the
    placeholder likelihood; the replay-aware launch counts; then eager,
    program, program, eager timed in turns. Returns the measured rates."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc import likelihood as lik
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms, likelihood_shape_spec
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig
    from bayesian_inference_tpu_torch.utils import flops

    observables, mcmc = data["observables"], data["mcmc"]
    config = production_config(WORK_DIR, data["table_dir"], N_WALKERS, N_BURN, N_STEPS, PROGRAM_FIT["n_restarts"])
    emu = EmulationConfig.from_config_file(ANALYSIS, PARAMETERIZATION, config["analyses"][ANALYSIS], config=config)
    artifacts = fit_emulators(emu, seed=1, n_opt_iters=PROGRAM_FIT["n_opt_iters"], device=device,
                              observables=observables, write=False)
    box = mcmc.parameterization_spec()
    lo, hi = np.asarray(box["min"], float), np.asarray(box["max"], float)
    ndim, W = lo.size, N_WALKERS
    data_kw = dict(observable_filter=emu.observable_filter, observables=observables)
    experimental = obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, **data_kw)
    P = observables["Design_validation"].shape[0]
    y_batch = np.stack([obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, pseudodata_index=i,
                                                  rng=np.random.default_rng(i), **data_kw)["y"] for i in range(P)])
    peak_tflops = flops.device_peak_tflops(device)
    smi = nvidia_smi_line()
    kernel_of = {"block": "fused_block_mvn", "lowrank": "block_mvn"}
    results = {}

    for mode in ("block", "lowrank"):
        like1 = lik.build_likelihood(emu, artifacts, experimental, lo, hi, mode=mode, device=device,
                                     observables=observables)
        spec = likelihood_shape_spec(emu, lo, hi, mode=mode, device=device, observables=observables)
        dt = like1.theta_min.dtype
        if mode == "block":
            d0 = tuple(torch.tensor(d, dtype=dt, device=device)
                       for d in lik.pad_residual_offsets(emu, artifacts, y_batch, observables))
        else:
            d0 = torch.tensor(lik.residual_offsets_flat(emu, artifacts, y_batch, observables), dtype=dt, device=device)
        step_flops = flops.mcmc_step_flops(like1, W)
        for n_points, like in ((None, like1), (P, like1.with_d0(d0))):
            name = f"{mode}" + (f" batch P={P}" if n_points else "")
            lead = (n_points,) if n_points else ()
            gens = [torch.Generator(device=device).manual_seed(100 + i) for i in range(n_points or 1)]
            draw_from = gens if n_points else gens[0]
            x0 = like.theta_min + (like.theta_max - like.theta_min) * torch.rand(
                (*lead, W, ndim), generator=gens[0], dtype=dt, device=device)
            fn = like.log_posterior
            eager_chunk = stretch.run_chunk_batched if n_points else stretch.run_chunk
            pregen = stretch.pregen_rands_batched if n_points else stretch.pregen_rands
            rands = pregen(PROGRAM_CHECK_STEPS, W, draw_from, dt)
            state0 = stretch.init_state(fn, x0)
            eager = eager_chunk(state0, fn, PROGRAM_CHECK_STEPS, rands=rands)

            # Two programs in turn: captured on the fitted likelihood, and
            # captured on the placeholder and then fed the fitted one (the
            # operand style).
            torch.cuda.synchronize()
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            same = {}
            for origin, like_spec in (("fitted", like), ("placeholder", spec)):
                programs = SamplerPrograms(like_spec, W, ndim, [PROGRAM_TIMED_STEPS], n_points=n_points)
                programs.compile()
                check(programs.serves(like, W, ndim, n_points),
                      f"programs {name}: the {origin} capture does not serve the fitted likelihood's shapes")
                state_p = programs.init(like, x0)
                check(bool(torch.equal(state_p.log_prob, state0.log_prob)), f"programs {name}: init differs")
                reset(kernels)
                out = programs.chunk(state_p, like, PROGRAM_CHECK_STEPS, rands=rands)
                torch.cuda.synchronize()
                launches = counts(kernels)
                same[origin] = same_chunk(out, eager)
                check(launches[kernel_of[mode]] == 2 * PROGRAM_CHECK_STEPS and sum(launches.values()) ==
                      2 * PROGRAM_CHECK_STEPS, f"programs {name} ({origin}): {launches} launches counted over "
                      f"{PROGRAM_CHECK_STEPS} replayed steps, expected {2 * PROGRAM_CHECK_STEPS} of {kernel_of[mode]}")
                if origin == "fitted":
                    del programs, out  # one program alive at a time: the peak below is one program's
            capture_s = programs.compile_seconds

            # In turns: eager, program, program, eager; draws from the
            # generator inside each run, as the runners make them.
            def run_eager():
                eager_chunk(state0, fn, PROGRAM_EAGER_STEPS, draw_from)

            def run_program():
                programs.chunk(state0, like, PROGRAM_TIMED_STEPS, generator=draw_from)

            run_program()  # the first replays after a capture
            turns = [wall_ms_per_step(run_eager, PROGRAM_EAGER_STEPS), wall_ms_per_step(run_program, PROGRAM_TIMED_STEPS),
                     wall_ms_per_step(run_program, PROGRAM_TIMED_STEPS), wall_ms_per_step(run_eager, PROGRAM_EAGER_STEPS)]
            peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
            eager_ms, program_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            # Busy share: device time per step under the profiler over the
            # wall time per step of the turns above, taken without it.
            profiled = {"eager": device_ms_per_step(lambda: eager_chunk(state0, fn, PROGRAM_PROFILED_STEPS, draw_from),
                                                    PROGRAM_PROFILED_STEPS),
                        "program": device_ms_per_step(lambda: programs.chunk(state0, like, PROGRAM_PROFILED_STEPS,
                                                                             generator=draw_from),
                                                      PROGRAM_PROFILED_STEPS)}
            busy = {k: v[0] for k, v in profiled.items()}
            wall = {"eager": eager_ms, "program": program_ms}
            busy_text = ", ".join(
                f"{k} not measured (the profiler saw no device time)" if v is None
                else f"{k} {v:.4f} ms/step = {v / wall[k]:.1%} of its wall time" for k, v in busy.items())
            points = n_points or 1
            tflops = points * step_flops / (program_ms * 1e-3) / 1e12
            print(f"programs {name}: {W} walkers, {PROGRAM_CHECK_STEPS} steps program vs eager bit-equal: captured on "
                  f"the fitted likelihood {same['fitted']}, on the placeholder {same['placeholder']}; launches counted "
                  f"through replays: {launches}; in turns (eager {PROGRAM_EAGER_STEPS}, program {PROGRAM_TIMED_STEPS}, "
                  f"program, eager steps) ms/step " + " / ".join(f"{x:.4f}" for x in turns)
                  + f"; eager {eager_ms:.4f} ms/step = {points * 1e3 / eager_ms:.1f} "
                  f"{'point-' if n_points else ''}steps/s, program {program_ms:.4f} ms/step = "
                  f"{points * 1e3 / program_ms:.1f} {'point-' if n_points else ''}steps/s ({eager_ms / program_ms:.2f}x); "
                  f"step FLOPs {points * step_flops / 1e6:.1f} MFLOP -> {tflops:.3f} TFLOP/s, "
                  f"{tflops / peak_tflops:.2%} of the FP32 peak {peak_tflops:.0f} TFLOP/s; device busy (profiler, "
                  f"{PROGRAM_PROFILED_STEPS} steps): {busy_text}; capture {capture_s:.3f} s; "
                  f"peak bytes above the {base_bytes / 1e6:.1f} MB held before (one program with its buffers for "
                  f"{PROGRAM_TIMED_STEPS}-step chunks, its graph's pool, a chunk's draws and outputs) "
                  f"{peak_bytes / 1e6:.1f} MB; card: {smi}",
                  flush=True)
            for k, (_, kernels_text) in profiled.items():
                if kernels_text:
                    print(f"programs {name}, {k}: device time by kernel over {PROGRAM_PROFILED_STEPS} profiled steps, "
                          f"ms/step (launches/step): {kernels_text}", flush=True)
            for origin, eq in same.items():
                check(all(eq.values()), f"programs {name}: captured on the {origin} likelihood, not bit-equal to the "
                                        f"eager loop: {eq}")
            results[name] = {"eager_ms_per_step": eager_ms, "program_ms_per_step": program_ms, "turns_ms": turns,
                             "capture_s": capture_s, "peak_bytes": peak_bytes, "step_mflop": points * step_flops / 1e6,
                             "device_busy_ms_per_step": busy}
            del programs, eager, out, rands
    return results


def wall_seconds(fn) -> float:
    """Host-clock seconds of ``fn()``, the device drained before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def same_posterior(a, b) -> dict[str, bool]:
    """Bit equality of two fitted GPPosteriors."""
    return {"log_length_scale": bool(torch.equal(a.params.log_length_scale, b.params.log_length_scale)),
            "log_noise": bool(torch.equal(a.params.log_noise, b.params.log_noise)),
            "lml": bool(torch.equal(a.lml, b.lml)), "alpha": bool(torch.equal(a.alpha, b.alpha)),
            "Kinv": bool(torch.equal(a.Kinv, b.Kinv))}


def phase_fit_programs(device, kernels, data: dict) -> dict:
    """The fit programs against the eager loop at production width (195
    design points, d = 6, 41 PCs x 51 restarts, 60 iterations: stage batches
    2,091 and 123), from the same restart points: bit equality for three
    schedules, K3's launches by batch through the replays, seconds per fit in
    turns, the profiler's device time and kernels per iteration of each
    stage, capture seconds and peak bytes; then one group's 5-fold CV eager
    and through the programs. Returns the measured numbers."""
    import dataclasses
    import functools

    from bayesian_inference_tpu_torch.models import cv, gp_fit
    from bayesian_inference_tpu_torch.models.emulator import _prepare_group
    from bayesian_inference_tpu_torch.ops.gram import pairwise_sqdiff

    observables, emu = data["observables"], data["emu"]
    groups = emu.emulation_groups_config
    preps = {name: _prepare_group(g, N_OPT_ITERS, observables) for name, g in groups.items()}
    first = next(iter(preps.values()))
    spec = first["spec"]
    dt = torch.float32
    X = torch.as_tensor(first["design"], dtype=dt, device=device)
    Y = torch.as_tensor(np.concatenate([p["Y_pca_truncated"] for p in preps.values()], axis=1), dtype=dt,
                        device=device)
    (N, d), k, P, R = X.shape, Y.shape[1], spec.theta0.shape[0], spec.n_restarts + 1
    lo, hi = (torch.as_tensor(a, dtype=dt, device=device) for a in (spec.log_lo, spec.log_hi))
    rand_logs = lo + (hi - lo) * torch.rand((k, spec.n_restarts, P), dtype=dt, device=device,
                                            generator=torch.Generator(device=device).manual_seed(11))
    smi = nvidia_smi_line()
    check((k, R, spec.n_iters) == (N_PCS, N_RESTARTS + 1, N_OPT_ITERS) and gp_fit.halving_rungs(spec) == ((15, 3),),
          f"fit programs: not the production fit: {k} PCs x {R} restarts, rungs {gp_fit.halving_rungs(spec)}")

    def fit(s, eager):
        return gp_fit.fit_gps(s, X, Y, rand_logs=rand_logs, eager=eager)

    # Bit equality, K3 by batch, capture seconds and peak bytes, per schedule.
    schedules = {"default": spec, f"trial_steps={FIT_TRIAL_STEPS}": dataclasses.replace(spec, trial_steps=FIT_TRIAL_STEPS),
                 f"halving_schedule={FIT_TWO_RUNGS}": dataclasses.replace(spec, halving_schedule=FIT_TWO_RUNGS)}
    results = {"card": smi, "schedules": {}}
    for name, s in schedules.items():
        K, rungs = len(s.trial_steps), gp_fit.halving_rungs(s)
        stages = [(R, rungs[0][0])] + [(keep, it) for (_, keep), (it, _) in zip(rungs, rungs[1:])]
        stages.append((rungs[-1][1], s.n_iters - sum(it for it, _ in rungs)))
        # per stage: one eager seed evaluation at its batch, then its iterations at K times it
        expect, expect_warm = {k: K3_BLOCKS}, {k: K3_BLOCKS}
        for pool, iters in stages:
            for counts_, warm in ((expect, 0), (expect_warm, gp_fit.WARMUP_ITERATIONS)):
                counts_[k * pool] = counts_.get(k * pool, 0) + K3_BLOCKS
                counts_[K * k * pool] = counts_.get(K * k * pool, 0) + K3_BLOCKS * (iters + warm)
        gp_fit.clear_fit_programs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # so that the bytes reserved below are this fit's
        base_bytes, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        built = gp_fit.fit_program_stats()["built"]
        reset(kernels)
        with count_k3_batches() as first_batches:
            t_first = wall_seconds(lambda: fit(s, False))
        peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
        reserved_bytes = torch.cuda.memory_reserved() - base_reserved
        n_built = gp_fit.fit_program_stats()["built"] - built
        capture_s = {p.B: p.compile_seconds for p in gp_fit._PROGRAMS.values()}
        check(all(p.captured for p in gp_fit._PROGRAMS.values()), "fit programs: a program is not a captured graph")
        reset(kernels)
        with count_k3_batches() as batches:
            program = fit(s, False)
            torch.cuda.synchronize()
        launches = counts(kernels)
        eager = fit(s, True)
        same = same_posterior(program, eager)
        print(f"fit programs [{name}]: {k} PCs x {R} restarts x {s.n_iters} iterations, stages (pool, iterations) "
              f"{stages}, {K} trial step(s); program vs eager fit bit-equal: {same}; K3 launches by batch through "
              f"the replays {dict(sorted(batches.items(), reverse=True))} (expected {expect}), with the programs' "
              f"{gp_fit.WARMUP_ITERATIONS} warm-up iterations in the first fit "
              f"{dict(sorted(first_batches.items(), reverse=True))} (expected {expect_warm}); {n_built} graphs "
              f"captured, capture seconds by batch {capture_s}; first fit (builds included) {t_first:.3f} s; peak "
              f"bytes above the {base_bytes / 1e6:.1f} MB held before {peak_bytes / 1e6:.1f} MB allocated, "
              f"{reserved_bytes / 1e6:.1f} MB more reserved after it (the graphs' pools and the cached warm-up "
              f"blocks); card: {smi}", flush=True)
        check(all(same.values()), f"fit programs [{name}]: not bit-equal to the eager fit: {same}")
        check(bool(torch.isfinite(program.lml).all()), f"fit programs [{name}]: non-finite LML")
        check(dict(batches) == expect and dict(first_batches) == expect_warm
              and sum(batches.values()) == launches["diag_chol_inv"],
              f"fit programs [{name}]: K3 launches by batch {dict(batches)} / {dict(first_batches)}, expected "
              f"{expect} / {expect_warm}")
        check(n_built == len({K * k * pool for pool, _ in stages}), f"fit programs [{name}]: {n_built} graphs captured")
        results["schedules"][name] = {"bit_equal": same, "k3_by_batch": dict(batches), "capture_s": capture_s,
                                      "first_fit_s": t_first, "peak_bytes": peak_bytes,
                                      "reserved_bytes": reserved_bytes}
        del program, eager

    # The default schedule timed in turns (its programs built once more, before the turns).
    gp_fit.clear_fit_programs()
    fit(spec, False)
    turns = [wall_seconds(lambda: fit(spec, e)) for e in (True, False, False, True)]
    eager_s, program_s = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    busy = {}
    for how, e in (("eager", True), ("program", False)):
        rows = profiled_device_rows(lambda: fit(spec, e))
        busy[how] = sum(us for us, _, _ in rows) / 1e6
    wall = {"eager": eager_s, "program": program_s}
    print("fit programs, fit_gps in turns (eager, program, program, eager) s: " + " / ".join(f"{t:.4f}" for t in turns)
          + f"; eager {eager_s:.4f} s, program {program_s:.4f} s ({eager_s / program_s:.2f}x); device busy per fit "
          "(profiler): " + ", ".join(f"{h} {b:.4f} s = {b / wall[h]:.1%} of its wall time" for h, b in busy.items())
          + f"; card: {smi}", flush=True)
    results["fit_s"] = {"turns": turns, "eager": eager_s, "program": program_s, "device_busy_s": busy}

    # Each stage's iteration alone: n iterations less 0 iterations (the seed
    # evaluation and the loads), eager and replayed, under the profiler.
    D2 = pairwise_sqdiff(X)
    obj = gp_fit._Objective(spec.cfg, spec.alpha_jitter, D2, lo, hi)
    steps = torch.ones(1, dtype=dt, device=device)
    results["iteration"] = {}
    for pool in (R, 3):
        B = k * pool
        u0 = gp_fit._to_u(lo, hi, torch.cat([lo + (hi - lo) * 0.5 + torch.zeros((k, 1, P), dtype=dt, device=device),
                                             rand_logs], dim=1)[:, :pool]).reshape(B, P)
        Yw = Y.T.repeat_interleave(pool, 0)
        program = gp_fit.fit_program(spec.cfg, spec.alpha_jitter, spec.trial_steps, B, N, d, P, dt, device)
        runs = {"eager": lambda n: gp_fit._optimize(u0, Yw, obj, steps, n),
                "program": lambda n: program.run(u0, Yw, D2, lo, hi, n)}
        check(all(torch.equal(a, b) for a, b in zip(runs["eager"](FIT_PROFILED_ITERS),
                                                    runs["program"](FIT_PROFILED_ITERS))),
              f"fit programs: {FIT_PROFILED_ITERS} iterations at batch {B} differ from the eager loop")
        for how, run in runs.items():
            rows0 = profiled_device_rows(lambda: run(0))
            rows = profiled_device_rows(lambda: run(FIT_PROFILED_ITERS))
            wall_ms = 1e3 * (wall_seconds(lambda: run(FIT_PROFILED_ITERS)) - wall_seconds(lambda: run(0)))
            n = FIT_PROFILED_ITERS
            busy_ms = (sum(us for us, _, _ in rows) - sum(us for us, _, _ in rows0)) / 1e3 / n
            n_kernels = (sum(c for _, c, _ in rows) - sum(c for _, c, _ in rows0)) / n
            k3 = [(us, c) for us, c, key in rows if "diag_chol_inv" in key]
            k3_us = sum(us for us, _ in k3) / max(1, sum(c for _, c in k3))
            top = ", ".join(f"{key[:48]} {us / 1e3 / (n + 1):.4f} ({c / (n + 1):.1f})" for us, c, key in rows[:8])
            print(f"fit programs, one iteration at batch {B} ({how}): wall {wall_ms / n:.4f} ms, device busy "
                  f"{busy_ms:.4f} ms = {busy_ms / (wall_ms / n):.1%}, {n_kernels:.1f} kernels and copies per "
                  f"iteration, K3 {k3_us:.2f} us per launch; device time by kernel over 1 + {n} evaluations, "
                  f"ms/evaluation (launches/evaluation): {top}", flush=True)
            results["iteration"][f"B={B} {how}"] = {"wall_ms": wall_ms / n, "device_busy_ms": busy_ms,
                                                   "kernels": n_kernels, "k3_us_per_launch": k3_us}
        del program

    # One group's 5-fold CV: eager, through the programs (two graphs for the
    # five folds, all of one shape), and again with the programs cached.
    group = groups[FIT_CV_GROUP]
    run_cv = functools.partial(cv.cross_validate_group, group, k=STEER_CV_K, seed=0, n_opt_iters=N_OPT_ITERS,
                               device=device, observables=observables)
    gp_fit.clear_fit_programs()
    built = gp_fit.fit_program_stats()["built"]
    arts, cv_s = {}, {}
    inner = gp_fit.fit_gps
    for how in ("eager", "program, graphs built", "program", "eager again"):
        gp_fit.fit_gps = functools.partial(inner, eager=True) if how.startswith("eager") else inner
        try:
            cv_s[how] = wall_seconds(lambda: arts.__setitem__(how, run_cv()))
        finally:
            gp_fit.fit_gps = inner
    n_graphs = gp_fit.fit_program_stats()["built"] - built
    keys = ("predictions", "predictive_std", "normalized_residuals", "lml_per_fold")
    same = {key: all(np.array_equal(arts[how][key], arts["eager"][key]) for how in arts) for key in keys}
    print(f"fit programs, {STEER_CV_K}-fold CV of {FIT_CV_GROUP} ({group.n_pc} PCs, {N - N // STEER_CV_K} training "
          f"points per fold): " + ", ".join(f"{how} {t:.3f} s" for how, t in cv_s.items())
          + f"; fold results bit-equal: {same}; {n_graphs} graphs captured for the {STEER_CV_K} folds; card: {smi}",
          flush=True)
    check(all(same.values()), f"fit programs: CV through the programs differs from the eager CV: {same}")
    check(all(np.isfinite(arts["program"][key]).all() for key in keys), "fit programs: non-finite CV artifact")
    check(n_graphs == 2, f"fit programs: {n_graphs} graphs captured for one CV group, expected 2")
    results["cv_s"] = cv_s
    gp_fit.clear_fit_programs()
    return results


def flops_text(step_flops: float, steps_per_s: float, device) -> str:
    """A sampler step's analytic FLOPs (utils/flops.py) and, at
    ``steps_per_s``, the rate reached and its share of the card's FP32 peak."""
    from bayesian_inference_tpu_torch.utils import flops

    peak = flops.device_peak_tflops(device)
    tflops = step_flops * steps_per_s / 1e12
    return (f"step FLOPs {step_flops / 1e6:.1f} MFLOP, at {steps_per_s:.1f} steps/s {tflops:.3f} TFLOP/s = "
            f"{tflops / peak:.2%} of the FP32 peak {peak:.0f} TFLOP/s")


def lml_float64(cfg, params, X, Y, alpha_jitter) -> torch.Tensor:
    """The LML of each GP (targets ``Y`` (k, N)) at ``params``, recomputed in
    float64 with the library Cholesky: (k,)."""
    from bayesian_inference_tpu_torch.models.gp import _LOG_2PI
    from bayesian_inference_tpu_torch.ops.gram import KernelParams, train_gram

    params = KernelParams(*(getattr(params, f).double() for f in ("log_length_scale", "log_noise", "log_constant")))
    Y = Y.double()
    Lc = torch.linalg.cholesky(train_gram(cfg, params, X.double(), alpha_jitter))
    a = torch.cholesky_solve(Y[..., None], Lc)[..., 0]
    return (-0.5 * (Y * a).sum(-1) - torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * Y.shape[-1] * _LOG_2PI)


def phase_slice(device, kernels, data: dict, n_opt_iters: int = N_OPT_ITERS, n_check: int = 64) -> tuple[dict, dict]:
    """The main path at production width: fit -> likelihood -> sampler.
    Returns (kernel launches, what later phases reuse: emulators, observables,
    configs and the production chain)."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu_torch.mcmc.runner import run_mcmc
    from bayesian_inference_tpu_torch.models import gp_fit
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators, posterior_from_artifact
    from bayesian_inference_tpu_torch.ops.fused_mvn import fused_block_mvn_buckets_plain
    from bayesian_inference_tpu_torch.utils import flops

    observables, emu, mcmc = data["observables"], data["emu"], data["mcmc"]
    n_restarts, n_walkers, n_burn, n_steps = N_RESTARTS, N_WALKERS, N_BURN, N_STEPS

    gp_fit.clear_fit_programs()  # the fit builds its two programs: their warm-up iterations are counted below
    k3_expected = k3_fit_launches_with_warmup()
    reset(kernels)
    with count_evaluations() as evals, count_k3_batches() as k3_batches:
        t = time.perf_counter()
        artifacts = fit_emulators(emu, seed=0, n_opt_iters=n_opt_iters, device=device,
                                  observables=observables, write=False)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t
        out = run_mcmc(mcmc, seed=0, device=device, emulation_results=artifacts, observables=observables,
                       write=False)
    launches = counts(kernels)

    n_pc = sum(g["n_pc"] for g in PRODUCTION_GROUPS.values())
    timings = {"fit": t_fit, **out["timings"]}
    logp = out["log_prob"]
    af = float(np.mean(out["acceptance_fraction"]))
    print("slice phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f"; {n_pc} PCs x {n_restarts + 1} restarts x {n_opt_iters} iterations; {n_walkers} walkers x "
          f"({n_burn} burn-in + {n_steps}) steps, {n_steps / timings['production']:.1f} production steps/s",
          flush=True)
    print(f"slice kernel launches: {launches} for {evals['block']} block-mode likelihood evaluations; production "
          f"log-probs finite: {bool(np.isfinite(logp).all())}, "
          f"shape {logp.shape}; mean acceptance {af:.4f} (must lie in {ACCEPTANCE_RANGE})", flush=True)
    print(f"slice K3 launches by batch size: {dict(sorted(k3_batches.items(), reverse=True))} "
          f"(expected {k3_expected}: {K3_FIT_LAUNCHES} of the fit and the warm-up iterations of its two programs, "
          f"counted through the replays)", flush=True)
    check(dict(k3_batches) == k3_expected and sum(k3_batches.values()) == launches["diag_chol_inv"],
          f"slice: K3 launches by batch size {dict(k3_batches)}, expected {k3_expected}")
    check(n_pc == sum(a["n_pc"] for a in artifacts.values()), "slice: fitted PC count")
    check(launches["diag_chol_inv"] > 0 and launches["fused_block_mvn"] > 0,
          f"slice: a kernel of the path never launched: {launches}")
    check_k1_per_evaluation(launches, evals, "slice")
    check(logp.shape == (n_steps, n_walkers) and bool(np.isfinite(logp).all()), "slice: non-finite log-probs")
    check(ACCEPTANCE_RANGE[0] < af < ACCEPTANCE_RANGE[1], f"slice: mean acceptance {af:.4f} out of range")

    # The fit's LMLs against a float64 recompute at the fitted hyperparameters.
    lml_delta = 0.0
    for art in artifacts.values():
        cfg, post = posterior_from_artifact(art, device=device, dtype=torch.float64)
        Y = torch.tensor(art["PCA"]["Y_pca_truncated"].T, dtype=torch.float64, device=device)
        lml64 = lml_float64(cfg, post.params, post.X, Y, art["emulators"]["alpha_jitter"])
        lml_delta = max(lml_delta, float((post.lml - lml64).abs().max()))
    check(lml_delta <= LML_TOL_NAT, f"slice: fitted LML off its float64 recompute by {lml_delta:.4g} nat")

    # Log-posterior through the kernels (f32) against the plain path in
    # float64, both on the card, at posterior points from the production chain.
    experimental = obs_io.data_array_from_h5(
        mcmc.output_dir, mcmc.observables_filename, observable_filter=emu.observable_filter,
        observables=observables,
    )
    box = mcmc.parameterization_spec()
    likes = {
        dt: build_likelihood(emu, artifacts, experimental, box["min"], box["max"], device=device, dtype=dt,
                             observables=observables)
        for dt in (torch.float32, torch.float64)
    }
    theta = torch.tensor(out["chain"][-1][:n_check], dtype=torch.float64, device=device)
    lp = likes[torch.float32].log_posterior(theta.float()).double()
    like64 = likes[torch.float64]
    z, v = like64.gp_eval(theta)
    lp64 = fused_block_mvn_buckets_plain(like64.U, like64.D, like64.d0, z, v)
    lp_rel = float((lp - lp64).abs().max() / lp64.abs().max())
    print(f"slice check: fitted LML vs float64 recompute max |delta| {lml_delta:.4g} nat (tol {LML_TOL_NAT}); "
          f"log_posterior at "
          f"{n_check} posterior points, f32 kernels vs float64 plain: max err / max|lp| {lp_rel:.3g} "
          f"(tol {LOGP_TOL}); " + flops_text(flops.mcmc_step_flops(likes[torch.float32], n_walkers),
                                             n_steps / timings["production"], device), flush=True)
    check(bool(torch.isfinite(lp).all()), "slice: non-finite log_posterior at posterior points")
    check(lp_rel <= LOGP_TOL, f"slice: log_posterior differs from the float64 plain path by {lp_rel:.3g}")
    reuse = {"emu": emu, "artifacts": artifacts, "observables": observables, "experimental": experimental,
             "box": box, "chain": out["chain"]}
    return launches, reuse


def phase_lowrank(device, kernels, s: dict, n_check: int = 64) -> dict:
    """One lowrank (Woodbury) analysis on the slice's fitted emulators: the
    f32 kernel path against the float64 plain path (on the host), then
    ``run_mcmc(mode="lowrank")`` at 100 walkers."""
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu_torch.mcmc.runner import run_mcmc
    from bayesian_inference_tpu_torch.utils import flops

    box = s["box"]
    t = time.perf_counter()
    like = build_likelihood(s["emu"], s["artifacts"], s["experimental"], box["min"], box["max"], mode="lowrank",
                            device=device, dtype=torch.float32, observables=s["observables"])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    like64 = build_likelihood(s["emu"], s["artifacts"], s["experimental"], box["min"], box["max"],
                              mode="lowrank", device="cpu", dtype=torch.float64, observables=s["observables"])
    theta = torch.tensor(s["chain"][-1][:n_check], dtype=torch.float64)
    lp = like.log_posterior(theta.to(device, torch.float32)).double().cpu()
    lp64 = like64.log_posterior(theta)
    lp_rel = float((lp - lp64).abs().max() / lp64.abs().max())
    F, k = like.wb.U.shape
    print(f"lowrank check: Woodbury build (F={F}, k={k}) {t_build:.3f} s; log_posterior at {n_check} posterior "
          f"points, f32 kernels vs float64 plain: max err / max|lp| {lp_rel:.3g} (tol {LOGP_TOL}); "
          f"c0 {float(like.wb.c0):.4g}, |lp| up to {float(lp64.abs().max()):.4g}", flush=True)
    check(bool(torch.isfinite(lp).all()), "lowrank: non-finite log_posterior at posterior points")
    check(lp_rel <= LOGP_TOL, f"lowrank: log_posterior differs from the float64 plain path by {lp_rel:.3g}")

    config = mcmc_config(N_STEPS)
    reset(kernels)
    with count_evaluations() as evals:
        out = run_mcmc(config, seed=0, device=device, emulation_results=s["artifacts"],
                       observables=s["observables"], write=False, mode="lowrank")
    launches = counts(kernels)
    logp = out["log_prob"]
    af = float(np.mean(out["acceptance_fraction"]))
    timings = out["timings"]
    print("lowrank run_mcmc phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f"; {N_WALKERS} walkers x ({N_BURN} burn-in + {N_STEPS}) steps, "
          f"{N_STEPS / timings['production']:.1f} production steps/s; "
          + flops_text(flops.mcmc_step_flops(like, N_WALKERS), N_STEPS / timings["production"], device)
          + f"; kernel launches {launches}; "
          f"log-probs finite: {bool(np.isfinite(logp).all())}; NaN log-probs {int(np.isnan(logp).sum())}; "
          f"mean acceptance {af:.4f}; split-R-hat max {float(out['split_rhat'].max()):.4f}", flush=True)
    check(launches["block_mvn"] > 0, f"lowrank: the tiny-MVN kernel never launched: {launches}")
    check(launches["block_mvn"] == evals["lowrank"] and evals["block"] == 0,
          f"lowrank: {launches} for {evals} likelihood evaluations")
    check_k1_per_evaluation(launches, evals, "lowrank")
    check(logp.shape == (N_STEPS, N_WALKERS) and bool(np.isfinite(logp).all()), "lowrank: non-finite log-probs")
    check(ACCEPTANCE_RANGE[0] < af < ACCEPTANCE_RANGE[1], f"lowrank: mean acceptance {af:.4f} out of range")
    return launches


def phase_closure(device, kernels, s: dict, mode: str, n_check: int = 100) -> dict:
    """The closure batch over the 30 validation points in ``mode``: per-point
    checks, device statistics against the host ones, and each point's
    log-posterior against a likelihood built for that point alone."""
    from bayesian_inference_tpu_torch.mcmc import stats
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu_torch.mcmc.runner import run_closure_batch

    n_steps = CLOSURE_STEPS[mode]
    config = mcmc_config(n_steps)
    indices = list(range(s["observables"]["Design_validation"].shape[0]))
    P = len(indices)
    reset(kernels)
    with count_evaluations() as evals:
        out = run_closure_batch(config, indices, seed=0, device=device, mode=mode,
                                emulation_results=s["artifacts"], observables=s["observables"], write=False)
    launches = counts(kernels)
    timings = out[indices[0]]["timings"]

    chain = np.stack([out[i]["chain"] for i in indices], axis=1)   # (n, P, W, d)
    logp = np.stack([out[i]["log_prob"] for i in indices], axis=1)
    af = np.array([float(np.mean(out[i]["acceptance_fraction"])) for i in indices])
    # The runner's device statistics (R-hat as returned; tau recomputed by the
    # same device function, since the runner keeps tau only where the chain
    # is longer than 50 tau) against the host estimators on the downloaded chains.
    tau_host, _ = stats.integrated_time_batched(chain)
    powers, nfft, _ = stats.device_closure_stats(torch.tensor(chain, device=device))
    tau_dev = np.array([stats.integrated_time_from_power(powers[p], nfft, n_steps, out_dtype=chain.dtype)[0]
                        for p in range(P)])
    for p, i in enumerate(indices):
        if out[i]["autocorrelation_time"] is not None:
            check(np.allclose(out[i]["autocorrelation_time"], tau_dev[p], rtol=1e-6), f"closure {mode}: point {i} tau")
    rhat_dev = np.array([out[i]["split_rhat"] for i in indices])
    rhat_host = np.array([stats.split_rhat(chain[:, p]) for p in range(P)])
    tau_err = float(np.max(np.abs(tau_dev - tau_host) / tau_host))
    rhat_err = float(np.max(np.abs(rhat_dev - rhat_host)))

    box = s["box"]
    lp_err = 0.0
    for p, i in enumerate(indices):
        like_i = build_likelihood(s["emu"], s["artifacts"], out[i]["experimental_pseudodata"], box["min"],
                                  box["max"], mode=mode, device=device, observables=s["observables"])
        theta = torch.tensor(chain[-1, p, :n_check], device=device, dtype=like_i.theta_min.dtype)
        lp_single = like_i.log_posterior(theta).double().cpu().numpy()
        ref = logp[-1, p, :n_check].astype(np.float64)
        lp_err = max(lp_err, float(np.max(np.abs(ref - lp_single)) / np.max(np.abs(lp_single))))

    rate = P * n_steps / timings["production"]
    print(f"closure {mode}: {P} points x {N_WALKERS} walkers x ({N_BURN} burn-in + {n_steps}) steps; phases (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f"; {rate:.1f} production point-steps/s; kernel launches {launches} for {evals[mode]} likelihood "
          f"evaluations; log-probs finite: "
          f"{bool(np.isfinite(logp).all())}; acceptance per point {af.min():.4f}..{af.max():.4f}; device vs host "
          f"tau max rel err {tau_err:.3g} (tol {TAU_RTOL}), split-R-hat max abs err {rhat_err:.3g} "
          f"(tol {RHAT_ATOL}); batched vs per-point likelihood at {n_check} final positions per point: "
          f"max err / max|lp| {lp_err:.3g} (tol {CLOSURE_LOGP_TOL})", flush=True)
    kernel = "block_mvn" if mode == "lowrank" else "fused_block_mvn"
    check(launches[kernel] > 0, f"closure {mode}: kernel {kernel} never launched: {launches}")
    check(launches[kernel] == evals[mode], f"closure {mode}: {launches} for {evals} likelihood evaluations")
    check_k1_per_evaluation(launches, evals, f"closure {mode}")
    check(chain.shape == (n_steps, P, N_WALKERS, 6) and bool(np.isfinite(logp).all()),
          f"closure {mode}: non-finite or misshapen chains")
    check(bool(((ACCEPTANCE_RANGE[0] < af) & (af < ACCEPTANCE_RANGE[1])).all()),
          f"closure {mode}: acceptance out of range at some point: {af.min():.4f}..{af.max():.4f}")
    check(tau_err <= TAU_RTOL, f"closure {mode}: device tau off the host estimate by {tau_err:.3g}")
    check(rhat_err <= RHAT_ATOL, f"closure {mode}: device split-R-hat off the host one by {rhat_err:.3g}")
    check(lp_err <= CLOSURE_LOGP_TOL, f"closure {mode}: batched log-posterior off the per-point one by {lp_err:.3g}")
    return launches


def peak_bytes_of(fn) -> tuple[int, object]:
    """(peak allocated bytes above what was held before, result) of ``fn()``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, result


def validation_offsets(s: dict, like, mode: str, device, pseudodata=None):
    """``like`` with one residual offset per validation point (30), from
    ``pseudodata`` (per-point dicts, as a closure batch returns them) or from
    pseudodata drawn here."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc import likelihood as lik

    emu, artifacts, observables = s["emu"], s["artifacts"], s["observables"]
    P = observables["Design_validation"].shape[0]
    if pseudodata is None:
        pseudodata = [obs_io.data_array_from_h5("", "", pseudodata_index=i, rng=np.random.default_rng(i),
                                                observable_filter=emu.observable_filter, observables=observables)
                      for i in range(P)]
    y_batch = np.stack([p["y"] for p in pseudodata])
    dt = like.theta_min.dtype
    if mode == "block":
        d0 = tuple(torch.tensor(d, dtype=dt, device=device)
                   for d in lik.pad_residual_offsets(emu, artifacts, y_batch, observables))
    else:
        d0 = torch.tensor(lik.residual_offsets_flat(emu, artifacts, y_batch, observables), dtype=dt, device=device)
    return like.with_d0(d0)


def phase_sampler_options(device, kernels, s: dict) -> dict:
    """The stretch move's options through the sampler programs at production
    width, on the slice's fitted emulators: for block and lowrank mode, one
    analysis and the 30-point batch, program against eager loop over 200
    steps with ``thin=4, a=1.5, randomize_split=False`` and with
    ``store_chain=False``, bit for bit; the kernel's launches through the
    replays (two evaluations per sub-step); ms per step thinned and
    unthinned in turns; peak bytes with and without the chain stored."""
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms

    box = s["box"]
    ndim, W = len(box["min"]), N_WALKERS
    kernel_of = {"block": "fused_block_mvn", "lowrank": "block_mvn"}
    cases = {"thinned": OPTION_THINNED, "no chain": {"store_chain": False}}
    smi = nvidia_smi_line()
    results, total = {}, {name: 0 for name in kernels}
    for mode in ("block", "lowrank"):
        like1 = build_likelihood(s["emu"], s["artifacts"], s["experimental"], box["min"], box["max"], mode=mode,
                                 device=device, observables=s["observables"])
        dt = like1.theta_min.dtype
        like_p = validation_offsets(s, like1, mode, device)
        P = s["observables"]["Design_validation"].shape[0]
        for n_points, like, timed_steps in ((None, like1, PROGRAM_TIMED_STEPS), (P, like_p, OPTION_BATCH_TIMED_STEPS)):
            name = f"{mode}" + (f" batch P={P}" if n_points else "")
            lead = (n_points,) if n_points else ()
            gens = [torch.Generator(device=device).manual_seed(300 + i) for i in range(n_points or 1)]
            draw_from = gens if n_points else gens[0]
            x0 = like.theta_min + (like.theta_max - like.theta_min) * torch.rand(
                (*lead, W, ndim), generator=gens[0], dtype=dt, device=device)
            fn = like.log_posterior
            eager_chunk = stretch.run_chunk_batched if n_points else stretch.run_chunk
            pregen = stretch.pregen_rands_batched if n_points else stretch.pregen_rands
            state0 = stretch.init_state(fn, x0)
            same, launched = {}, {}
            for case, options in cases.items():
                rands = pregen(PROGRAM_CHECK_STEPS, W, draw_from, dt, options.get("randomize_split", True))
                eager = eager_chunk(state0, fn, PROGRAM_CHECK_STEPS, rands=rands, **options)
                programs = SamplerPrograms(like, W, ndim, [PROGRAM_CHECK_STEPS], n_points=n_points, **options)
                programs.compile()
                check(programs.captured, f"options {name} ({case}): the program is not a captured graph")
                reset(kernels)
                out = programs.chunk(programs.init(like, x0), like, PROGRAM_CHECK_STEPS, rands=rands)
                torch.cuda.synchronize()
                launches = counts(kernels)
                for k, v in launches.items():
                    total[k] += v
                if options.get("store_chain", True):
                    same[case] = same_chunk(out, eager)
                else:
                    same[case] = same_chunk((out[0], (out[1],)), (eager[0], (eager[1],)))
                    same[case]["acceptance"] = same[case].pop("chain")  # the one output is the acceptance trace
                    check(isinstance(out[1], torch.Tensor) and len(programs._outputs) == 1,
                          f"options {name} ({case}): a chain buffer exists")
                rows = PROGRAM_CHECK_STEPS // options.get("thin", 1)
                check(out[1][-1].shape[0] == rows if options.get("store_chain", True) else out[1].shape[0] == rows,
                      f"options {name} ({case}): output rows")
                # init is one eager evaluation; every sub-step two through the replays
                expect = 1 + 2 * PROGRAM_CHECK_STEPS
                check(launches[kernel_of[mode]] == expect and sum(launches.values()) == expect,
                      f"options {name} ({case}): {launches} launches, expected {expect} of {kernel_of[mode]}")
                check(all(same[case].values()), f"options {name} ({case}): not bit-equal to the eager loop: {same[case]}")
                launched[case] = launches[kernel_of[mode]]
                del programs, out, eager, rands

            # ms per step, thinned and unthinned programs in turns, and the
            # peak bytes of a chunk with and without the chain stored.
            built = {}
            for label, options in (("unthinned", {}), ("thinned", {"thin": OPTION_THINNED["thin"]}),
                                   ("no chain", {"store_chain": False})):
                def build(options=options):
                    programs = SamplerPrograms(like, W, ndim, [timed_steps], n_points=n_points, **options)
                    programs.compile()
                    programs.chunk(state0, like, timed_steps, generator=draw_from)
                    return programs

                built[label] = peak_bytes_of(build)

            def run(label):
                return wall_ms_per_step(lambda: built[label][1].chunk(state0, like, timed_steps, generator=draw_from),
                                        timed_steps)

            turns = [run("unthinned"), run("thinned"), run("thinned"), run("unthinned")]
            plain_ms, thin_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            peaks = {label: b[0] for label, b in built.items()}
            print(f"options {name}: {PROGRAM_CHECK_STEPS} steps program vs eager bit-equal: {OPTION_THINNED} {same['thinned']}; "
                  f"store_chain=False {same['no chain']}; {kernel_of[mode]} launches through the replays {launched} "
                  f"(1 + 2 per sub-step); in turns (unthinned, thin {OPTION_THINNED['thin']}, thin, unthinned; "
                  f"{timed_steps} steps each) ms/step " + " / ".join(f"{x:.4f}" for x in turns)
                  + f": unthinned {plain_ms:.4f}, thinned {thin_ms:.4f} ({thin_ms / plain_ms:.3f}x); peak bytes of a "
                  f"build and one {timed_steps}-step chunk: " + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in peaks.items())
                  + f"; card: {smi}", flush=True)
            check(peaks["no chain"] < peaks["unthinned"], f"options {name}: store_chain=False did not lower the peak: {peaks}")
            results[name] = {"unthinned_ms_per_step": plain_ms, "thinned_ms_per_step": thin_ms, "turns_ms": turns,
                             "peak_bytes": peaks}
            del built
    check(total["fused_block_mvn"] > 0 and total["block_mvn"] > 0, f"options: a kernel never launched: {total}")
    return total, results


def phase_closure_slabs(device, kernels, s: dict) -> dict:
    """The memory-bounded closure batch (block mode, 30 points): production
    in chunks of ``dispatch_chunk`` (four chunks) against the one-chunk run
    under the same injected draws, neither returning nor writing chains: the
    final state bit for bit, tau and R-hat within the device-against-host
    tolerances, and the peak allocated bytes of both, the slab run's lower."""
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.runner import run_closure_batch

    config = mcmc_config(SLAB_STEPS)
    indices = list(range(s["observables"]["Design_validation"].shape[0]))
    P, W, box = len(indices), N_WALKERS, s["box"]
    ndim = len(box["min"])
    gens = [torch.Generator(device=device).manual_seed(500 + i) for i in indices]

    def draws(n):
        return {k: v.cpu().numpy() for k, v in stretch.pregen_rands_batched(n, W, gens, torch.float32).items()}

    lo, hi = np.asarray(box["min"], np.float32), np.asarray(box["max"], np.float32)
    x0 = lo + (hi - lo) * np.random.default_rng(5).uniform(0.05, 0.95, (P, W, ndim)).astype(np.float32)
    injected = {"x0": x0, "burn": [draws(N_BURN // 2), draws(N_BURN - N_BURN // 2)], "production": draws(SLAB_STEPS)}
    kw = dict(seed=0, device=device, mode="block", emulation_results=s["artifacts"], observables=s["observables"],
              write=False, return_chains=False, draws=injected)
    asked = []
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms

    inner = SamplerPrograms.chunk

    def recording(self, state, like, n_steps, *args, **kwargs):
        asked.append(n_steps)
        return inner(self, state, like, n_steps, *args, **kwargs)

    runs, peaks, launches = {}, {}, {}
    for label, chunk in (("one chunk", None), ("slabs", SLAB_STEPS // SLAB_CHUNKS)):
        torch.cuda.empty_cache()
        reset(kernels)
        SamplerPrograms.chunk = recording
        try:
            with count_evaluations() as evals:
                peaks[label], runs[label] = peak_bytes_of(lambda: run_closure_batch(config, indices, dispatch_chunk=chunk, **kw))
        finally:
            SamplerPrograms.chunk = inner
        launches[label] = counts(kernels)
        check_k1_per_evaluation(launches[label], evals, f"closure slabs ({label})")
        check(launches[label]["fused_block_mvn"] > 0, f"closure slabs ({label}): K1 never launched")
        production = asked[2:]
        del asked[:]
        check(production == ([SLAB_STEPS] if chunk is None else [chunk] * SLAB_CHUNKS),
              f"closure slabs ({label}): production chunks {production}")
    one, slabs = runs["one chunk"], runs["slabs"]
    check(all("chain" not in slabs[i] and "log_prob" not in slabs[i] for i in indices),
          "closure slabs: a chain was returned with return_chains=False")
    same = {key: all(np.array_equal(slabs[i][key], one[i][key]) for i in indices)
            for key in ("final_coords", "final_log_prob", "acceptance_fraction")}
    rhat_err = max(float(np.max(np.abs(slabs[i]["split_rhat"] - one[i]["split_rhat"]))) for i in indices)
    tau_err = 0.0
    for i in indices:
        a, b = slabs[i]["autocorrelation_time"], one[i]["autocorrelation_time"]
        check((a is None) == (b is None), f"closure slabs: point {i}: one run has a tau estimate, the other none")
        if a is not None:
            tau_err = max(tau_err, float(np.max(np.abs(a - b) / b)))
    af = np.array([float(np.mean(slabs[i]["acceptance_fraction"])) for i in indices])
    t_one, t_slabs = one[indices[0]]["timings"], slabs[indices[0]]["timings"]
    print(f"closure slabs (block, {P} points x {W} walkers x {SLAB_STEPS} steps, injected draws, return_chains=False, "
          f"write=False): dispatch_chunk={SLAB_STEPS // SLAB_CHUNKS} ({SLAB_CHUNKS} chunks) against one chunk: bit-equal "
          f"{same}; tau max rel diff {tau_err:.3g} (tol {TAU_RTOL}), split-R-hat max abs diff {rhat_err:.3g} (tol "
          f"{RHAT_ATOL}); peak allocated bytes one chunk {peaks['one chunk'] / 1e6:.1f} MB, slabs "
          f"{peaks['slabs'] / 1e6:.1f} MB; production s {t_one['production']:.3f} / {t_slabs['production']:.3f}, "
          f"statistics s {t_one['autocorr']:.3f} / {t_slabs['autocorr']:.3f}; acceptance per point "
          f"{af.min():.4f}..{af.max():.4f}; kernel launches {launches['slabs']}; card: {nvidia_smi_line()}", flush=True)
    check(all(same.values()), f"closure slabs: the final state differs from the one-chunk run's: {same}")
    check(tau_err <= TAU_RTOL and rhat_err <= RHAT_ATOL, f"closure slabs: statistics differ: tau {tau_err:.3g}, R-hat {rhat_err:.3g}")
    check(peaks["slabs"] < peaks["one chunk"], f"closure slabs: the slab run's peak is not lower: {peaks}")
    check(bool(((ACCEPTANCE_RANGE[0] < af) & (af < ACCEPTANCE_RANGE[1])).all()), "closure slabs: acceptance out of range")
    return {name: launches["one chunk"][name] + launches["slabs"][name] for name in kernels}


def phase_mesh(device, kernels, s: dict, data: dict) -> dict:
    """The device mesh on the one card. ``get_mesh()`` (one device):
    ``run_mcmc(mesh=...)`` through the captured graph, bit-equal to
    ``mesh=None``. Then a mesh that names the card four times, which runs the
    split, the replicas, the padding and the gather on the card: the sharded
    log-posterior against the unsharded one, ``run_mcmc`` (four K1 launches
    per evaluation, still one captured graph), the closure batch (30 points
    padded to 32, four programs of 8 points), and ``fit_gps`` with the
    instances split four ways. A run over several cards is not measured."""
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu_torch.mcmc.runner import run_closure_batch, run_mcmc
    from bayesian_inference_tpu_torch.models import gp_fit
    from bayesian_inference_tpu_torch.models.emulator import _prepare_group
    from bayesian_inference_tpu_torch.parallel.mesh import get_mesh, make_sharded_log_prob
    import dataclasses

    box = s["box"]
    total = {name: 0 for name in kernels}

    def counted(fn):
        reset(kernels)
        out = fn()
        torch.cuda.synchronize()
        launches = counts(kernels)
        for k, v in launches.items():
            total[k] += v
        return out, launches

    config = mcmc_config(N_STEPS)
    kw = dict(seed=0, device=device, emulation_results=s["artifacts"], observables=s["observables"], write=False)
    one_card = get_mesh()
    check(one_card.size == torch.cuda.device_count() == 1, f"mesh: get_mesh() names {one_card.size} devices")
    plain, launches_plain = counted(lambda: run_mcmc(config, **kw))
    meshed, launches_one = counted(lambda: run_mcmc(config, mesh=one_card, **kw))
    same = {key: bool(np.array_equal(meshed[key], plain[key])) for key in ("chain", "log_prob", "acceptance_fraction")}
    check(meshed["programs_captured"] and all(same.values()) and launches_one == launches_plain,
          f"mesh: the one-device mesh differs from mesh=None: {same}, captured {meshed['programs_captured']}, "
          f"launches {launches_one} / {launches_plain}")

    mesh4 = get_mesh(devices=[device] * MESH_ENTRIES)
    like = build_likelihood(s["emu"], s["artifacts"], s["experimental"], box["min"], box["max"], device=device,
                            observables=s["observables"])
    theta = torch.tensor(plain["chain"][-1], device=device, dtype=like.theta_min.dtype)
    ref = like.log_posterior(theta)
    (sharded_lp, launches_lp) = counted(lambda: make_sharded_log_prob(like, mesh4)(theta))
    lp_err = float((sharded_lp - ref).abs().max() / ref.abs().max())
    check(launches_lp["fused_block_mvn"] == MESH_ENTRIES, f"mesh: {launches_lp} for one sharded evaluation")
    t = time.perf_counter()
    out4, launches4 = counted(lambda: run_mcmc(config, mesh=mesh4, **kw))
    t_mesh = time.perf_counter() - t
    af4 = float(np.mean(out4["acceptance_fraction"]))
    check(out4["programs_captured"], "mesh: four entries of one card are not one captured graph")
    check(launches4["fused_block_mvn"] == MESH_ENTRIES * launches_plain["fused_block_mvn"],
          f"mesh: {launches4} launches against {launches_plain} unsharded, expected {MESH_ENTRIES} per evaluation")
    check(bool(np.isfinite(out4["log_prob"]).all()) and ACCEPTANCE_RANGE[0] < af4 < ACCEPTANCE_RANGE[1],
          f"mesh: the walker-sharded run: acceptance {af4:.4f}")
    overhead = out4["timings"]["production"] / plain["timings"]["production"]
    print(f"mesh: get_mesh() = {one_card.size} card: run_mcmc(mesh=) bit-equal to mesh=None {same}, captured graph "
          f"{meshed['programs_captured']}, launches {launches_one}; mesh of {MESH_ENTRIES} x {device}: sharded "
          f"log-posterior at {theta.shape[0]} positions max err / max|lp| {lp_err:.3g} (tol {CLOSURE_LOGP_TOL}); "
          f"run_mcmc walker-sharded ({N_WALKERS // 2} per half-step in shards of 13/13/12/12), one captured graph "
          f"{out4['programs_captured']}, launches {launches4}, production {out4['timings']['production']:.3f} s = "
          f"{N_STEPS / out4['timings']['production']:.1f} steps/s against {plain['timings']['production']:.3f} s = "
          f"{N_STEPS / plain['timings']['production']:.1f} unsharded ({overhead:.2f}x), whole call {t_mesh:.2f} s, "
          f"acceptance {af4:.4f}; card: {nvidia_smi_line()}", flush=True)
    check(lp_err <= CLOSURE_LOGP_TOL, f"mesh: sharded log-posterior off the unsharded one by {lp_err:.3g}")

    # The closure batch: 30 points padded to 32, four programs of 8 points.
    closure_config = mcmc_config(MESH_CLOSURE_STEPS)
    indices = list(range(s["observables"]["Design_validation"].shape[0]))
    batch_kw = dict(seed=0, device=device, mode="block", emulation_results=s["artifacts"],
                    observables=s["observables"], write=False)
    unsharded, launches_u = counted(lambda: run_closure_batch(closure_config, indices, **batch_kw))
    sharded, launches_s = counted(lambda: run_closure_batch(closure_config, indices, mesh=mesh4, **batch_kw))
    check(sorted(sharded) == indices, f"mesh closure: outputs for {sorted(sharded)}: the pad points' are not absent")
    check(launches_s["fused_block_mvn"] == MESH_ENTRIES * launches_u["fused_block_mvn"],
          f"mesh closure: {launches_s} launches against {launches_u} unsharded")
    like_p = validation_offsets(s, like, "block", device, [sharded[i]["experimental_pseudodata"] for i in indices])
    final = torch.tensor(np.stack([sharded[i]["final_coords"] for i in indices]), device=device, dtype=like.theta_min.dtype)
    lp_ref = like_p.log_posterior(final).double().cpu().numpy()
    lp_got = np.stack([sharded[i]["final_log_prob"] for i in indices]).astype(np.float64)
    closure_err = float(np.max(np.abs(lp_got - lp_ref)) / np.max(np.abs(lp_ref)))
    af_s = np.array([float(np.mean(sharded[i]["acceptance_fraction"])) for i in indices])
    af_u = np.array([float(np.mean(unsharded[i]["acceptance_fraction"])) for i in indices])
    rate_s = len(indices) * MESH_CLOSURE_STEPS / sharded[indices[0]]["timings"]["production"]
    rate_u = len(indices) * MESH_CLOSURE_STEPS / unsharded[indices[0]]["timings"]["production"]
    print(f"mesh closure (block, {len(indices)} points padded to {len(indices) + (-len(indices)) % MESH_ENTRIES}, "
          f"{MESH_ENTRIES} programs of {(len(indices) + (-len(indices)) % MESH_ENTRIES) // MESH_ENTRIES} points, "
          f"{MESH_CLOSURE_STEPS} steps): outputs for {len(sharded)} points; each share's log-posterior at its final "
          f"positions against the unsharded batch likelihood: max err / max|lp| {closure_err:.3g} (tol "
          f"{CLOSURE_LOGP_TOL}); {rate_s:.1f} point-steps/s against {rate_u:.1f} unsharded; acceptance per point "
          f"{af_s.min():.4f}..{af_s.max():.4f} (unsharded {af_u.min():.4f}..{af_u.max():.4f}); launches {launches_s}",
          flush=True)
    check(closure_err <= CLOSURE_LOGP_TOL, f"mesh closure: log-posterior off the unsharded likelihood by {closure_err:.3g}")
    check(bool(((ACCEPTANCE_RANGE[0] < af_s) & (af_s < ACCEPTANCE_RANGE[1])).all()), "mesh closure: acceptance out of range")

    # The fit: the production fit's instances (41 PCs x 51 restarts) split four ways.
    groups = data["emu"].emulation_groups_config
    preps = {name: _prepare_group(g, N_OPT_ITERS, data["observables"]) for name, g in groups.items()}
    first = next(iter(preps.values()))
    spec, dt = first["spec"], torch.float32
    X = torch.as_tensor(first["design"], dtype=dt, device=device)
    Y = torch.as_tensor(np.concatenate([p["Y_pca_truncated"] for p in preps.values()], axis=1), dtype=dt, device=device)
    lo, hi = (torch.as_tensor(a, dtype=dt, device=device) for a in (spec.log_lo, spec.log_hi))
    rand_logs = lo + (hi - lo) * torch.rand((Y.shape[1], spec.n_restarts, spec.theta0.shape[0]), dtype=dt, device=device,
                                            generator=torch.Generator(device=device).manual_seed(13))
    def fits(fit_spec):
        with count_k3_batches() as by_batch_u:
            (unsharded, launched_u) = counted(lambda: gp_fit.fit_gps(fit_spec, X, Y, rand_logs=rand_logs))
        with count_k3_batches() as by_batch_s:
            (sharded, launched_s) = counted(lambda: gp_fit.fit_gps(fit_spec, X, Y, rand_logs=rand_logs, mesh=mesh4))
        check(launched_s["diag_chol_inv"] > launched_u["diag_chol_inv"] > 0,
              f"mesh fit: K3 launches {launched_s} / {launched_u}")
        return unsharded, sharded, dict(sorted(by_batch_u.items(), reverse=True)), dict(sorted(by_batch_s.items(), reverse=True))

    # A few iterations of the whole pool: the shares' arithmetic against the
    # unsharded batch's, before the optimiser's paths can part.
    short = dataclasses.replace(spec, n_iters=MESH_FIT_SHORT_ITERS, halving_keep=0)
    short_u, short_s, _, _ = fits(short)
    short_err = float((short_s.lml - short_u.lml).abs().max())
    fit_u, fit_s, batches_u, batches_s = fits(spec)
    # Each timed with its programs cached: the sharded fit's four are, from
    # the fit just made; they pushed the unsharded fit's two out of the cache
    # (MAX_FIT_PROGRAMS), so that fit runs once untimed first.
    t_s = wall_seconds(lambda: gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs, mesh=mesh4))
    gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs)
    t_u = wall_seconds(lambda: gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs))
    delta = (fit_s.lml - fit_u.lml).double().cpu().numpy()
    own64 = float((fit_s.lml.double() - lml_float64(spec.cfg, fit_s.params, X, Y.T, spec.alpha_jitter)).abs().max())
    lml_scale = float(fit_u.lml.abs().median())
    print(f"mesh fit: fit_gps ({Y.shape[1]} PCs x {spec.n_restarts + 1} restarts) with the instances split over "
          f"{MESH_ENTRIES} mesh entries against the unsharded fit: after {MESH_FIT_SHORT_ITERS} iterations of every "
          f"restart, LML max |delta| {short_err:.4g} nat (tol {LML_TOL_NAT}); after the whole schedule "
          f"({spec.n_iters} iterations, rungs {gp_fit.halving_rungs(spec)}), where the f32 optimiser's paths part: "
          f"|delta| per PC median {np.median(np.abs(delta)):.4g}, max {np.abs(delta).max():.4g}, "
          f"{int((np.abs(delta) > LML_TOL_NAT).sum())} of {delta.size} PCs over {LML_TOL_NAT} nat, mean signed "
          f"{delta.mean():+.4g} nat (median |LML| {lml_scale:.1f}; tol {MESH_FIT_PATH_TOL_NAT}); the sharded fit's LML "
          f"against its float64 recompute max |delta| {own64:.4g} nat (tol {LML_TOL_NAT}); K3 launches by batch "
          f"{batches_s} against {batches_u}; s per fit (programs cached) {t_s:.4f} against {t_u:.4f}", flush=True)
    check(short_err <= LML_TOL_NAT, f"mesh fit: after {MESH_FIT_SHORT_ITERS} iterations LML off the unsharded fit by {short_err:.4g} nat")
    check(own64 <= LML_TOL_NAT, f"mesh fit: LML off its float64 recompute by {own64:.4g} nat")
    check(float(np.median(np.abs(delta))) <= LML_TOL_NAT and int((np.abs(delta) > LML_TOL_NAT).sum()) <= delta.size // 10
          and float(np.abs(delta).max()) <= MESH_FIT_PATH_TOL_NAT,
          f"mesh fit: LML off the unsharded fit: median {np.median(np.abs(delta)):.4g}, max {np.abs(delta).max():.4g} nat")
    gp_fit.clear_fit_programs()
    print("mesh: a run over several cards is not measured (this machine has one card); over distinct cards "
          "run_mcmc(mesh=) runs its steps eagerly with the sharded log-posterior, and the closure batch and the fit "
          "run one captured program per card", flush=True)
    return total


def phase_full_length(device, kernels, data: dict) -> dict:
    """The main path at its full length, once: ``fit_emulators`` then
    ``run_mcmc`` with 100 walkers, 1,000 burn-in and 50,000 production steps,
    block mode, nothing written: wall seconds per phase, steps per second and
    the peak allocated bytes. A measurement, not a threshold."""
    from bayesian_inference_tpu_torch.mcmc.runner import run_mcmc
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    config = production_config(WORK_DIR, data["table_dir"], N_WALKERS, FULL_BURN, FULL_STEPS, N_RESTARTS)
    mcmc = mcmc_config_for(config, FULL_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    with count_evaluations() as evals:
        t0 = time.perf_counter()
        artifacts = fit_emulators(data["emu"], seed=0, n_opt_iters=N_OPT_ITERS, device=device,
                                  observables=data["observables"], write=False)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        out = run_mcmc(mcmc, seed=0, device=device, emulation_results=artifacts, observables=data["observables"],
                       write=False)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated() - base
    timings = {"fit": t_fit, **out["timings"]}
    logp, af = out["log_prob"], float(np.mean(out["acceptance_fraction"]))
    tau = out["autocorrelation_time"]
    print(f"full length: fit_emulators -> run_mcmc, block mode, {N_WALKERS} walkers x ({FULL_BURN} burn-in + {FULL_STEPS}) "
          f"steps, write=False: wall seconds " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f" (statistics = autocorr), whole {t_all:.3f}; {FULL_STEPS / timings['production']:.1f} production steps/s "
          f"({1e3 * timings['production'] / FULL_STEPS:.4f} ms/step); peak allocated bytes above the "
          f"{base / 1e6:.1f} MB held before {peak / 1e6:.1f} MB; kernel launches {launches} for {evals['block']} "
          f"block-mode evaluations; mean acceptance {af:.4f}; split-R-hat max {float(out['split_rhat'].max()):.4f}; tau "
          f"{'none (chain shorter than 50 tau)' if tau is None else np.array2string(np.asarray(tau), precision=1)}; "
          f"card: {nvidia_smi_line()}", flush=True)
    check_k1_per_evaluation(launches, evals, "full length")
    check(launches["fused_block_mvn"] == 2 * (FULL_BURN + FULL_STEPS) + 3 + 6 and launches["diag_chol_inv"] > 0,
          f"full length: launches {launches}")
    check(logp.shape == (FULL_STEPS, N_WALKERS) and bool(np.isfinite(logp).all()), "full length: non-finite log-probs")
    check(ACCEPTANCE_RANGE[0] < af < ACCEPTANCE_RANGE[1], f"full length: mean acceptance {af:.4f} out of range")
    check(bool(np.isfinite(out["split_rhat"]).all()), "full length: non-finite R-hat")
    return launches


def parity_module():
    """``scripts/parity_check_torch.py``, imported from this checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("parity_check_torch", REPO / "scripts" / "parity_check_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_parity(device, kernels, s: dict, data: dict) -> dict:
    """Posterior parity on the slice's fitted emulators, in block and lowrank
    mode: ``run_mcmc`` (f32, the kernels, the port's own generator) against
    the independent numpy stretch move on the float64 likelihood without the
    kernels (the library Cholesky), on the card or the host, whichever
    evaluates 50 walkers faster. One ``parity`` line per mode with the
    report and its gates; a failed gate fails the script, and so does a
    reference that strays from the kernels' own plain version by more than
    REF_VS_UNROLLED_TOL."""
    parity = parity_module()
    inputs = {"config": production_config(WORK_DIR, data["table_dir"], N_WALKERS, 0, 0, N_RESTARTS),
              "analysis_name": ANALYSIS, "parameterization": PARAMETERIZATION, "emu": s["emu"],
              "observables": s["observables"]}
    t_phase = time.perf_counter()
    total = {name: 0 for name in kernels}
    for mode in ("block", "lowrank"):
        reset(kernels)
        with count_evaluations() as evals:
            t = time.perf_counter()
            report = parity.run_parity(inputs, s["artifacts"], mode=mode, device=device, seed=0, n_walkers=N_WALKERS,
                                       n_burn=PARITY_BURN, n_steps=PARITY_STEPS, ref_burn=PARITY_REF_BURN,
                                       ref_steps=PARITY_REF_STEPS, ref_budget_s=PARITY_REF_BUDGET_S[mode])
            seconds = time.perf_counter() - t
        launches = counts(kernels)
        passed, reasons = parity.parity_gates(report)
        print(f"parity {mode}: " + json.dumps({**report, "gates_passed": passed, "gate_failures": reasons,
                                              "seconds": seconds, "launches": launches}), flush=True)
        kernel = "fused_block_mvn" if mode == "block" else "block_mvn"
        check(launches[kernel] == evals[mode] > 0 and sum(launches.values()) == launches[kernel],
              f"parity {mode}: launches {launches} for {evals} likelihood evaluations")
        check(passed, f"parity {mode}: " + "; ".join(reasons))
        check(report["ref_vs_unrolled_rel"] <= REF_VS_UNROLLED_TOL,
              f"parity {mode}: the reference's likelihood strays from the plain version by "
              f"{report['ref_vs_unrolled_rel']:.3g}")
        total = {name: total[name] + launches[name] for name in kernels}
    print(f"parity phase: {time.perf_counter() - t_phase:.1f} s (card: {nvidia_smi_line()})", flush=True)
    return total


def phase_predict(device, kernels, s: dict, n_posterior: int = 100) -> dict:
    """``predict`` at production width from the slice's fitted artifacts (41
    PCs over 3 groups, F = 1,644), merged over the groups, on the card: at the
    195 training design points (the residual plots' call) and at 100
    posterior samples from the slice's chain (the posterior-observable
    plot's), each against the same call on the CPU in float64."""
    from bayesian_inference_tpu_torch.models.emulator import predict

    chain = s["chain"]
    flat = chain.reshape(-1, chain.shape[-1])
    posterior = flat[np.random.default_rng(0).choice(flat.shape[0], n_posterior, replace=False)]
    kw = dict(emulation_group_results=s["artifacts"], observables=s["observables"])
    out = {}
    reset(kernels)
    for name, theta in (("design", np.asarray(s["observables"]["Design"])), ("posterior", posterior)):
        t = time.perf_counter()
        pred = predict(theta, s["emu"], device=device, **kw)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = predict(theta, s["emu"], device="cpu", **kw)
        cpu_s = time.perf_counter() - t
        B, F = pred["central_value"].shape
        central = float(np.abs(pred["central_value"] - ref["central_value"]).max() / np.abs(ref["central_value"]).max())
        diag, diag64 = np.einsum("bff->bf", pred["cov"]), np.einsum("bff->bf", ref["cov"])
        diag_rel = float((np.abs(diag - diag64) / diag64).max())
        finite = bool(np.isfinite(pred["central_value"]).all() and np.isfinite(diag).all())
        print(f"predict at {B} {name} points, merged over {len(s['artifacts'])} groups (F={F}), f32 on the card: "
              f"{card_s:.3f} s wall (host float64 arrays out; covariance {pred['cov'].shape}); the same call on the CPU "
              f"in float64 {cpu_s:.3f} s; central values max err / max|value| {central:.3g} (tol "
              f"{PREDICT_TOL_CENTRAL}), covariance diagonal max rel err {diag_rel:.3g} (tol {PREDICT_TOL_DIAG}); "
              f"finite: {finite}", flush=True)
        check(pred["cov"].shape == (B, F, F) and F == 1644 and finite, f"predict {name}: misshapen or non-finite")
        check(central <= PREDICT_TOL_CENTRAL, f"predict {name}: central values off float64 by {central:.3g}")
        check(diag_rel <= PREDICT_TOL_DIAG, f"predict {name}: covariance diagonal off float64 by {diag_rel:.3g}")
        out[name] = {"points": B, "card_s": card_s, "cpu_float64_s": cpu_s, "central_rel": central,
                     "diag_rel": diag_rel}
        del pred, ref
    launches = counts(kernels)
    print(f"predict kernel launches: {launches} (the GP predict and the covariance are plain PyTorch, as JAX "
          "computes them outside any Pallas kernel)", flush=True)
    return out


def phase_steer_refusal(device) -> None:
    """The steer on the card with a plot toggle on and write=False: refused at
    construction (no matplotlib here, or write=False, whichever the
    constructor checks first), before any stage and any output directory."""
    import shutil

    from bayesian_inference_tpu_torch.pipeline.steer import SteerAnalysis

    work_dir = WORK_DIR / "steer_refusal"
    shutil.rmtree(work_dir, ignore_errors=True)
    config = steer_config(work_dir, WORK_DIR / "production_tables")
    config["plot"]["mcmc"] = True
    try:
        SteerAnalysis(config=config, device=device, write=False)
    except (RuntimeError, ValueError) as e:
        refusal = f"{type(e).__name__}: {e}"
    else:
        raise AssertionError("steer refusal: a plot toggle with write=False on the card was not refused")
    left = Path(config["output_dir"]).exists()
    print(f"steer refusal: SteerAnalysis(config=<plot.mcmc on>, device='cuda', write=False) raised {refusal}; "
          f"output directory left: {left}", flush=True)
    check("plot toggles ['mcmc']" in refusal, f"steer refusal: the message does not name the toggle: {refusal}")
    check(not left, "steer refusal: an output directory was left")


class Interrupted(Exception):
    """Raised by the stand-in for a sampler chunk to cut a run short."""


def interrupt_after(module, name: str, n_calls: int):
    """Replace ``module.<name>`` (a module's function or a class's method) by
    a wrapper that raises ``Interrupted`` on its call after ``n_calls`` calls,
    as a run killed during that chunk would stop; returns a function that
    puts the original back."""
    inner = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(1)
        if len(calls) > n_calls:
            raise Interrupted(f"{name} call {len(calls)}")
        return inner(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, inner)


def run_interrupted(module, name: str, n_calls: int, fn) -> None:
    """Run ``fn`` with ``module.<name>`` cut after ``n_calls`` calls; fail
    unless the cut happened."""
    restore = interrupt_after(module, name, n_calls)
    try:
        fn()
    except Interrupted:
        return
    finally:
        restore()
    raise AssertionError(f"resume: the run finished before {name} call {n_calls + 1}")


def steer_config(work_dir: Path, table_dir: Path) -> dict:
    """The steer's configuration at production width: tables ingested in
    memory, preprocessing with config/example_fixture.yaml's smoothing block
    (later stages read the preprocessed observables), 5-fold CV of every
    group, block likelihood, checkpointed MCMC, and the closure batch."""
    config = production_config(work_dir, table_dir, N_WALKERS, N_BURN, N_STEPS, N_RESTARTS)
    analysis = config["analyses"][ANALYSIS]
    for group in analysis["parameters"]["emulators"].values():
        group.update(cross_validation=True, cross_validation_k=STEER_CV_K)
    analysis["parameters"]["preprocessing"] = {"smoothing": {
        "outlier_n_RMS": 2.0, "interpolation_method": "linear", "max_n_feature_outliers_to_interpolate": 2}}
    analysis["parameters"]["mcmc"].update(checkpoint_every=STEER_CHECKPOINT_EVERY, likelihood_mode="block")
    config.update(
        initialize_observables=True, preprocess_input_data=True, fit_emulators=True, run_mcmc=True,
        run_closure_tests=True, observables_filename="observables_preprocessed.h5",
        plot={k: False for k in ("input_data", "emulators", "mcmc", "qhat", "closure_tests", "across_analyses")},
    )
    return config


def phase_steer(device, kernels) -> dict:
    """The port's steer entry point at production width, in memory
    (``SteerAnalysis(config=..., write=False)``): ingest -> preprocess -> fit
    -> 5-fold CV of every group -> MCMC checkpointed every 500 steps -> the
    closure batch checkpointed every quarter. Then checkpoint resume on the
    card: an MCMC run and a closure batch, each cut during its third chunk
    and run again, against uninterrupted runs; and production with and
    without chunking, in turns, for the cost of checkpointing."""
    import shutil

    from bayesian_inference_tpu_torch.mcmc import runner
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms
    from bayesian_inference_tpu_torch.pipeline.configs import MCMCConfig
    from bayesian_inference_tpu_torch.pipeline.steer import SteerAnalysis

    work_dir = WORK_DIR / "steer"
    shutil.rmtree(work_dir, ignore_errors=True)  # no stale checkpoint from an earlier run of this script
    config = steer_config(work_dir, WORK_DIR / "production_tables")
    analysis = config["analyses"][ANALYSIS]
    reset(kernels)
    with count_evaluations() as evals, count_k3_batches() as k3_batches:
        t = time.perf_counter()
        result = SteerAnalysis(config=config, device=device, write=False).run_analysis()
        result = result[f"{ANALYSIS}_{PARAMETERIZATION}"]
        torch.cuda.synchronize()
        t_steer = time.perf_counter() - t
    launches = counts(kernels)

    mcmc = result["mcmc"]
    logp = mcmc["log_prob"]
    af = float(np.mean(mcmc["acceptance_fraction"]))
    closure = result["closure"]
    af_points = np.array([float(np.mean(closure[i]["acceptance_fraction"])) for i in sorted(closure)])
    cv = result["cross_validation"]
    coverage = {name: float(np.mean(np.abs(a["normalized_residuals"]) < 1)) for name, a in cv.items()}
    print("steer stages (s, stage_timer): " + ", ".join(f"{k} {v:.3f}" for k, v in result["timings"].items())
          + f"; whole run {t_steer:.3f} s; kernel launches {launches} for {evals['block']} block-mode likelihood "
          f"evaluations; K3 launches by batch size {dict(sorted(k3_batches.items(), reverse=True))}", flush=True)
    print(f"steer CV (k={STEER_CV_K}, every group): 1-sigma coverage of the z-scores "
          + ", ".join(f"{name} {c:.3f}" for name, c in coverage.items())
          + f" (want ~0.68); z-scores finite: {all(np.isfinite(a['normalized_residuals']).all() for a in cv.values())}",
          flush=True)
    print(f"steer MCMC: {N_WALKERS} walkers x ({N_BURN} burn-in + {N_STEPS}) steps, checkpoint every "
          f"{STEER_CHECKPOINT_EVERY}; log-probs finite: {bool(np.isfinite(logp).all())}, shape {logp.shape}; "
          f"mean acceptance {af:.4f}; closure batch: {len(closure)} points x {N_STEPS} steps, checkpoint every "
          f"{N_STEPS // 4}, acceptance per point {af_points.min():.4f}..{af_points.max():.4f}", flush=True)
    check(launches["diag_chol_inv"] > 0 and launches["fused_block_mvn"] > 0,
          f"steer: a kernel of the path never launched: {launches}")
    check_k1_per_evaluation(launches, evals, "steer")
    check(sorted(result["timings"]) == sorted(["initialize", "preprocess", "fit_emulators", "cross_validation",
                                                "mcmc", "closure"]), f"steer: stages run {sorted(result['timings'])}")
    check(sorted(cv) == sorted(PRODUCTION_GROUPS), f"steer: CV ran for {sorted(cv)}")
    check(all(np.isfinite(a["normalized_residuals"]).all() for a in cv.values()), "steer: non-finite CV z-scores")
    check(logp.shape == (N_STEPS, N_WALKERS) and bool(np.isfinite(logp).all()), "steer: non-finite MCMC log-probs")
    check(ACCEPTANCE_RANGE[0] < af < ACCEPTANCE_RANGE[1], f"steer: mean acceptance {af:.4f} out of range")
    check(len(closure) == 30 and bool(((ACCEPTANCE_RANGE[0] < af_points) & (af_points < ACCEPTANCE_RANGE[1])).all()),
          f"steer: closure acceptance out of range at some point: {af_points.min():.4f}..{af_points.max():.4f}")
    check(all(np.isfinite(closure[i]["split_rhat"]).all() for i in closure), "steer: non-finite closure R-hat")
    check(not list(work_dir.rglob("*.pkl")), "steer: a checkpoint was left behind")

    # Resume on the card, and production with and without chunking in turns.
    mcmc_config = MCMCConfig(ANALYSIS, PARAMETERIZATION, analysis, config=config)
    inputs = dict(seed=0, device=device, emulation_results=result["emulation"], observables=result["preprocessed"],
                  write=False)

    def run(checkpoint_every):
        return runner.run_mcmc(mcmc_config, checkpoint_every=checkpoint_every, **inputs)

    prod = {"chunked": [mcmc["timings"]["production"]], "single": []}
    for _ in range(STEER_TIMING_PAIRS):
        prod["single"].append(run(None)["timings"]["production"])
        again = run(STEER_CHECKPOINT_EVERY)
        prod["chunked"].append(again["timings"]["production"])
    prod["single"].append(run(None)["timings"]["production"])
    run_interrupted(SamplerPrograms, "chunk", 2 + 2, lambda: run(STEER_CHECKPOINT_EVERY))
    resumed = run(STEER_CHECKPOINT_EVERY)
    same = {key: bool(np.array_equal(resumed[key], mcmc[key]) and np.array_equal(again[key], mcmc[key]))
            for key in ("chain", "log_prob", "acceptance_fraction")}
    median = {k: float(np.median(v)) for k, v in prod.items()}
    spread = {k: float(np.max(v) - np.min(v)) for k, v in prod.items()}
    cost_ms = 1e3 * (median["chunked"] - median["single"]) / N_STEPS
    print(f"steer resume, run_mcmc cut during chunk 3 of {N_STEPS // STEER_CHECKPOINT_EVERY} and resumed "
          f"({resumed['timings']['production']:.3f} s for the rest): bit-equal to the uninterrupted run {same}; "
          f"production {N_STEPS} steps, chunked every {STEER_CHECKPOINT_EVERY} with checkpoints: "
          + " / ".join(f"{s:.3f}" for s in prod["chunked"]) + " s, one chunk: "
          + " / ".join(f"{s:.3f}" for s in prod["single"])
          + f" s (in turns, the steer's run first); medians {N_STEPS / median['chunked']:.1f} vs "
          f"{N_STEPS / median['single']:.1f} steps/s, spread (max - min) {spread['chunked']:.3f} / "
          f"{spread['single']:.3f} s; checkpointing costs {cost_ms:.4f} ms/step (difference of the medians)",
          flush=True)
    check(all(same.values()), f"steer resume: run_mcmc not bit-equal after resume: {same}")

    n_closure = CLOSURE_STEPS["block"]
    cadence = n_closure // 4
    closure_config = mcmc_config_for(config, n_closure)
    indices = list(range(len(closure)))
    batch = dict(seed=0, device=device, emulation_results=result["emulation"], observables=result["preprocessed"],
                 write=False, checkpoint_every=cadence)
    whole = runner.run_closure_batch(closure_config, indices, **batch)
    run_interrupted(SamplerPrograms, "chunk", 2 + 2,
                    lambda: runner.run_closure_batch(closure_config, indices, **batch))
    back = runner.run_closure_batch(closure_config, indices, **batch)
    same = {key: all(np.array_equal(back[i][key], whole[i][key]) for i in indices)
            for key in ("chain", "log_prob", "acceptance_fraction")}
    finite = all(np.isfinite(whole[i]["log_prob"]).all() for i in indices)
    af_whole = np.array([float(np.mean(whole[i]["acceptance_fraction"])) for i in indices])
    print(f"steer resume, closure batch ({len(indices)} points x {n_closure} steps, checkpoint every {cadence}) cut "
          f"during chunk 3 and resumed: bit-equal to the uninterrupted batch {same}; log-probs finite per point: "
          f"{finite}; acceptance per point {af_whole.min():.4f}..{af_whole.max():.4f}", flush=True)
    check(all(same.values()), f"steer resume: closure batch not bit-equal after resume: {same}")
    check(finite, "steer resume: non-finite closure log-probs")
    check(bool(((ACCEPTANCE_RANGE[0] < af_whole) & (af_whole < ACCEPTANCE_RANGE[1])).all()),
          "steer resume: closure acceptance out of range")
    check(not list(work_dir.rglob("*.pkl")), "steer resume: a checkpoint was left behind")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a CUDA card only",
              file=sys.stderr)
        return 1
    if not (SRC / "bayesian_inference_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC} holds no bayesian_inference_tpu_torch package; run it from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from bayesian_inference_tpu_torch.ops import blocked_cholesky, fused_mvn, tiny_mvn
    from bayesian_inference_tpu_torch.ops._native import build_all

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}", flush=True)

    kernels = {"diag_chol_inv": blocked_cholesky.KERNEL, "fused_block_mvn": fused_mvn.KERNEL,
               "block_mvn": tiny_mvn.KERNEL}
    t = time.perf_counter()
    build_all(kernels.values())
    for k in kernels.values():
        usage = "; ".join(line.split("ptxas info    : ")[-1] for line in k.build_log.splitlines()
                          if "Used" in line)
        print(f"build: {k.source.name} -> {k.library_path().name} in {k.build_seconds:.2f} s ({usage})", flush=True)
    print(f"build: {len(kernels)} sources in parallel, {time.perf_counter() - t:.2f} s wall", flush=True)
    print("host I/O: no h5py and no yaml; the config dict, observables and emulator artifacts stay in memory "
          "and the runners write no files (write=False)", flush=True)

    k3, *k3_small = phase_k3(device)
    k1 = phase_k1(device, W=N_WALKERS // 2)
    k1_wide = phase_k1(device, W=N_WALKERS)  # the half-ensemble width of a 200-walker run
    k1_points = phase_k1_points(device)
    k4, *k4_other = phase_k4(device)
    k1_k160, k1_dense = phase_k1_widths(device)
    k4_dense = phase_k4_wide(device)
    data = production_data()
    program_rates = phase_programs(device, kernels, data)
    fit_rates = phase_fit_programs(device, kernels, data)
    path_launches = []
    launches, reuse = phase_slice(device, kernels, data)
    path_launches.append(launches)
    path_launches.append(phase_lowrank(device, kernels, reuse))
    for mode in ("lowrank", "block"):
        path_launches.append(phase_closure(device, kernels, reuse, mode))
    option_launches, option_rates = phase_sampler_options(device, kernels, reuse)
    path_launches.append(option_launches)
    path_launches.append(phase_closure_slabs(device, kernels, reuse))
    path_launches.append(phase_mesh(device, kernels, reuse, data))
    path_launches.append(phase_full_length(device, kernels, data))
    path_launches.append(phase_parity(device, kernels, reuse, data))
    predict_times = phase_predict(device, kernels, reuse)
    path_launches.append(phase_steer(device, kernels))
    phase_steer_refusal(device)
    total = {name: sum(p[name] for p in path_launches) for name in kernels}
    print(f"kernel launches over the ten path runs (fit->sample, lowrank analysis, lowrank and block closure "
          f"batches, the move's options, the closure batch in slabs, the mesh, the full-length main path, "
          f"posterior parity in both modes, steer): "
          f"{total}; whole script {time.perf_counter() - t_start:.1f} s", flush=True)
    print("sampler options beside the default program: " + json.dumps(option_rates), flush=True)
    print("dense routes and predict (no kernel; dense as in JAX): "
          + json.dumps({"k1_nb56": k1_dense, "k4_k72": k4_dense, "predict": predict_times}), flush=True)
    print("sampler programs beside the eager loop: " + json.dumps(program_rates), flush=True)
    print("fit programs beside the eager loop: " + json.dumps(fit_rates), flush=True)

    record = {"kernels": [
        {"name": "diag_chol_inv", "route": "cuda",
         "source": "src/bayesian_inference_tpu_torch/csrc/diag_chol_inv.cu",
         "replaces": "src/bayesian_inference_tpu/ops/blocked_cholesky.py:71",
         "launches": total["diag_chol_inv"], **k3, "other_shapes": k3_small},
        {"name": "fused_block_mvn", "route": "cuda",
         "source": "src/bayesian_inference_tpu_torch/csrc/fused_block_mvn.cu",
         "replaces": "src/bayesian_inference_tpu/ops/pallas_mvn.py:189",
         "launches": total["fused_block_mvn"], **k1, "other_shapes": [k1_wide, k1_points, k1_k160]},
        {"name": "block_mvn", "route": "cuda",
         "source": "src/bayesian_inference_tpu_torch/csrc/tiny_mvn.cu",
         "replaces": "src/bayesian_inference_tpu/ops/pallas_mvn.py:90",
         "launches": total["block_mvn"], **k4, "other_shapes": k4_other},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
