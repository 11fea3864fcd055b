#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``bayesian_inference_tpu_torch``) on one GPU.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``src/.../csrc/``, holds
each one against its plain PyTorch version at the shapes of the main path,
then drives the main path once at production width through the entry points a
user calls (``fit_emulators`` -> ``build_likelihood`` -> ``run_mcmc``) and
checks what comes out. One line per phase; the line before the last is the
card's name and power limit as ``nvidia-smi`` reports them, the line before
that the kernels' JSON record, and the last line ``{"ok": true, ...}``. Any
failed check raises, so the script exits non-zero and prints no result. It
also exits non-zero without a CUDA device or outside a repository checkout.

The run needs no ``h5py`` and no ``yaml``: the configuration is a dict, the
observables come straight from the table ingest, the emulator artifacts stay
in memory and ``run_mcmc`` is called with ``write=False``.
"""

from __future__ import annotations

import json
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
# production steps.
PRODUCTION_GROUPS = {
    "jet_group": {"n_pc": 5, "observable_list": ["jet__pt_"]},
    "substructure_groomed_group": {"n_pc": 11, "observable_list": ["chjet__zg_", "chjet__tg_"]},
    "substructure_Dz_group": {"n_pc": 25, "observable_list": ["jet__Dz_"]},
}
ANALYSIS, PARAMETERIZATION = "smoke", "exponential"
N_RESTARTS, N_OPT_ITERS = 50, 60
N_WALKERS, N_BURN, N_STEPS = 100, 200, 2000

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
# - The slice's log-posterior at 64 posterior points, f32 kernels against the
#   float64 plain path on the same emulators: the f32 GP predictive variance
#   k** - k*^T K^-1 k* cancels against ||K^-1|| ~ 1/noise.
LOGP_TOL = 1e-3
# - The f32 fit's LML at its optimum against a float64 recompute at the same
#   hyperparameters: the repo's fit-parity bar (docs/fit_schedule_study.json).
LML_TOL_NAT = 0.1
ACCEPTANCE_RANGE = (0.05, 0.9)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def normwise_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max over instances of max|a - ref| / max|ref|."""
    diff = (a.double() - ref.double()).abs().amax((-2, -1))
    return float((diff / ref.double().abs().amax((-2, -1))).max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def phase_k3(device, B: int = 41 * 51, reps: int = 20) -> dict:
    """K3 (diag_chol_inv) against its plain version at the fit's exploration batch."""
    from bayesian_inference_tpu_torch.ops import blocked_cholesky as bc

    A64 = matern_blocks(B, bc.NB, device)
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
        check(err[key] <= tol, f"K3: {key} = {err[key]:.3g} > {tol}")

    # A block that is not positive definite must come back as NaN, and only it.
    bad = A[:4].clone()
    bad[1] = -bad[1]
    Lb, _ = bc.diag_chol_inv(bad)
    torch.cuda.synchronize()
    check(bool(torch.isnan(Lb[1]).any()) and bool(torch.isfinite(Lb[[0, 2, 3]]).all()),
          "K3: a non-SPD block must yield NaN without touching its neighbours")

    ms, plain_ms = time_pair(lambda: bc.diag_chol_inv(A), lambda: bc.diag_chol_inv_plain(A), reps)
    print(f"K3 diag_chol_inv ({B}, {bc.NB}, {bc.NB}) f32: normwise rel err vs float64 plain: kernel "
          f"L {err['L_rel_f64_kernel']:.3g} (tol {K3_TOL_L}) / L^-1 {err['Linv_rel_f64_kernel']:.3g} "
          f"(tol {K3_TOL_LINV}), plain f32 L {err['L_rel_f64_plain']:.3g} / L^-1 {err['Linv_rel_f64_plain']:.3g}; "
          f"kernel vs plain f32: L {err['L_rel']:.3g} / L^-1 {err['Linv_rel']:.3g} (tol twice the above), "
          f"max abs err {max_abs:.3g}; non-SPD -> NaN ok; kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call",
          flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def mvn_buckets(W: int, device, dtype, seed: int = 1, k: int = 41):
    """Bucketed block-likelihood operands shaped like the production buckets
    ({8: 40, 16: 96, 24: 8} blocks, k PCs) and per-walker PC means/variances."""
    from bayesian_inference_tpu_torch.mcmc.likelihood import bucketize_blocks

    rng = np.random.default_rng(seed)
    widths = [*rng.integers(1, 9, 40), *rng.integers(9, 17, 96), *rng.integers(17, 25, 8)]
    colscale = np.exp(-np.arange(k) / 10.0)
    U = [rng.normal(size=(w, k)) * colscale * 0.2 for w in widths]
    D = []
    for w in widths:
        A = rng.normal(size=(w, w)) * 0.05
        D.append(A @ A.T + np.diag(rng.uniform(0.005, 0.05, w)))
    d0 = [rng.normal(size=w) * 0.2 for w in widths]
    z = rng.normal(size=(W, k)) * colscale
    v = rng.uniform(1e-3, 0.1, (W, k)) * colscale
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    buckets = [tuple(t(a) for a in b) for b in zip(*bucketize_blocks(U, D, d0))]
    return buckets, t(z), t(v)


def phase_k1(device, W: int, reps: int = 50) -> dict:
    """K1 (fused_block_mvn_loglike) against its plain version: f32 on the card,
    with the plain version in float64 as the reference."""
    from bayesian_inference_tpu_torch.ops import fused_mvn

    buckets, z, v = mvn_buckets(W, device, torch.float32)
    buckets64, z64, v64 = mvn_buckets(W, device, torch.float64)
    check([b[0].shape[:2] for b in buckets] == [(40, 8), (96, 16), (8, 24)], "K1: unexpected bucket layout")

    def kernel():
        return sum(fused_mvn.fused_block_mvn_loglike(U, D, d0, z, v) for U, D, d0 in buckets)

    def plain():
        return sum(fused_mvn.fused_block_mvn_plain(U, D, d0, z, v) for U, D, d0 in buckets)

    ll = kernel()
    torch.cuda.synchronize()
    ll_plain = plain()
    ll64 = sum(fused_mvn.fused_block_mvn_plain(U, D, d0, z64, v64) for U, D, d0 in buckets64)
    scale = float(ll64.abs().max())
    rel = float((ll.double() - ll64).abs().max()) / scale
    rel_plain = float((ll_plain.double() - ll64).abs().max()) / scale
    max_abs = float((ll - ll_plain).abs().max())
    check(ll.shape == (W,) and bool(torch.isfinite(ll).all()), "K1: non-finite or misshapen log-likelihood")
    check(rel <= K1_TOL, f"K1: W={W} differs from the float64 plain path by {rel:.3g} > {K1_TOL}")
    check(bool(torch.equal(ll, kernel())), "K1: repeated launches are not bit-equal")
    ms, plain_ms = time_pair(kernel, plain, reps)
    print(f"K1 fused_block_mvn W={W}, buckets nb 8/16/24 x 40/96/8 blocks, k=41, f32: max abs err vs plain f32 "
          f"{max_abs:.3g}; max err / max|ll| vs float64: kernel {rel:.3g}, plain f32 {rel_plain:.3g} "
          f"(tol {K1_TOL}); bit-equal on repeat; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"per likelihood evaluation (3 bucket calls)", flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


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


def phase_slice(device, kernels, n_restarts: int = N_RESTARTS, n_opt_iters: int = N_OPT_ITERS,
                n_walkers: int = N_WALKERS, n_burn: int = N_BURN, n_steps: int = N_STEPS,
                n_check: int = 64) -> dict:
    """The main path at production width: fit -> likelihood -> sampler."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.io.synthetic import make_production_tables
    from bayesian_inference_tpu_torch.io.tables import initialize_observables_dict_from_tables
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu_torch.mcmc.runner import run_mcmc
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators, posterior_from_artifact
    from bayesian_inference_tpu_torch.models.gp import _LOG_2PI
    from bayesian_inference_tpu_torch.ops.fused_mvn import fused_block_mvn_plain
    from bayesian_inference_tpu_torch.ops.gram import train_gram
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig, MCMCConfig

    t = time.perf_counter()
    table_dir = WORK_DIR / "production_tables"
    make_production_tables(table_dir)
    config = production_config(WORK_DIR, table_dir, n_walkers, n_burn, n_steps, n_restarts)
    analysis = config["analyses"][ANALYSIS]
    observables = initialize_observables_dict_from_tables(str(table_dir), analysis, PARAMETERIZATION)
    emu = EmulationConfig.from_config_file(ANALYSIS, PARAMETERIZATION, analysis, config=config)
    mcmc = MCMCConfig(ANALYSIS, PARAMETERIZATION, analysis, config=config)
    n_obs = len(observables["Prediction"])
    n_features = sum(np.atleast_2d(p["y"]).shape[0] for p in observables["Prediction"].values())
    n_design = observables["Design"].shape[0]
    t_data = time.perf_counter() - t
    print(f"slice data: {n_obs} observables / {n_features} features / design ({n_design}, "
          f"{observables['Design'].shape[1]}) from the synthetic production tables, {t_data:.2f} s (set-up)",
          flush=True)

    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    artifacts = fit_emulators(emu, seed=0, n_opt_iters=n_opt_iters, device=device,
                              observables=observables, write=False)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t
    out = run_mcmc(mcmc, seed=0, device=device, emulation_results=artifacts, observables=observables,
                   write=False)
    launches = {name: k.launches for name, k in kernels.items()}

    n_pc = sum(g["n_pc"] for g in PRODUCTION_GROUPS.values())
    timings = {"fit": t_fit, **out["timings"]}
    logp = out["log_prob"]
    af = float(np.mean(out["acceptance_fraction"]))
    print("slice phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
          + f"; {n_pc} PCs x {n_restarts + 1} restarts x {n_opt_iters} iterations; {n_walkers} walkers x "
          f"({n_burn} burn-in + {n_steps}) steps, {n_steps / timings['production']:.1f} production steps/s",
          flush=True)
    print(f"slice kernel launches: {launches}; production log-probs finite: {bool(np.isfinite(logp).all())}, "
          f"shape {logp.shape}; mean acceptance {af:.4f} (must lie in {ACCEPTANCE_RANGE})", flush=True)
    check(n_pc == sum(a["n_pc"] for a in artifacts.values()), "slice: fitted PC count")
    check(all(n > 0 for n in launches.values()), f"slice: a kernel of the path never launched: {launches}")
    check(logp.shape == (n_steps, n_walkers) and bool(np.isfinite(logp).all()), "slice: non-finite log-probs")
    check(ACCEPTANCE_RANGE[0] < af < ACCEPTANCE_RANGE[1], f"slice: mean acceptance {af:.4f} out of range")

    # The fit's LMLs against a float64 recompute at the fitted hyperparameters.
    lml_delta = 0.0
    for art in artifacts.values():
        cfg, post = posterior_from_artifact(art, device=device, dtype=torch.float64)
        K = train_gram(cfg, post.params, post.X, art["emulators"]["alpha_jitter"])
        Y = torch.tensor(art["PCA"]["Y_pca_truncated"].T, dtype=torch.float64, device=device)
        Lc = torch.linalg.cholesky(K)
        a = torch.cholesky_solve(Y[..., None], Lc)[..., 0]
        lml64 = (-0.5 * (Y * a).sum(-1) - torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1)
                 - 0.5 * Y.shape[-1] * _LOG_2PI)
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
    lp64 = sum(fused_block_mvn_plain(U, D, d0, z, v) for U, D, d0 in zip(like64.U, like64.D, like64.d0))
    lp_rel = float((lp - lp64).abs().max() / lp64.abs().max())
    print(f"slice check: fitted LML vs float64 recompute max |delta| {lml_delta:.4g} nat (tol {LML_TOL_NAT}); "
          f"log_posterior at "
          f"{n_check} posterior points, f32 kernels vs float64 plain: max err / max|lp| {lp_rel:.3g} "
          f"(tol {LOGP_TOL})", flush=True)
    check(bool(torch.isfinite(lp).all()), "slice: non-finite log_posterior at posterior points")
    check(lp_rel <= LOGP_TOL, f"slice: log_posterior differs from the float64 plain path by {lp_rel:.3g}")
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
    from bayesian_inference_tpu_torch.ops import blocked_cholesky, fused_mvn

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}", flush=True)

    kernels = {"diag_chol_inv": blocked_cholesky.KERNEL, "fused_block_mvn": fused_mvn.KERNEL}
    for name, k in kernels.items():
        k.build()
        usage = "; ".join(line.split("ptxas info    : ")[-1] for line in k.build_log.splitlines()
                          if "Used" in line)
        print(f"build: {k.source.name} -> {k.library_path().name} in {k.build_seconds:.2f} s ({usage})", flush=True)
    print("host I/O: no h5py and no yaml; the config dict, observables and emulator artifacts stay in memory "
          "and run_mcmc(write=False) writes no files", flush=True)

    k3 = phase_k3(device)
    k1 = phase_k1(device, W=N_WALKERS // 2)
    phase_k1(device, W=N_WALKERS)  # the half-ensemble width of a 200-walker run
    launches = phase_slice(device, kernels)

    record = {"kernels": [
        {"name": "diag_chol_inv", "route": "cuda",
         "source": "src/bayesian_inference_tpu_torch/csrc/diag_chol_inv.cu",
         "replaces": "src/bayesian_inference_tpu/ops/blocked_cholesky.py:71",
         "launches": launches["diag_chol_inv"], **k3},
        {"name": "fused_block_mvn", "route": "cuda",
         "source": "src/bayesian_inference_tpu_torch/csrc/fused_block_mvn.cu",
         "replaces": "src/bayesian_inference_tpu/ops/pallas_mvn.py:189",
         "launches": launches["fused_block_mvn"], **k1},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
