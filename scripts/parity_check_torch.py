#!/usr/bin/env python3
"""Posterior parity of the PyTorch port: its sampler against an independent
numpy stretch move, on the same emulated posterior.

The port's counterpart of ``scripts/parity_check.py``. "Ours" is the port's
main-path entry point, ``run_mcmc(config, device=..., write=False, ...)``:
the sampler programs (on the card a captured CUDA graph of the ensemble
step, float32, the kernels) drawing from the port's own ``torch.Generator``.
The reference is a numpy implementation of the same published algorithm
(Goodman & Weare 2010, the algorithm emcee implements), carried here as
``run_stretch_numpy`` with a numpy random stream; it shares no code with
``mcmc/stretch.py`` and evaluates the port's likelihood built in float64
without the kernels, eagerly (``reference_log_posterior``: each covariance
through the library Cholesky, the block likelihood's width buckets merged
into one), on the card or on the host, whichever evaluates 50 walkers
faster.

The report, as the JAX script's: both acceptance fractions, tau_max, and per
parameter the two-sample KS statistic and p-value on marginals thinned along
the step axis by ceil(tau), the thinned sample count, and the median / q16 /
q84 differences over the prior width. ``parity_gates`` passes or fails it.

Usage (from the repository root)::

    python3 scripts/parity_check_torch.py                    # the card, production tables, block mode
    python3 scripts/parity_check_torch.py --mode lowrank
    python3 scripts/parity_check_torch.py --device cpu --dtype float32 --restarts 4
    python3 scripts/parity_check_torch.py --device cpu --tables fixture   # needs h5py and yaml

``--tables production`` (the default) fits the emulators on the synthetic
production tables (144 observables, 1,644 features, 195 design points, 5 +
11 + 25 PCs), which ``chip_smoke.py`` builds in memory too; ``--tables
fixture`` on the repository's fixture. The script imports torch, numpy,
scipy and the port, never JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent

# The gates: |delta acceptance|, every quantile difference over the prior
# width, and the smallest KS p-value over the parameters.
MAX_ACCEPTANCE_DIFF = 0.03
MAX_QUANTILE_DIFF = 0.05
MIN_KS_PVALUE = 1e-4
QUANTILES = {"q16": 0.16, "median": 0.5, "q84": 0.84}


def run_stretch_numpy(rng: np.random.Generator, log_prob, x0: np.ndarray, n_steps: int, a: float = 2.0):
    """The stretch move of Goodman & Weare (2010) in numpy: two-half updates,
    partner drawn from the complementary half, z ~ g(z) proportional to
    1/sqrt(z) on [1/a, a], acceptance min(1, z^(d-1) p(Y)/p(X)).

    Returns (chain (n_steps, W, d), log_prob (n_steps, W), acceptance (W,)).
    """
    x = np.array(x0, dtype=float)
    W, d = x.shape
    logp = np.array(log_prob(x), dtype=float, copy=True)
    chain = np.zeros((n_steps, W, d))
    logps = np.zeros((n_steps, W))
    n_acc = np.zeros(W)

    for t in range(n_steps):
        perm = rng.permutation(W)
        half = W // 2
        for first, second in ((perm[:half], perm[half:]), (perm[half:], perm[:half])):
            z = (1.0 + (a - 1.0) * rng.uniform(size=first.size)) ** 2 / a
            partners = second[rng.integers(0, second.size, size=first.size)]
            y = x[partners] + z[:, None] * (x[first] - x[partners])
            logp_y = np.array(log_prob(y), dtype=float, copy=True)
            log_ratio = (d - 1.0) * np.log(z) + logp_y - logp[first]
            accept = np.log(rng.uniform(size=first.size)) < log_ratio
            x[first[accept]] = y[accept]
            logp[first[accept]] = logp_y[accept]
            n_acc[first[accept]] += 1
        chain[t] = x
        logps[t] = logp
    return chain, logps, n_acc / n_steps


def library_mvn_terms(dY: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(quad, half_logdet) = (|L^-1 dY|^2, sum log diag L) of (..., n)
    residuals and (..., n, n) covariances C = L L^T, by the library Cholesky
    and triangular solve."""
    L = torch.linalg.cholesky_ex(C)[0]
    e = torch.linalg.solve_triangular(L, dY[..., None], upper=False)[..., 0]
    return (e * e).sum(-1), torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def reference_log_posterior(like, theta: torch.Tensor, terms=library_mvn_terms) -> torch.Tensor:
    """``like.log_posterior(theta)`` without the kernels, on either device:
    the GP predict's plain version, then the block likelihood (each bucket's
    residuals and covariances assembled in plain torch) or the Woodbury likelihood, with
    ``terms`` giving (quad, half_logdet) of each covariance: by default the
    library Cholesky, or ``tiny_mvn.mvn_terms_plain``, the kernels' own plain
    version (the unrolled factorisation). -inf outside the prior box."""
    from bayesian_inference_tpu_torch.ops.gp_predict import gp_predict_plain
    from bayesian_inference_tpu_torch.ops.mvn import woodbury_loglike

    inside = torch.all((theta > like.theta_min) & (theta < like.theta_max), dim=-1)
    theta_safe = torch.clamp(theta, like.theta_min, like.theta_max)
    zs, vs = zip(*(gp_predict_plain(cfg, posts, theta_safe) for cfg, posts in like.groups))
    z, v = torch.cat(zs, dim=1), torch.cat(vs, dim=1)
    if like.mode == "block":
        ll = 0.0
        for U, D, d0 in zip(like.U, like.D, like.d0):
            quad, half_logdet = terms(d0 + torch.einsum("bfk,wk->wbf", U, z),
                                      D + torch.einsum("bfk,wk,bgk->wbfg", U, v, U))
            ll = ll + (-0.5 * quad - half_logdet).sum(-1)
    else:
        ll = woodbury_loglike(like.wb, z, v, terms=terms)
    return torch.where(inside, ll, -torch.inf)


def one_bucket(like):
    """A block-mode likelihood with its width buckets merged into one, every
    block padded to the widest as within a bucket (zero U rows and offsets,
    unit diagonal in D, which add nothing to the sum): one factorisation
    call per evaluation instead of one per bucket. Other modes as given."""
    import dataclasses

    if like.mode != "block" or len(like.U) == 1:
        return like
    pad = torch.nn.functional.pad
    nb = max(U.shape[1] for U in like.U)
    Ds = []
    for D in like.D:
        n = D.shape[-1]
        D = pad(D, (0, nb - n, 0, nb - n))
        D[:, range(n, nb), range(n, nb)] = 1.0
        Ds.append(D)
    return dataclasses.replace(
        like, U=(torch.cat([pad(U, (0, 0, 0, nb - U.shape[1])) for U in like.U]),), D=(torch.cat(Ds),),
        d0=(torch.cat([pad(d0, (0, nb - d0.shape[-1])) for d0 in like.d0], dim=-2),),
    )


def numpy_log_prob(like):
    """A numpy (W, d) -> (W,) float64 function over ``reference_log_posterior``."""
    device, dtype = like.theta_min.device, like.theta_min.dtype

    def log_prob(x: np.ndarray) -> np.ndarray:
        return reference_log_posterior(like, torch.as_tensor(x, dtype=dtype, device=device)).cpu().numpy()

    return log_prob


def seconds_per_call(fn, x: np.ndarray, reps: int = 20) -> float:
    """Host-clock seconds of one ``fn(x)`` (a numpy call, so it ends with the
    download), after one warm-up call."""
    fn(x)
    t = time.perf_counter()
    for _ in range(reps):
        fn(x)
    return (time.perf_counter() - t) / reps


def inputs_production(work_dir: Path, n_restarts: int) -> dict:
    """The synthetic production tables, ingested in memory, and the configs
    over them (``chip_smoke.py``'s production configuration)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from bayesian_inference_tpu_torch.io.synthetic import make_production_tables
    from bayesian_inference_tpu_torch.io.tables import initialize_observables_dict_from_tables
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig

    table_dir = work_dir / "production_tables"
    make_production_tables(table_dir)
    config = chip_smoke.production_config(work_dir, table_dir, 2, 0, 0, n_restarts)  # the MCMC set per run
    name, param = chip_smoke.ANALYSIS, chip_smoke.PARAMETERIZATION
    analysis = config["analyses"][name]
    observables = initialize_observables_dict_from_tables(str(table_dir), analysis, param)
    emu = EmulationConfig.from_config_file(name, param, analysis, config=config)
    return {"config": config, "analysis_name": name, "parameterization": param, "emu": emu,
            "observables": observables}


def inputs_fixture(work_dir: Path, n_restarts: int) -> dict:
    """The repository's fixture (tests/test_data), as the JAX script uses it."""
    sys.path.insert(0, str(REPO / "tests"))
    from config_factory import make_analysis_yaml

    from bayesian_inference_tpu_torch.io.observables import read_observables
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig, load_yaml

    path, name, param = make_analysis_yaml(work_dir, n_restarts=n_restarts)
    config = load_yaml(path)
    emu = EmulationConfig.from_config_file(name, param, config["analyses"][name], config=config)
    return {"config": config, "analysis_name": name, "parameterization": param, "emu": emu,
            "observables": read_observables(emu.output_dir, emu.observables_filename)}


def mcmc_config(inputs: dict, n_walkers: int, n_burn: int, n_steps: int):
    """The inputs' MCMC config with this run's walkers and step counts."""
    import copy

    from bayesian_inference_tpu_torch.pipeline.configs import MCMCConfig

    config = copy.deepcopy(inputs["config"])
    analysis = config["analyses"][inputs["analysis_name"]]
    analysis["parameters"]["mcmc"].update(n_walkers=n_walkers, n_burn_steps=n_burn, n_sampling_steps=n_steps)
    return MCMCConfig(inputs["analysis_name"], inputs["parameterization"], analysis, config=config)


def reference_likelihoods(inputs: dict, artifacts: dict, mode: str, devices) -> dict:
    """{device: the port's likelihood built in float64 there}."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc.likelihood import build_likelihood

    emu = inputs["emu"]
    cfg = mcmc_config(inputs, 2, 0, 0)
    box = cfg.parameterization_spec()
    experimental = obs_io.data_array_from_h5(cfg.output_dir, cfg.observables_filename,
                                             observable_filter=emu.observable_filter,
                                             observables=inputs["observables"])
    return {str(dev): build_likelihood(emu, artifacts, experimental, box["min"], box["max"], mode=mode,
                                       device=dev, dtype=torch.float64, observables=inputs["observables"])
            for dev in devices}


def parity_report(chain: np.ndarray, acceptance: np.ndarray, chain_ref: np.ndarray, acceptance_ref: np.ndarray,
                  theta_min, theta_max, reference: str = "numpy_ref", **meta) -> dict:
    """The JAX script's report of two (steps, W, d) chains after burn-in,
    ours and the reference's (named ``reference`` in the acceptance key):
    acceptances, tau_max (the larger of the two chains' largest tau), and per
    parameter KS on marginals thinned along the step axis by ceil(tau_max),
    the thinned sample counts, and the quantile differences (unthinned) over
    the prior width. ``meta`` goes into the report as given."""
    from scipy.stats import ks_2samp

    from bayesian_inference_tpu_torch.mcmc.stats import integrated_time

    tau = max(float(integrated_time(chain, quiet=True).max()), float(integrated_time(chain_ref, quiet=True).max()))
    thin = max(1, int(np.ceil(tau)))
    ndim = chain.shape[-1]
    s1, s2 = chain.reshape(-1, ndim), chain_ref.reshape(-1, ndim)
    t1, t2 = chain[::thin].reshape(-1, ndim), chain_ref[::thin].reshape(-1, ndim)
    width = np.asarray(theta_max, float) - np.asarray(theta_min, float)
    report = {**meta, "reference": reference, "acceptance_ours": float(np.mean(acceptance)),
              f"acceptance_{reference}": float(np.mean(acceptance_ref)), "tau_max": tau, "thin": thin,
              "per_parameter": []}
    for d in range(ndim):
        ks = ks_2samp(t1[:, d], t2[:, d])
        entry = {"dim": d, "ks_stat": float(ks.statistic), "ks_pvalue": float(ks.pvalue), "n_eff": int(t1.shape[0]),
                 "n_eff_ref": int(t2.shape[0])}
        for name, q in QUANTILES.items():
            diff = abs(np.quantile(s1[:, d], q) - np.quantile(s2[:, d], q)) / width[d]
            entry[f"{name}_diff_over_prior_width"] = float(diff)
        report["per_parameter"].append(entry)
    return report


def parity_gates(report: dict, max_acceptance_diff: float = MAX_ACCEPTANCE_DIFF,
                 max_quantile_diff: float = MAX_QUANTILE_DIFF, min_ks_pvalue: float = MIN_KS_PVALUE):
    """(passed, reasons): |delta acceptance| <= max_acceptance_diff, every
    quantile difference <= max_quantile_diff of the prior width, every KS
    p-value > min_ks_pvalue. ``reasons`` names each failed gate."""
    reasons = []
    d_acc = abs(report["acceptance_ours"] - report[f"acceptance_{report['reference']}"])
    if not d_acc <= max_acceptance_diff:
        reasons.append(f"|delta acceptance| {d_acc:.4f} > {max_acceptance_diff}")
    for p in report["per_parameter"]:
        for name in QUANTILES:
            diff = p[f"{name}_diff_over_prior_width"]
            if not diff <= max_quantile_diff:
                reasons.append(f"dim {p['dim']}: {name} differs by {diff:.4f} of the prior width > {max_quantile_diff}")
        if not p["ks_pvalue"] > min_ks_pvalue:
            reasons.append(f"dim {p['dim']}: KS p {p['ks_pvalue']:.3g} <= {min_ks_pvalue}")
    return not reasons, reasons


def sample_ours(inputs: dict, artifacts: dict, mode: str, device, seed: int, n_walkers: int, n_burn: int,
                n_steps: int, dtype: torch.dtype | None = None) -> tuple[dict, float]:
    """The port's main path: ``run_mcmc`` on ``device`` with its own
    generator, nothing written. Returns (its output, wall seconds)."""
    from bayesian_inference_tpu_torch.mcmc.runner import run_mcmc

    cfg = mcmc_config(inputs, n_walkers, n_burn, n_steps)
    t = time.perf_counter()
    out = run_mcmc(cfg, seed=seed, device=device, emulation_results=artifacts, observables=inputs["observables"],
                   write=False, mode=mode, dtype=dtype)
    return out, time.perf_counter() - t


def sample_reference(log_prob, theta_min: np.ndarray, theta_max: np.ndarray, n_walkers: int, n_burn: int,
                     n_steps: int, seed: int) -> tuple[np.ndarray, np.ndarray, float]:
    """The numpy stretch move from the JAX script's start (uniform in the
    box, pulled halfway to its centre; ``default_rng(seed)``): ``n_burn``
    steps, then ``n_steps`` production steps. Returns (production chain,
    production acceptance per walker, wall seconds)."""
    rng = np.random.default_rng(seed)
    x0 = 0.5 * (rng.uniform(theta_min, theta_max, (n_walkers, theta_min.size)) + 0.5 * (theta_min + theta_max))
    t = time.perf_counter()
    if n_burn:
        x0 = run_stretch_numpy(rng, log_prob, x0, n_burn)[0][-1]
    chain, _, acceptance = run_stretch_numpy(rng, log_prob, x0, n_steps)
    return chain, acceptance, time.perf_counter() - t


def run_parity(inputs: dict, artifacts: dict, mode: str = "block", device="cuda", seed: int = 0,
               n_walkers: int = 100, n_burn: int = 1000, n_steps: int = 6000, ref_burn: int = 1000,
               ref_steps: int = 6000, ref_budget_s: float | None = None, dtype: torch.dtype | None = None) -> dict:
    """Ours (``run_mcmc`` on ``device``, ``n_burn`` + at least as many
    production steps as the reference) against the numpy reference
    (``ref_burn`` + ``ref_steps``, fewer production steps where
    ``ref_budget_s`` seconds do not hold them) on the same fitted emulators.
    The reference runs on the card or the host, whichever evaluates 50
    walkers faster in float64. Returns the report, with the seconds of both
    runs and of one reference evaluation on each device, and the largest
    relative difference of the reference's likelihood from the kernels' own
    plain version (the unrolled factorisation) at the timed points."""
    from bayesian_inference_tpu_torch.ops.tiny_mvn import mvn_terms_plain

    device = torch.device(device)
    devices = [device, torch.device("cpu")] if device.type == "cuda" else [device]
    likes = reference_likelihoods(inputs, artifacts, mode, devices)
    lo = likes["cpu"].theta_min.numpy()
    hi = likes["cpu"].theta_max.numpy()
    probe = np.random.default_rng(seed + 7).uniform(lo, hi, (n_walkers // 2, lo.size))
    eval_s = {dev: seconds_per_call(numpy_log_prob(one_bucket(like)), probe) for dev, like in likes.items()}
    ref_device = min(eval_s, key=eval_s.get)
    like = likes[ref_device]
    x = torch.as_tensor(probe, dtype=torch.float64, device=like.theta_min.device)
    unrolled = reference_log_posterior(like, x, terms=mvn_terms_plain)
    like = one_bucket(like)
    ref_vs_unrolled = float((reference_log_posterior(like, x) - unrolled).abs().max() / unrolled.abs().max())
    if ref_budget_s is not None:  # two evaluations per step
        ref_steps = max(0, min(ref_steps, int(ref_budget_s / (2 * eval_s[ref_device])) - ref_burn))
    n_steps = max(n_steps, ref_steps)

    out, ours_s = sample_ours(inputs, artifacts, mode, device, seed, n_walkers, n_burn, n_steps, dtype)
    chain_ref, acc_ref, ref_s = sample_reference(numpy_log_prob(like), lo, hi, n_walkers, ref_burn, ref_steps, seed)
    return parity_report(
        out["chain"], out["acceptance_fraction"], chain_ref, acc_ref, lo, hi, mode=mode, seed=seed,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", dtype=str(out["chain"].dtype),
        walkers=n_walkers, burn=n_burn, steps=n_steps, ref_burn=ref_burn, ref_steps=ref_steps,
        ref_device=ref_device, ref_seconds_per_eval=eval_s, ref_vs_unrolled_rel=ref_vs_unrolled, ours_seconds=ours_s,
        ref_seconds=ref_s,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tables", default="production", choices=["production", "fixture"])
    parser.add_argument("--mode", default="block", choices=["block", "lowrank"])
    parser.add_argument("--device", default="cuda", help="ours: cuda (float32, the kernels) or cpu (float64)")
    parser.add_argument("--dtype", default=None, choices=["float32", "float64"], help="ours: the run's precision")
    parser.add_argument("--walkers", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--burn", type=int, default=1000, help="burn-in steps, ours and the reference")
    parser.add_argument("--steps", type=int, default=6000, help="production steps, ours and the reference")
    parser.add_argument("--restarts", type=int, default=None, help="GP fit restarts (default: the tables' config)")
    parser.add_argument("--work-dir", default=str(REPO / "build" / "parity_check_torch"))
    args = parser.parse_args()

    sys.path.insert(0, str(REPO / "src"))
    work_dir = Path(args.work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    if args.tables == "production":
        inputs = inputs_production(work_dir, 50 if args.restarts is None else args.restarts)
    else:
        inputs = inputs_fixture(work_dir, 5 if args.restarts is None else args.restarts)
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    t = time.perf_counter()
    artifacts = fit_emulators(inputs["emu"], seed=0, device=args.device, observables=inputs["observables"],
                              write=False)
    fit_s = time.perf_counter() - t
    report = run_parity(inputs, artifacts, mode=args.mode, device=args.device, seed=args.seed,
                        n_walkers=args.walkers, n_burn=args.burn, n_steps=args.steps, ref_burn=args.burn,
                        ref_steps=args.steps, dtype=getattr(torch, args.dtype) if args.dtype else None)
    passed, reasons = parity_gates(report)
    print(json.dumps({**report, "tables": args.tables, "fit_seconds": fit_s, "gates_passed": passed,
                      "gate_failures": reasons}, indent=2))
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
