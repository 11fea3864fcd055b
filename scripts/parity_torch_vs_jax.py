#!/usr/bin/env python3
"""The PyTorch port against the JAX package at production width, in float64
on the CPU.

It imports both packages (and h5py), so it runs on a host that has JAX,
never on the card's machine. Five parts, in order:

1. tables: both packages' ``make_production_tables`` write the same files,
   byte for byte (144 observables, 1,644 features, 195 design points);
2. fit: the JAX package fits the three production groups (5 + 11 + 25 PCs,
   Matern-1.5 + white noise, ``--restarts`` + 1 restarts, 60 L-BFGS
   iterations) once; both likelihoods are built from these artifacts;
3. logp: the log-posterior of both packages at 256 points (16 outside the
   prior box, 112 from the JAX chain when the posterior part ran), in block
   and lowrank mode: the same -inf pattern, relative difference <= 1e-10;
4. posterior: ``run_mcmc`` of each package, 100 walkers, 1,000 burn-in +
   ``--steps`` production steps, independent seeds, compared by the report
   and gates of ``scripts/parity_check_torch.py`` (the port as "ours", the
   JAX chain as the reference);
5. cv: ``cross_validate_group`` of each package for every group, 5 folds,
   the same folds (seed 0) and the same restart points (the port is given
   the draws of JAX's fold keys), ``--cv-restarts`` + 1 restarts, 60
   iterations: 1-sigma coverage, z-score mean and std, and the median
   |delta z| over the held-out points.

Usage, from the repository root::

    python3 scripts/parity_torch_vs_jax.py                        # every part, block-mode posterior
    python3 scripts/parity_torch_vs_jax.py --posterior-modes block lowrank

It writes the results as JSON to ``--out`` (default
``build/parity_torch_vs_jax/result.json``) and prints each part's line.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
LOGP_RTOL = 1e-10
N_OUTSIDE, N_FROM_CHAIN = 16, 112
N_WALKERS = 100
SEEDS = (1, 2)  # run_mcmc of the JAX package, of the port


def setup_paths() -> None:
    for p in (REPO / "src", REPO / "scripts", REPO):
        sys.path.insert(0, str(p))


def part_tables(work: Path) -> dict:
    """Both packages' synthetic production tables, file by file."""
    from bayesian_inference_tpu.io.synthetic import make_production_tables as jax_tables
    from bayesian_inference_tpu_torch.io.synthetic import make_production_tables as torch_tables

    jdir, tdir = work / "tables_jax", work / "tables_torch"
    jlabels, tlabels = jax_tables(jdir), torch_tables(tdir)
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    same = files == tfiles and all(filecmp.cmp(jdir / f, tdir / f, shallow=False) for f in files)
    if not (same and jlabels == tlabels):
        raise AssertionError("the packages' production tables differ")
    return {"files": len(files), "labels": len(jlabels), "bit_equal": same, "table_dir": str(jdir)}


def write_config(work: Path, table_dir: str, n_restarts: int, n_walkers: int, n_burn: int, n_steps: int,
                 name: str = "analysis.yaml") -> Path:
    """The production analysis (``chip_smoke.py``'s configuration) as a YAML
    both packages read, with every group cross-validated in 5 folds."""
    import yaml

    import chip_smoke

    config = chip_smoke.production_config(work, Path(table_dir), n_walkers, n_burn, n_steps, n_restarts)
    for g in config["analyses"][chip_smoke.ANALYSIS]["parameters"]["emulators"].values():
        g.update(cross_validation=True, cross_validation_k=5)
    path = work / name
    path.write_text(yaml.safe_dump(config))
    return path


def configs(path: Path, module, **mcmc):
    import chip_smoke

    config = module.load_yaml(path)
    analysis = config["analyses"][chip_smoke.ANALYSIS]
    analysis["parameters"]["mcmc"].update(mcmc)
    kw = dict(analysis_name=chip_smoke.ANALYSIS, parameterization=chip_smoke.PARAMETERIZATION,
              analysis_config=analysis, config_file=str(path))
    return module.EmulationConfig.from_config_file(**kw), module.MCMCConfig(**kw)


def ingest(path: Path) -> None:
    """The JAX package's table ingest, written to the run's observables.h5."""
    import chip_smoke
    from bayesian_inference_tpu.io import hdf5
    from bayesian_inference_tpu.io.tables import initialize_observables_dict_from_tables
    from bayesian_inference_tpu.pipeline.configs import load_yaml

    config = load_yaml(path)
    analysis = config["analyses"][chip_smoke.ANALYSIS]
    obs = initialize_observables_dict_from_tables(config["observable_table_dir"], analysis,
                                                 chip_smoke.PARAMETERIZATION)
    run_dir = Path(config["output_dir"]) / f"{chip_smoke.ANALYSIS}_{chip_smoke.PARAMETERIZATION}"
    hdf5.write_dict_to_h5(obs, str(run_dir), "observables.h5", verbose=False)


def thetas(lo: np.ndarray, hi: np.ndarray, chain: np.ndarray | None, seed: int = 11) -> np.ndarray:
    """256 points: from the chain's last steps where given, the rest uniform
    in the box, 16 of them moved outside it (two on its boundary)."""
    rng = np.random.default_rng(seed)
    n_chain = 0 if chain is None else N_FROM_CHAIN
    theta = lo + (hi - lo) * rng.uniform(0.02, 0.98, (256, lo.size))
    if n_chain:
        flat = chain[-200:].reshape(-1, lo.size)
        theta[:n_chain] = flat[rng.choice(flat.shape[0], n_chain, replace=False)]
    out = np.arange(256 - N_OUTSIDE, 256)
    dims = rng.integers(0, lo.size, N_OUTSIDE)
    theta[out, dims] = np.where(rng.uniform(size=N_OUTSIDE) < 0.5, lo[dims] - 0.1 * (hi - lo)[dims],
                                hi[dims] + 0.1 * (hi - lo)[dims])
    theta[out[:2]] = [lo, hi]  # on the boundary: outside (the box is open)
    return theta


def part_logp(state: dict, chain: np.ndarray | None) -> dict:
    import jax.numpy as jnp
    import torch

    from bayesian_inference_tpu.mcmc import likelihood as jlik
    from bayesian_inference_tpu_torch.mcmc import likelihood as tlik

    lo, hi = state["lo"], state["hi"]
    theta = thetas(lo, hi, chain)
    result = {"n_points": int(theta.shape[0]), "n_from_chain": 0 if chain is None else N_FROM_CHAIN}
    for mode in ("block", "lowrank"):
        jlike = jlik.build_likelihood(state["jemu"], state["artifacts"], state["exp"], theta_min=lo, theta_max=hi,
                                      mode=mode)
        tlike = tlik.build_likelihood(state["temu"], state["artifacts"], state["exp"], theta_min=lo, theta_max=hi,
                                      mode=mode, device="cpu", dtype=torch.float64, observables=state["tobs"])
        ref = np.asarray(jlike.log_posterior(jnp.asarray(theta)))
        ours = tlike.log_posterior(torch.as_tensor(theta)).numpy()
        outside = np.isneginf(ref)
        rel = np.abs(ours[~outside] - ref[~outside]) / np.abs(ref[~outside])
        same_inf = bool(np.array_equal(np.isneginf(ours), outside))
        result[mode] = {"outside": int(outside.sum()), "same_-inf": same_inf, "max_rel": float(rel.max()),
                        "median_rel": float(np.median(rel)), "logp_range": [float(ref[~outside].min()),
                                                                             float(ref[~outside].max())],
                        "passed": bool(same_inf and outside.sum() == N_OUTSIDE and rel.max() <= LOGP_RTOL)}
    return result


def part_posterior(state: dict, path: Path, mode: str, n_walkers: int, n_burn: int, n_steps: int,
                   seeds: tuple[int, int]) -> tuple[dict, np.ndarray]:
    import parity_check_torch as parity

    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5
    from bayesian_inference_tpu.mcmc import runner as jrunner
    from bayesian_inference_tpu.pipeline import configs as jconfigs
    from bayesian_inference_tpu_torch.mcmc import runner as trunner
    from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

    mcmc = dict(n_walkers=n_walkers, n_burn_steps=n_burn, n_sampling_steps=n_steps)
    _, jmcmc = configs(path, jconfigs, **mcmc)
    _, tmcmc = configs(path, tconfigs, **mcmc)
    t = time.perf_counter()
    jrunner.run_mcmc(jmcmc, seed=seeds[0], mode=mode)
    jax_s = time.perf_counter() - t
    jout = read_dict_from_h5(jmcmc.mcmc_output_dir, "mcmc.h5", verbose=False)
    t = time.perf_counter()
    tout = trunner.run_mcmc(tmcmc, seed=seeds[1], device="cpu", emulation_results=state["artifacts"],
                            observables=state["tobs"], write=False, mode=mode)
    torch_s = time.perf_counter() - t
    report = parity.parity_report(
        tout["chain"], tout["acceptance_fraction"], jout["chain"], jout["acceptance_fraction"], state["lo"],
        state["hi"], reference="jax", mode=mode, dtype="float64", seed_ours=seeds[1], seed_jax=seeds[0],
        walkers=n_walkers, burn=n_burn, steps=n_steps, ours_seconds=torch_s, jax_seconds=jax_s,
    )
    passed, reasons = parity.parity_gates(report)
    return {**report, "gates_passed": passed, "gate_failures": reasons}, jout["chain"]


def part_cv(path: Path, state: dict, n_opt_iters: int, seed: int = 0) -> dict:
    import jax

    from bayesian_inference_tpu.models import cv as jcv
    from bayesian_inference_tpu.pipeline import configs as jconfigs
    from bayesian_inference_tpu_torch.models import cv as tcv
    from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

    jemu, _ = configs(path, jconfigs)
    temu, _ = configs(path, tconfigs)
    out = {}
    for name, jgroup in jemu.emulation_groups_config.items():
        tgroup = temu.emulation_groups_config[name]
        k = jgroup.cross_validation_k
        t = time.perf_counter()
        ref = jcv.cross_validate_group(jgroup, seed=seed, n_opt_iters=n_opt_iters)
        jax_s = time.perf_counter() - t
        spec = jgroup.fit_spec(n_iters=n_opt_iters)
        rand_logs = [
            np.asarray(jax.random.uniform(jax.random.key(seed + f), (jgroup.n_pc, spec.n_restarts,
                                                                       spec.theta0.shape[0]),
                                          dtype=spec.theta0.dtype, minval=spec.log_lo, maxval=spec.log_hi))
            for f in range(k)
        ]
        t = time.perf_counter()
        ours = tcv.cross_validate_group(tgroup, seed=seed, n_opt_iters=n_opt_iters, device="cpu",
                                        observables=state["tobs"], rand_logs=rand_logs)
        torch_s = time.perf_counter() - t
        if not np.array_equal(ours["fold_indices"], ref["fold_indices"]):
            raise AssertionError(f"cv {name}: the folds differ")
        zj, zt = ref["normalized_residuals"], ours["normalized_residuals"]
        dz = np.abs(zt - zj).reshape(k * zj.shape[1], -1)
        entry = {"n_pc": jgroup.n_pc, "k": k, "held_out_points": int(k * zj.shape[1]),
                 "features": int(zj.shape[-1])}
        for pkg, art in (("jax", ref), ("torch", ours)):
            z = art["normalized_residuals"]
            entry[pkg] = {"coverage_1sigma": float(np.mean(np.abs(z) < 1)),
                          "coverage_2sigma": float(np.mean(np.abs(z) < 2)), "z_mean": float(z.mean()),
                          "z_std": float(z.std()), "lml_per_fold_mean": float(np.mean(art["lml_per_fold"]))}
        entry["median_abs_dz_per_point"] = float(np.median(np.median(dz, axis=1)))
        entry["max_abs_dz"] = float(dz.max())
        entry["max_abs_dlml"] = float(np.abs(ours["lml_per_fold"] - ref["lml_per_fold"]).max())
        entry["coverage_diff"] = abs(entry["torch"]["coverage_1sigma"] - entry["jax"]["coverage_1sigma"])
        entry["seconds"] = {"jax": jax_s, "torch": torch_s}
        out[name] = entry
        print(f"cv {name}: " + json.dumps(entry), flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--restarts", type=int, default=50, help="GP fit restarts of the JAX fit (+1)")
    parser.add_argument("--cv-restarts", type=int, default=50, help="GP fit restarts per CV fold (+1)")
    parser.add_argument("--opt-iters", type=int, default=60)
    parser.add_argument("--burn", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=6000)
    parser.add_argument("--posterior-modes", nargs="+", default=["block"])
    parser.add_argument("--work-dir", default=str(REPO / "build" / "parity_torch_vs_jax"))
    args = parser.parse_args()

    setup_paths()
    os.environ.setdefault("BIQ_FIT_LML", "matmul")  # the JAX fit's blocked LML, the one the port runs
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    from bayesian_inference_tpu.io import observables as jobs
    from bayesian_inference_tpu.models import emulator as jemulator
    from bayesian_inference_tpu.pipeline import configs as jconfigs
    from bayesian_inference_tpu_torch.io import observables as tobs
    from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)
    out_path = work / "result.json"
    result = {"args": vars(args), "torch": torch.__version__, "jax": jax.__version__, "host_cpus": os.cpu_count(),
              "seconds": {}}
    t0 = time.perf_counter()
    result["tables"] = part_tables(work)
    print("tables: " + json.dumps(result["tables"]), flush=True)
    path = write_config(work, result["tables"]["table_dir"], args.restarts, N_WALKERS, args.burn, args.steps)
    ingest(path)
    result["seconds"]["tables"] = time.perf_counter() - t0

    jemu, _ = configs(path, jconfigs)
    temu, _ = configs(path, tconfigs)
    t = time.perf_counter()
    jemulator.fit_emulators(jemu, seed=0, n_opt_iters=args.opt_iters)
    result["seconds"]["fit_jax"] = time.perf_counter() - t
    artifacts = jemu.read_all_emulator_groups()
    box = jemu.analysis_config["parameterization"][jemu.parameterization]
    cv_path = write_config(work, result["tables"]["table_dir"], args.cv_restarts, N_WALKERS, args.burn,
                           args.steps, name="analysis_cv.yaml")
    state = {"jemu": jemu, "temu": temu, "artifacts": artifacts, "lo": np.asarray(box["min"], float),
             "hi": np.asarray(box["max"], float),
             "exp": jobs.data_array_from_h5(jemu.output_dir, "observables.h5",
                                            observable_filter=jemu.observable_filter),
             "tobs": tobs.read_observables(temu.output_dir, "observables.h5")}
    result["fit"] = {name: np.asarray(a["emulators"]["lml"]).tolist() for name, a in artifacts.items()}
    print(f"fit: JAX, {args.restarts} + 1 restarts, {args.opt_iters} iterations, "
          f"{result['seconds']['fit_jax']:.1f} s", flush=True)

    chains = []
    for mode in args.posterior_modes:
        t = time.perf_counter()
        result[f"posterior_{mode}"], jchain = part_posterior(state, path, mode, N_WALKERS, args.burn, args.steps,
                                                             SEEDS)
        chains.append(jchain)
        result["seconds"][f"posterior_{mode}"] = time.perf_counter() - t
        print(f"posterior {mode}: " + json.dumps(result[f"posterior_{mode}"]), flush=True)
        out_path.write_text(json.dumps(result, indent=1))
    t = time.perf_counter()
    result["logp"] = part_logp(state, chains[0] if chains else None)
    result["seconds"]["logp"] = time.perf_counter() - t
    print("logp: " + json.dumps(result["logp"]), flush=True)
    t = time.perf_counter()
    result["cv"] = part_cv(cv_path, state, args.opt_iters)
    result["seconds"]["cv"] = time.perf_counter() - t
    result["seconds"]["total"] = time.perf_counter() - t0
    out_path.write_text(json.dumps(result, indent=1))
    print(f"wrote {out_path}; {result['seconds']['total']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
