"""The system under test: the port's entry points as a user calls them, and
its counters. The only module of the harness that imports the port.

The configuration dict is built in memory from the cell's configuration
file (the schema of ``config/*.yaml``); the tables are ingested by the port's
``io/tables``; the runners are called with ``write=False``, so nothing of the
analysis goes to disk.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from bayesian_inference_tpu_torch.io.tables import initialize_observables_dict_from_tables
from bayesian_inference_tpu_torch.mcmc import programs as programs_mod
from bayesian_inference_tpu_torch.mcmc import stats
from bayesian_inference_tpu_torch.mcmc import runner
from bayesian_inference_tpu_torch.mcmc.runner import run_closure_batch, run_mcmc
from bayesian_inference_tpu_torch.models import gp_fit
from bayesian_inference_tpu_torch.models.emulator import fit_emulators
from bayesian_inference_tpu_torch.ops import _native
from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig, MCMCConfig

ANALYSIS = "bench"


def config_dict(cfg: dict, traffic: dict, table_dir: str, work_dir: str) -> dict:
    """The top-level configuration of one analysis, as ``config/*.yaml`` has it."""
    k = cfg["kernel"]
    emulators = {
        name: {
            "force_retrain": True,
            "n_pc": g["n_pc"],
            "max_n_components_to_calculate": cfg["max_n_components_to_calculate"],
            "kernels": {
                "active": list(k["active"]),
                "matern": {"nu": k["nu"], "length_scale_bounds_factor": list(k["length_scale_bounds_factor"])},
                "noise": {"type": "white", "args": {"noise_level": k["noise_level"],
                                                    "noise_level_bounds": list(k["noise_level_bounds"])}},
            },
            "GPR": {"n_restarts": cfg["n_restarts"], "alpha": cfg["alpha"]},
            "observable_list": list(g["observable_list"]),
            **({"observable_exclude_list": list(g["observable_exclude_list"])}
               if g.get("observable_exclude_list") else {}),
        }
        for name, g in cfg["emulators"].items()
    }
    analysis = {
        "parameterizations": [cfg["parameterization"]],
        "sqrts_list": list(cfg["sqrts_list"]),
        "centrality_range": list(cfg["centrality_range"]),
        "parameterization": {cfg["parameterization"]: {"names": list(cfg["parameter_names"]),
                                                       "min": list(cfg["prior_min"]), "max": list(cfg["prior_max"])}},
        "validation_indices": list(cfg["validation_indices"]),
        "design_points_to_exclude": list(cfg["design_points_to_exclude"]),
        **({"cuts": {key: list(rng) for key, rng in cfg["cuts"].items()}} if cfg.get("cuts") else {}),
        "parameters": {
            "emulators": emulators,
            "mcmc": {
                "n_walkers": cfg["n_walkers"],
                "n_burn_steps": traffic.get("n_burn_steps", 1000),
                "n_sampling_steps": traffic.get("n_sampling_steps", 5000),
                "n_logging_steps": traffic.get("n_logging_steps", 0),
                "likelihood_mode": cfg["likelihood_mode"],
            },
        },
    }
    return {
        "output_dir": work_dir,
        "initialize_observables": True,
        "preprocess_input_data": False,
        "fit_emulators": True,
        "run_mcmc": traffic["unit"] == "analysis",
        "run_closure_tests": traffic["unit"] == "closure",
        "plot": {},
        "observable_table_dir": table_dir,
        "observable_config_dir": work_dir,
        "observables_filename": "observables.h5",
        "analyses": {ANALYSIS: analysis},
    }


def with_steps(config: dict, n_burn: int, n_steps: int) -> dict:
    config = copy.deepcopy(config)
    mcmc = config["analyses"][ANALYSIS]["parameters"]["mcmc"]
    mcmc["n_burn_steps"], mcmc["n_sampling_steps"] = n_burn, n_steps
    return config


def configs(config: dict, parameterization: str) -> tuple[EmulationConfig, MCMCConfig]:
    analysis = config["analyses"][ANALYSIS]
    emu = EmulationConfig.from_config_file(ANALYSIS, parameterization, analysis, config=config)
    return emu, MCMCConfig(ANALYSIS, parameterization, analysis, config=config)


def ingest(config: dict, parameterization: str) -> dict:
    return initialize_observables_dict_from_tables(config["observable_table_dir"], config["analyses"][ANALYSIS],
                                                  parameterization)


def fit(emu: EmulationConfig, observables: dict, seed: int, opt_iters: int, device) -> dict:
    return fit_emulators(emu, seed=seed, n_opt_iters=opt_iters, device=device, observables=observables, write=False)


def analysis(mcmc: MCMCConfig, artifacts: dict, observables: dict, seed: int, device, programs, draws=None) -> dict:
    return run_mcmc(mcmc, seed=seed, device=device, emulation_results=artifacts, observables=observables,
                    write=False, programs=programs, draws=draws)


def closure(mcmc: MCMCConfig, indices, artifacts: dict, observables: dict, seed: int, device, programs,
            draws=None) -> dict:
    return run_closure_batch(mcmc, indices, seed=seed, device=device, emulation_results=artifacts,
                             observables=observables, write=False, return_chains=True, programs=programs,
                             draws=draws)


def prewarm(mcmc: MCMCConfig, observables: dict, device, n_points: int | None = None):
    return programs_mod.prewarm_sampler_programs(mcmc, device=device, observables=observables, n_points=n_points)


def closure_chunks(mcmc: MCMCConfig, n_points: int, n_walkers: int, ndim: int) -> list[int]:
    """The production chunks the closure batch dispatches (its default chunking)."""
    n = mcmc.n_sampling_steps
    chunk = runner._closure_dispatch_chunk(n, n_points, n_walkers, ndim, 4, None, None)
    return runner._chunk_sizes(n, 0, chunk)


def warm_statistics(shapes: list[tuple[int, ...]], n_points: int | None, device) -> None:
    """The device chain statistics at the chain's shapes: a list of slabs of
    (n, W, d), or with ``n_points`` of (n, P, W, d)."""
    if torch.device(device).type != "cuda":
        return
    gen = torch.Generator(device=device).manual_seed(0)
    slabs = [torch.randn(s, generator=gen, dtype=torch.float32, device=device) for s in shapes]
    if n_points is None:
        power = stats.device_mean_power(slabs)
        stats.device_split_rhat(slabs)
        stats.integrated_time(torch.cat(slabs).cpu().numpy(), mean_power=power)
    else:
        powers, nfft, _ = stats.device_closure_stats(slabs)
        stats.integrated_time_from_power(powers[0], nfft, sum(s[0] for s in shapes))
    torch.cuda.synchronize(device)


def counters() -> dict[str, int]:
    """Kernel launches by kernel (counted through graph replays) and programs built."""
    out = {f"launches.{k.source.stem}": k.launches for k in _native.KERNELS}
    for k in _native.KERNELS:
        for batch, n in k.launches_by_batch.items():
            out[f"launches.{k.source.stem}.B{batch}"] = n
    out["built.fit"] = gp_fit.fit_program_stats()["built"]
    out["built.sampler"] = programs_mod.sampler_program_stats()["built"]
    return out


def fitted_params(artifacts: dict) -> dict[str, dict[str, np.ndarray]]:
    """The fitted hyperparameters and log marginal likelihoods, per group: the
    fit's outputs, which the reference judges."""
    return {name: {"log_length_scale": np.asarray(a["emulators"]["params"]["log_length_scale"], np.float64),
                   "log_noise": np.asarray(a["emulators"]["params"]["log_noise"], np.float64),
                   "lml": np.asarray(a["emulators"]["lml"], np.float64)}
            for name, a in artifacts.items()}
