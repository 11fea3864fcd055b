"""Per-stage configuration classes over the reference YAML schema (host code,
carried over from ``bayesian_inference_tpu.pipeline.configs``).

Each class takes either ``config_file`` (a YAML path, read with ``yaml`` at
construction) or ``config``, the already-parsed top-level dict, so callers on
machines without ``yaml`` can build the configuration in memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from bayesian_inference_tpu_torch.io.observables import ObservableFilter
from bayesian_inference_tpu_torch.ops.gram import KernelConfig


def load_yaml(path: str | Path) -> dict[str, Any]:
    import yaml

    with open(path) as stream:
        return yaml.safe_load(stream)


def _top_level(config: dict[str, Any] | None, config_file: str) -> dict[str, Any]:
    return load_yaml(config_file) if config is None else config


def _run_dir(config: dict[str, Any], analysis_name: str, parameterization: str) -> str:
    return os.path.join(config["output_dir"], f"{analysis_name}_{parameterization}")


@dataclass
class EmulationGroupConfig:
    """Settings for one emulation group (one PCA + GP stack over an observable subset)."""

    analysis_name: str
    parameterization: str
    analysis_config: dict[str, Any]
    config_file: str = ""
    group_name: str | None = None
    config: dict[str, Any] | None = None

    def __post_init__(self) -> None:
        self.config = _top_level(self.config, self.config_file)
        self.observable_table_dir = self.config["observable_table_dir"]
        self.observables_filename = self.config["observables_filename"]

        emulators_cfg = self.analysis_config["parameters"]["emulators"]
        group_cfg = emulators_cfg if self.group_name is None else emulators_cfg[self.group_name]

        self.force_retrain = group_cfg["force_retrain"]
        self.n_pc = group_cfg["n_pc"]
        self.max_n_components_to_calculate = group_cfg.get("max_n_components_to_calculate", None)

        self.active_kernels = {k: group_cfg["kernels"][k] for k in group_cfg["kernels"]["active"]}
        base = [k for k in ("matern", "rbf") if k in self.active_kernels]
        if len(base) != 1:
            raise ValueError("Must provide exactly one of 'matern', 'rbf' kernel")
        if "noise" in self.active_kernels:
            noise = self.active_kernels["noise"]
            if noise.get("type") != "white" or set(noise["args"]) != {"noise_level", "noise_level_bounds"}:
                raise ValueError(f"Unsupported noise kernel {noise}")

        self.n_restarts = group_cfg["GPR"]["n_restarts"]
        self.alpha = group_cfg["GPR"]["alpha"]

        include = group_cfg.get("observable_list", [])
        exclude = group_cfg.get("observable_exclude_list", [])
        self.observable_filter = (
            ObservableFilter(include_list=include, exclude_list=exclude)
            if (include or exclude)
            else None
        )

        self.output_dir = _run_dir(self.config, self.analysis_name, self.parameterization)
        name = "emulation.pkl" if self.group_name is None else f"emulation_group_{self.group_name}.pkl"
        self.emulation_outputfile = os.path.join(self.output_dir, name)

    def kernel_config(self) -> KernelConfig:
        nu = self.active_kernels["matern"]["nu"] if "matern" in self.active_kernels else None
        return KernelConfig(
            nu=nu,
            with_noise="noise" in self.active_kernels,
            with_constant="constant" in self.active_kernels,
        )

    def parameter_bounds(self) -> tuple[list[float], list[float]]:
        p = self.analysis_config["parameterization"][self.parameterization]
        return p["min"], p["max"]

    def fit_spec(self, n_iters: int = 100):
        """The port's GPFitSpec for this group (reference kernel initialisation)."""
        from bayesian_inference_tpu_torch.models.gp_fit import spec_from_reference_config

        pmin, pmax = self.parameter_bounds()
        base_key = "matern" if "matern" in self.active_kernels else "rbf"
        kwargs: dict[str, Any] = {
            "length_scale_bounds_factor": tuple(self.active_kernels[base_key]["length_scale_bounds_factor"]),
        }
        if "noise" in self.active_kernels:
            kwargs["noise_level"] = self.active_kernels["noise"]["args"]["noise_level"]
            kwargs["noise_level_bounds"] = tuple(self.active_kernels["noise"]["args"]["noise_level_bounds"])
        if "constant" in self.active_kernels:
            kwargs["constant_value"] = self.active_kernels["constant"]["constant_value"]
            kwargs["constant_value_bounds"] = tuple(self.active_kernels["constant"]["constant_value_bounds"])
        return spec_from_reference_config(
            self.kernel_config(),
            param_min=pmin,
            param_max=pmax,
            n_restarts=self.n_restarts,
            n_iters=n_iters,
            alpha_jitter=self.alpha,
            **kwargs,
        )


@dataclass
class EmulationConfig:
    """All emulation groups of one analysis x parameterization."""

    analysis_name: str
    parameterization: str
    analysis_config: dict[str, Any]
    config_file: str = ""
    config: dict[str, Any] | None = None
    emulation_groups_config: dict[str, EmulationGroupConfig] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.config = _top_level(self.config, self.config_file)
        self.observable_table_dir = self.config["observable_table_dir"]
        self.observables_filename = self.config["observables_filename"]
        self.output_dir = _run_dir(self.config, self.analysis_name, self.parameterization)
        self._observable_filter: ObservableFilter | None = None

    @classmethod
    def from_config_file(
        cls,
        analysis_name: str,
        parameterization: str,
        analysis_config: dict[str, Any],
        config_file: str = "",
        config: dict[str, Any] | None = None,
    ) -> "EmulationConfig":
        """One group config per ``parameters.emulators`` entry. Pass either the
        YAML path or the parsed top-level ``config`` dict."""
        c = cls(
            analysis_name=analysis_name,
            parameterization=parameterization,
            analysis_config=analysis_config,
            config_file=str(config_file),
            config=config,
        )
        c.emulation_groups_config = {
            name: EmulationGroupConfig(
                analysis_name=analysis_name,
                parameterization=parameterization,
                analysis_config=analysis_config,
                config_file=str(config_file),
                group_name=name,
                config=c.config,
            )
            for name in analysis_config["parameters"]["emulators"]
        }
        return c

    @property
    def observable_filter(self) -> ObservableFilter:
        """Merged include/exclude over all groups + the global exclude list."""
        if self._observable_filter is None:
            include: list[str] = []
            exclude: list[str] = list(self.config.get("global_observable_exclude_list", []))
            for g in self.emulation_groups_config.values():
                if g.observable_filter is not None:
                    include.extend(g.observable_filter.include_list)
                    exclude.extend(g.observable_filter.exclude_list)
            self._observable_filter = ObservableFilter(include_list=include, exclude_list=exclude)
        return self._observable_filter

    def read_all_emulator_groups(self) -> dict[str, dict[str, Any]]:
        from bayesian_inference_tpu_torch.models.emulator import read_emulators

        return {name: read_emulators(cfg) for name, cfg in self.emulation_groups_config.items()}


@dataclass
class MCMCConfig:
    analysis_name: str
    parameterization: str
    analysis_config: dict[str, Any]
    config_file: str = ""
    closure_index: int = -1
    config: dict[str, Any] | None = None

    def __post_init__(self) -> None:
        self.config = _top_level(self.config, self.config_file)
        self.observable_table_dir = self.config["observable_table_dir"]
        self.observables_filename = self.config["observables_filename"]

        mcmc = self.analysis_config["parameters"]["mcmc"]
        self.n_walkers = mcmc["n_walkers"]
        self.n_burn_steps = mcmc["n_burn_steps"]
        self.n_sampling_steps = mcmc["n_sampling_steps"]
        self.n_logging_steps = mcmc["n_logging_steps"]
        # Parsed for schema compatibility. The port's runner has no
        # checkpointed production and moves every chain losslessly, so it
        # reads neither value.
        self.checkpoint_every = int(mcmc.get("checkpoint_every", 0) or 0) or None
        self.chain_transfer = str(mcmc.get("chain_transfer", "") or "").lower()
        # 'block' = per-observable covariance blocks (reference parity);
        # 'lowrank' = full cross-observable covariance (not ported yet)
        self.likelihood_mode = mcmc.get("likelihood_mode", "block")

        conf = self.analysis_config["parameters"].get("closure", {}).get("confidence", 0.9)
        self.confidence = float(conf[0] if isinstance(conf, (list, tuple)) else conf)

        self.output_dir = _run_dir(self.config, self.analysis_name, self.parameterization)
        if self.closure_index < 0:
            self.mcmc_output_dir = self.output_dir
        else:
            self.mcmc_output_dir = os.path.join(self.output_dir, f"closure/results/{self.closure_index}")
        self.mcmc_outputfile = os.path.join(self.mcmc_output_dir, "mcmc.h5")
        self.sampler_outputfile = os.path.join(self.mcmc_output_dir, "mcmc_sampler.pkl")

    def parameterization_spec(self) -> dict[str, Any]:
        return self.analysis_config["parameterization"][self.parameterization]
