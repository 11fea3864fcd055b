"""Pipeline orchestrator + CLI of the PyTorch port (counterpart of
``bayesian_inference_tpu.pipeline.steer``).

Runs, per analysis x parameterization, the toggled stages:
initialize observables -> preprocess -> fit emulators -> cross-validation ->
MCMC -> closure tests, then the plotting suite. With ``write=True`` (the CLI)
the stages hand their results on through the same on-disk artifacts as the
JAX steer (observables.h5, observables_preprocessed.h5, emulation*.pkl,
cross_validation_<group>.h5, mcmc.h5, closure/results/<i>/mcmc.h5), so
stages can be re-run independently. With ``write=False`` each stage passes
its result to the next in memory and no ``.h5`` or ``.pkl`` artifact is
written (for machines without ``h5py``); the runners' checkpoint files are
still written.

The plots (``plots/``, host matplotlib) read the artifacts from disk, as the
JAX plots do, and their emulator predictions run on the steer's device. So a
configuration with a ``plot`` toggle on is refused before any stage runs
where matplotlib cannot be imported, or with ``write=False``.

    python -m bayesian_inference_tpu_torch.pipeline.steer -c config.yaml
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import logging
import os
import shutil
import time
from typing import Any

import torch

from bayesian_inference_tpu_torch.io import hdf5, tables
from bayesian_inference_tpu_torch.models.emulator import resolve_device
from bayesian_inference_tpu_torch.pipeline.configs import (
    EmulationConfig,
    MCMCConfig,
    PreprocessingConfig,
    load_yaml,
)
from bayesian_inference_tpu_torch.utils.helpers import setup_logging, stage_timer
from bayesian_inference_tpu_torch.utils.profiling import annotate, device_trace

logger = logging.getLogger(__name__)

RAW_OBSERVABLES = "observables.h5"
PREPROCESSED_OBSERVABLES = "observables_preprocessed.h5"


class SteerAnalysis:
    """Top-level orchestrator: one configuration, looped over analyses x parameterizations.

    Give either ``config_file`` (a YAML path) or ``config`` (the parsed
    top-level dict). Every device stage runs on ``device``.
    """

    def __init__(
        self,
        config_file: str | None = None,
        config: dict[str, Any] | None = None,
        device="cuda",
        write: bool = True,
    ):
        if (config_file is None) == (config is None):
            raise ValueError("SteerAnalysis takes exactly one of config_file and config")
        self.config_file = config_file or ""
        self.config = load_yaml(config_file) if config is None else config
        self.device = resolve_device(device)
        self.write = write
        config = self.config
        self.output_dir = config["output_dir"]
        self.observable_table_dir = config["observable_table_dir"]
        self.observable_config_dir = config["observable_config_dir"]

        self.initialize_observables = config["initialize_observables"]
        self.preprocess_input_data = config["preprocess_input_data"]
        self.fit_emulators = config["fit_emulators"]
        self.run_mcmc = config["run_mcmc"]
        self.run_closure_tests = config["run_closure_tests"]
        self.plot = config["plot"]
        self.analyses = config["analyses"]
        on = sorted(k for k, v in self.plot.items() if v)
        if on and importlib.util.find_spec("matplotlib") is None:
            raise RuntimeError(
                f"plot toggles {on} are on, but matplotlib cannot be imported here; run the plots on a host that "
                "has it, from the artifacts, or set the toggles to False"
            )
        if on and not write:
            raise ValueError(
                f"plot toggles {on} are on with write=False, but the plots read the artifacts from disk; "
                "run with write=True or set the toggles to False"
            )
        if write:
            os.makedirs(self.output_dir, exist_ok=True)

    def _configs(self, cls, analysis_name: str, parameterization: str, analysis_config: dict[str, Any], **kw):
        return cls(analysis_name=analysis_name, parameterization=parameterization, analysis_config=analysis_config,
                   config_file=self.config_file, config=self.config, **kw)

    # ------------------------------------------------------------------
    def run_analysis(self) -> dict[str, dict[str, Any]]:
        """Run every analysis x parameterization, then the toggled plots;
        returns {"<analysis>_<parameterization>": the stage results of that
        run (see ``_run_single``)}."""
        handler = None
        if self.write:
            handler = logging.FileHandler(os.path.join(self.output_dir, "steer_analysis.log"), "w")
            logging.getLogger().addHandler(handler)
            copy = os.path.join(self.output_dir, "steer_analysis_config.yaml")
            if self.config_file:
                shutil.copy(self.config_file, copy)
            else:
                import yaml

                with open(copy, "w") as f:
                    yaml.safe_dump(self.config, f)
        try:
            results = {
                f"{analysis_name}_{parameterization}": self._run_single(analysis_name, parameterization, ac)
                for analysis_name, ac in self.analyses.items()
                for parameterization in ac["parameterizations"]
            }
            self._run_plots()
            return results
        finally:
            if handler is not None:
                logging.getLogger().removeHandler(handler)
                handler.close()

    @contextlib.contextmanager
    def _stage(self, timings: dict[str, float], stage: str, tag: str, suffix: str = ""):
        """Time a stage (log line, trace region) into ``timings[stage]``."""
        name = f"{stage}[{tag}]{suffix}"
        t0 = time.perf_counter()
        with stage_timer(name, logger), annotate(name):
            yield
        timings[stage] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _run_single(self, analysis_name: str, parameterization: str, analysis_config: dict[str, Any]) -> dict[str, Any]:
        """One run's stages. Returns what each stage that ran produced
        (``observables``, ``preprocessed``, ``emulation``, ``cross_validation``,
        ``mcmc``, ``closure``) and each stage's wall seconds (``timings``)."""
        run_dir = os.path.join(self.output_dir, f"{analysis_name}_{parameterization}")
        tag = f"{analysis_name}/{parameterization}"
        args = (analysis_name, parameterization, analysis_config)
        timings: dict[str, float] = {}
        result: dict[str, Any] = {"timings": timings}
        # In memory (write=False): observables by file name, as the stages
        # would otherwise read them from the run directory.
        in_memory: dict[str, dict[str, Any]] = {}

        if self.initialize_observables:
            with self._stage(timings, "initialize", tag):
                observables = tables.initialize_observables_dict_from_tables(
                    self.observable_table_dir, analysis_config, parameterization
                )
                if self.write:
                    hdf5.write_dict_to_h5(observables, run_dir, filename=RAW_OBSERVABLES)
                else:
                    in_memory[RAW_OBSERVABLES] = observables
                result["observables"] = observables

        if not self.initialize_observables and not os.path.exists(os.path.join(run_dir, RAW_OBSERVABLES)):
            # Convenience for pre-aggregated observables: stage an existing
            # observables.h5 from the observable_config_dir.
            staged = os.path.join(self.observable_config_dir, RAW_OBSERVABLES)
            if os.path.exists(staged):
                os.makedirs(run_dir, exist_ok=True)
                shutil.copy(staged, os.path.join(run_dir, RAW_OBSERVABLES))
                logger.info(f"Staged pre-aggregated observables.h5 from {staged}")

        if self.preprocess_input_data:
            with self._stage(timings, "preprocess", tag):
                from bayesian_inference_tpu_torch.preprocess import preprocess

                smoothed = preprocess(self._configs(PreprocessingConfig, *args), in_memory.get(RAW_OBSERVABLES))
                if self.write:
                    hdf5.write_dict_to_h5(smoothed, run_dir, filename=PREPROCESSED_OBSERVABLES)
                else:
                    in_memory[PREPROCESSED_OBSERVABLES] = smoothed
                result["preprocessed"] = smoothed

        # The observables the later stages use: the configured file, or the
        # raw one where that file was never produced (as the runners fall back).
        filename = self.config["observables_filename"]
        observables = in_memory.get(filename, in_memory.get(RAW_OBSERVABLES))
        emulation_results = None

        if self.fit_emulators:
            with self._stage(timings, "fit_emulators", tag):
                from bayesian_inference_tpu_torch.models import emulator

                emulation_config = EmulationConfig.from_config_file(
                    *args, config_file=self.config_file, config=self.config
                )
                fitted = emulator.fit_emulators(emulation_config, device=self.device, observables=observables,
                                                write=self.write)
                result["emulation"] = fitted
                if not self.write:
                    emulation_results = _every_group(emulation_config, fitted)

            if any(g.cross_validation for g in emulation_config.emulation_groups_config.values()):
                with self._stage(timings, "cross_validation", tag):
                    from bayesian_inference_tpu_torch.models.cv import cross_validate

                    result["cross_validation"] = cross_validate(
                        emulation_config, device=self.device, observables=observables, write=self.write
                    )

        if self.run_mcmc:
            with self._stage(timings, "mcmc", tag):
                from bayesian_inference_tpu_torch.mcmc.runner import run_mcmc

                mcmc_config = self._configs(MCMCConfig, *args)
                # run_mcmc builds its sampler programs (mcmc/programs.py) from
                # the likelihood it builds, sized for this cadence.
                result["mcmc"] = run_mcmc(
                    mcmc_config, device=self.device, emulation_results=emulation_results, observables=observables,
                    write=self.write, checkpoint_every=mcmc_config.checkpoint_every,
                )

        if self.run_closure_tests:
            n_points = analysis_config["validation_indices"][1] - analysis_config["validation_indices"][0]
            with self._stage(timings, "closure", tag, f" x{n_points}"):
                from bayesian_inference_tpu_torch.mcmc.runner import run_closure_batch

                mcmc_config = self._configs(MCMCConfig, *args)
                # All validation points in one batch, checkpointed every
                # quarter of production for resume.
                result["closure"] = run_closure_batch(
                    mcmc_config, range(n_points), device=self.device,
                    emulation_results=emulation_results, observables=observables, write=self.write,
                    checkpoint_every=max(1, mcmc_config.n_sampling_steps // 4), return_chains=False,
                )
        return result

    # ------------------------------------------------------------------
    def _run_plots(self) -> None:
        """The toggled plots of every analysis x parameterization, from the
        artifacts on disk; their emulator predictions run on the steer's device."""
        if not any(self.plot.values()):
            return
        from bayesian_inference_tpu_torch import plots

        with stage_timer("plots", logger), annotate("plots"):
            for analysis_name, analysis_config in self.analyses.items():
                for parameterization in analysis_config["parameterizations"]:
                    args = (analysis_name, parameterization, analysis_config)
                    emulation_config = EmulationConfig.from_config_file(
                        *args, config_file=self.config_file, config=self.config
                    )
                    mcmc_config = self._configs(MCMCConfig, *args)
                    if self.plot.get("input_data"):
                        plots.input_data.plot(emulation_config)
                    if self.plot.get("emulators"):
                        plots.emulation.plot(emulation_config, device=self.device)
                    if self.plot.get("mcmc"):
                        plots.mcmc.plot(mcmc_config, device=self.device)
                    if self.plot.get("qhat"):
                        plots.qhat.plot(mcmc_config, device=self.device)
                    if self.plot.get("closure_tests"):
                        plots.closure.plot(mcmc_config)

            if self.plot.get("across_analyses"):
                plots.analyses.plot(self.analyses, self.config_file, self.output_dir, config=self.config)


def _every_group(emulation_config: EmulationConfig, fitted: dict[str, dict[str, Any]]) -> dict[str, dict[str, Any]]:
    """Every group's artifact, in memory: those fitted in this run, and those
    ``fit_emulators`` skipped because their pickle already exists, read from
    it. Raises ValueError for a group that is neither."""
    from bayesian_inference_tpu_torch.models.emulator import read_emulators

    out = {}
    for name, group_config in emulation_config.emulation_groups_config.items():
        if name in fitted:
            out[name] = fitted[name]
        elif os.path.exists(group_config.emulation_outputfile):
            out[name] = read_emulators(group_config)
        else:
            raise ValueError(
                f"emulation group {name!r} was not fitted in this run and has no {group_config.emulation_outputfile}"
            )
    return out


def main(argv: list[str] | None = None) -> None:
    setup_logging(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Jet Bayesian analysis on PyTorch (+ CUDA)")
    parser.add_argument(
        "-c", "--configFile", action="store", type=str, required=True,
        help="Path of YAML config file for the analysis",
    )
    parser.add_argument(
        "--profile", type=str, default=None, metavar="TRACE_DIR",
        help="Write a torch.profiler trace of the run to TRACE_DIR/trace.json and the device's idle gaps by "
        "program span to TRACE_DIR/idle_by_span.json",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device of every stage: 'cuda' (default; needs a CUDA card) or 'cpu'",
    )
    parser.add_argument(
        "--x64", action="store_true",
        help="Run in float64, as the JAX steer's --x64 does; the port's float64 device is the CPU "
        "(its CUDA kernels take float32), so this needs --device cpu",
    )
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch finds no CUDA device; pass --device cpu to run on the CPU")
    if args.x64 and device.type != "cpu":
        raise ValueError("--x64 runs in float64, which the port runs on the CPU only; pass --device cpu")
    if not os.path.exists(args.configFile):
        raise ValueError(f"File {args.configFile} does not exist!")

    with device_trace(args.profile):
        SteerAnalysis(config_file=args.configFile, device=device).run_analysis()


if __name__ == "__main__":
    main()
