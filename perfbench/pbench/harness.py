"""One run of one cell: set-up, the measured window of whole units, the
trace (with ``--trace 1``), the comparison that decides ``correct``, and the
result line.

A unit is one job a user runs, of fixed size, back to back in a closed loop:
an analysis (``fit_emulators`` -> ``run_mcmc``), a closure batch
(``run_closure_batch`` over the validation points, on the emulators fitted in
set-up) or a refit (``fit_emulators``). A unit starts only while the window's
elapsed time is under ``seconds``; the last one started finishes. Each unit
takes its own seed, derived from the run's. The first sampler unit draws its
random numbers from the benchmark (its ``draws=``), so that the reference can
judge each accept decision; the others draw them from the program's own
generator, as a user's run does. Every unit is checked: its fit, its
log-posteriors, the geometry of its moves and its statistics.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pbench import cell as cell_mod
from pbench import check as check_mod
from pbench import draws as draws_mod
from pbench import flops as flops_mod
from pbench import peaks, program, shapes as shapes_mod, tables
from pbench.trace import Spans, kernel_time, run_traced
from reference import data as ref_data

FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_inference_tpu")
PSEUDODATA_SEED_OFFSET = 12345  # the closure batch's documented pseudodata seed: default_rng(seed + i + 12345)


def seed_of(seed: int, *path: int) -> int:
    """A 31-bit seed for a part of the run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *path]).generate_state(1)[0] >> 1)


def process_age_s() -> float | None:
    """Seconds since this process started (from /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def drain(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    def __init__(self, cell: cell_mod.Cell, seed: int, seconds: float, trace: bool, device="cuda",
                 t_start: float | None = None, work_dir: Path | None = None):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.work_dir = work_dir or Path(tempfile.gettempdir()) / "perfbench" / cell.name / str(self.seed)
        self.spans = Spans()
        self.units: list[dict] = []
        self.kept: list[dict] = []
        cfg, tr = cell.config, cell.traffic
        self.n_burn, self.n_steps = int(tr.get("n_burn_steps", 0)), int(tr.get("n_sampling_steps", 0))

    # -- set-up -----------------------------------------------------------------------------------

    def _part(self, name: str) -> None:
        """Close the set-up part that ran since the last call, under ``name``."""
        drain(self.device)
        now = time.perf_counter()
        self.setup_parts[name] = now - self._part_t
        self._part_t = now

    def setup(self) -> None:
        cfg, tr = self.cell.config, self.cell.traffic
        self.setup_parts, self._part_t = {}, time.perf_counter()
        shutil.rmtree(self.work_dir, ignore_errors=True)
        table_dir = self.work_dir / "tables"
        tables.make_production_tables(table_dir, parameterization=cfg["parameterization"],
                                      n_design=int(cfg["tables"]["n_design"]), seed=seed_of(self.seed, 1))
        self.config = program.config_dict(cfg, tr, str(table_dir), str(self.work_dir / "output"))
        self.emu, self.mcmc = program.configs(self.config, cfg["parameterization"])
        self.observables = program.ingest(self.config, cfg["parameterization"])
        self.data = ref_data.read(str(table_dir), cfg)
        self.shapes = shapes_mod.of(cfg, tr, self.data)
        self.indices = list(range(self.shapes.points))
        self._part("tables_and_ingest")
        opt_iters = int(cfg["opt_iters"])
        self.programs = None
        if self.cell.unit == "analysis":
            self.programs = program.prewarm(self.mcmc, self.observables, self.device)
            self._part("sampler_programs")
            art = program.fit(self.emu, self.observables, seed_of(self.seed, 2), opt_iters, self.device)
            warm = tr["warmup"]
            _, mcmc_w = program.configs(program.with_steps(self.config, warm["n_burn_steps"],
                                                           warm["n_sampling_steps"]), cfg["parameterization"])
            program.analysis(mcmc_w, art, self.observables, seed_of(self.seed, 3), self.device, self.programs)
            W, d = self.shapes.walkers, self.shapes.ndim
            program.warm_statistics([(self.n_steps, W, d)], None, self.device)
        elif self.cell.unit == "closure":
            self.programs = program.prewarm(self.mcmc, self.observables, self.device, n_points=self.shapes.points)
            self._part("sampler_programs")
            self.artifacts = program.fit(self.emu, self.observables, seed_of(self.seed, 2), opt_iters, self.device)
            self.kept.append({"index": -1, "params": program.fitted_params(self.artifacts), "fit_only": True})
            warm = tr["warmup"]
            _, mcmc_w = program.configs(program.with_steps(self.config, warm["n_burn_steps"],
                                                           warm["n_sampling_steps"]), cfg["parameterization"])
            program.closure(mcmc_w, self.indices, self.artifacts, self.observables, seed_of(self.seed, 3),
                            self.device, self.programs)
            W, d, P = self.shapes.walkers, self.shapes.ndim, self.shapes.points
            sizes = program.closure_chunks(self.mcmc, P, W, d)
            program.warm_statistics([(n, P, W, d) for n in sizes], P, self.device)
        else:
            program.fit(self.emu, self.observables, seed_of(self.seed, 2), opt_iters, self.device)
        self._part("warm_up")
        self.draws = {}
        if self.cell.unit in ("analysis", "closure"):
            n_points = None if self.cell.unit == "analysis" else self.shapes.points
            self.draws[0] = draws_mod.make(seed_of(self.seed, 4, 0), self.n_burn, self.n_steps, self.shapes.walkers,
                                           cfg["prior_min"], cfg["prior_max"], n_points, self.device)
        self._part("draws")
        self.counters0 = program.counters()

    # -- units ------------------------------------------------------------------------------------

    def unit(self, i: int) -> None:
        seed = seed_of(self.seed, 5, i)
        draws = self.draws.pop(i, None)
        rec: dict = {"index": i, "seed": seed, "injected": draws is not None}
        opt_iters = int(self.cell.config["opt_iters"])
        t0 = time.perf_counter()
        if self.cell.unit == "analysis":
            with self.spans.span(f"unit{i}.fit_emulators"):
                art = program.fit(self.emu, self.observables, seed, opt_iters, self.device)
                drain(self.device)
            t1 = time.perf_counter()
            with self.spans.span(f"unit{i}.run_mcmc"):
                out = program.analysis(self.mcmc, art, self.observables, seed, self.device, self.programs, draws)
                drain(self.device)
            rec.update(fit_s=t1 - t0, phases=dict(out["timings"]))
            self.kept.append({"index": i, "params": program.fitted_params(art), "ensembles": [{
                "chain": out["chain"], "log_prob": out["log_prob"],
                "draws": None if draws is None else draws["production"],
                "tau": out.get("autocorrelation_time"), "rhat": out["split_rhat"]}]})
        elif self.cell.unit == "closure":
            with self.spans.span(f"unit{i}.run_closure_batch"):
                out = program.closure(self.mcmc, self.indices, self.artifacts, self.observables, seed, self.device,
                                      self.programs, draws)
                drain(self.device)
            rec.update(phases=dict(out[self.indices[0]]["timings"]))
            self.kept.append(self._closure_kept(i, seed, out, draws))
        else:
            with self.spans.span(f"unit{i}.fit_emulators"):
                art = program.fit(self.emu, self.observables, seed, opt_iters, self.device)
                drain(self.device)
            rec.update(fit_s=time.perf_counter() - t0)
            self.kept.append({"index": i, "params": program.fitted_params(art)})
        rec["unit_s"] = time.perf_counter() - t0
        self.units.append(rec)

    def _closure_kept(self, i: int, seed: int, out: dict, draws: dict | None) -> dict:
        n_check = min(int(self.cell.limits["check_points"]), len(self.indices))
        rng = np.random.default_rng([self.seed, i, 11])
        sample = sorted(rng.choice(self.indices, size=n_check, replace=False).tolist())
        prod = None if draws is None else draws["production"]
        ensembles = [{
            "chain": out[p]["chain"], "log_prob": out[p]["log_prob"], "point": p,
            "pseudodata_seed": seed + p + PSEUDODATA_SEED_OFFSET,
            "draws": None if prod is None else {k: v[:, p] for k, v in prod.items()},
            "tau": out[p]["autocorrelation_time"], "rhat": out[p]["split_rhat"],
        } for p in sample]
        finals = [{"point": p, "pseudodata_seed": seed + p + PSEUDODATA_SEED_OFFSET,
                   "coords": out[p]["final_coords"], "log_prob": out[p]["final_log_prob"]} for p in self.indices]
        return {"index": i, "params": program.fitted_params(self.artifacts), "ensembles": ensembles,
                "finals": finals}

    # -- the window -------------------------------------------------------------------------------

    def window(self) -> None:
        t0 = time.perf_counter()
        i = 0
        while self.starts(i, time.perf_counter() - t0):
            self.unit(i)
            if i == 0:
                drain(self.device)
                self.counters_first = {k: v - self.counters0.get(k, 0) for k, v in program.counters().items()}
                self.first_done.set()
                self.resume.wait()
            i += 1
        self.window_s = time.perf_counter() - t0

    def starts(self, i: int, elapsed: float) -> bool:
        """Whether unit ``i`` starts: while the window's elapsed time is under ``seconds``."""
        return elapsed < self.seconds

    def measure(self) -> None:
        self.setup()
        age = process_age_s()
        self.setup_s = age if age is not None else time.perf_counter() - self.t_start
        self.trace_summary = None
        self.first_done, self.resume = threading.Event(), threading.Event()
        if self.trace and self.device.type == "cuda":
            tracer, whole = run_traced(self.window, float(self.cell.traffic["trace_seconds"]), self.first_done,
                                       self.resume)
            self.trace_summary = tracer.summary(self.spans, whole)
            self.trace_summary.update(whole_units=whole, counters=self.counters_first if whole else {})
        else:
            self.resume.set()
            self.window()
        drain(self.device)
        self.memory_peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    # -- metrics ----------------------------------------------------------------------------------

    def end_to_end(self) -> dict[str, dict]:
        n = len(self.units)
        values = {"setup_s": self.setup_s}
        if self.cell.unit == "analysis":
            values["analysis_s"] = self.window_s / n
        elif self.cell.unit == "closure":
            values["closure_point_steps_per_s"] = n * self.shapes.points * (self.n_burn + self.n_steps) / self.window_s
        else:
            values["fit_s"] = self.window_s / n
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in self.cell.end_to_end
                if m["name"] in values}

    def context(self) -> dict:
        # The profiler slows the unit it traces (and the rest of it, while the
        # trace is collected): the host-clock readers take the other units
        # where there are any.
        units = self.units[1:] if self.trace_summary is not None and len(self.units) > 1 else self.units
        return {"cell": self.cell, "units": units, "window_s": self.window_s, "trace": self.trace_summary,
                "shapes": self.shapes, "n_burn": self.n_burn, "n_steps": self.n_steps,
                "step_flops": flops_mod.step_flops(self.shapes), "fit_flops": flops_mod.fit_flops(self.shapes),
                "peaks": peaks, "kernel_time": kernel_time, "roofline": cell_mod.roofline}

    def per_layer(self) -> dict[str, dict]:
        ctx, out = self.context(), {}
        for m in self.cell.per_layer:
            value = cell_mod.metric_reader(m["name"]).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    def cleanup(self) -> None:
        shutil.rmtree(self.work_dir, ignore_errors=True)


def result(run: Run, metrics: dict, device: dict, card: str) -> dict:
    """The result line: the comparison runs here, after the window, with the
    program's state freed and the peak memory read."""
    run.programs = run.artifacts = run.observables = None
    run.draws = {}
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, checked, failed, by_unit = check_mod.check(run.cell, run.data, run.kept, run.seed, run.device)
    check_s = time.perf_counter() - t
    limits = run.cell.limits["numbers"]
    correct = checked > 0 and failed == 0 and check_mod.judge(numbers, limits)
    dev = {**device, "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": bool(correct), "attempted": len(run.units), "failed": int(failed), "metrics": metrics}
    if run.trace_summary is not None:
        dev.update(busy_s=run.trace_summary["busy_s"], window_s=run.trace_summary["window_s"])
    line["device"] = dev
    if run.trace_summary is not None:
        line["breakdown"] = run.trace_summary["breakdown"]
    line["card"] = card
    line["units"] = {"count": len(run.units), "checked": checked, "window_s": run.window_s,
                     "unit_s": [u["unit_s"] for u in run.units], "setup_parts": run.setup_parts,
                     "check_s": check_s, "numbers_by_unit": by_unit}
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}
    return line
