#!/usr/bin/env python3
"""Production-scale closure-test benchmark of the PyTorch + CUDA port on one
CUDA card.

The port's counterpart of ``scripts/bench_closure.py``: every validation
point of the production profile (30 points x 100 walkers x 1,000 burn-in +
50,000 production steps) advanced together by ``run_closure_batch``, in
chunks of ``dispatch_chunk`` steps, checkpointed every quarter of
production. ``bench_closure.py`` reads the emulators ``bench.py`` left on
disk; this script fits them in memory through ``bench_torch.py``'s functions
(the production tables, ingested; ``fit_emulators(write=False)``), and the
batch runs with ``write=False, return_chains=False``: the chain slabs stay on
the card for the device statistics, and nothing needs ``yaml`` or ``h5py``.
It imports torch and the port, never JAX.

Protocol: the emulators are fitted and the batch's sampler program is built
from shapes (``prewarm_sampler_programs``) before anything is timed; one
untimed warm-up batch of one dispatch chunk runs on the same program shapes;
then the timed batch. The runner always builds the program of burn-in phase 2
(which stores no chain) inside the batch; the line reports the programs built
there. Without ``write`` each checkpoint record carries its chunk's chain and
log-probs, pickled to ``output/.../closure/closure_checkpoint.pkl`` (deleted
when the batch completes): the line gives the seconds and bytes of those
appends apart from production's.

Every point is gated: its production log-probs finite (read from the
checkpoint records, the only place they reach the host), its final log-probs
finite, its mean acceptance in (0.05, 0.9), its split-R-hat finite; on the
card one launch of the likelihood's kernel per evaluation; and once, the
float32 likelihood against the float64 plain path at 64 final positions, as
``bench_torch.py`` gates it. A failed gate raises: no result line. The
script writes under ``output/`` only, never ``CLOSURE_BENCH*.json`` (the JAX
package's records).

Usage, from the repository root::

    python3 scripts/bench_closure_torch.py                          # block mode
    BENCH_CLOSURE_MODE=lowrank python3 scripts/bench_closure_torch.py

Knobs: BENCH_CLOSURE_STEPS (50000), BENCH_CLOSURE_WALKERS (100),
BENCH_CLOSURE_POINTS (0 = all 30), BENCH_CLOSURE_CHUNK (1000),
BENCH_CLOSURE_MODE=block|lowrank, BENCH_CLOSURE_WARMUP=0 (no warm-up), and
from ``bench_torch.py`` BENCH_BURN, BENCH_RESTARTS, BENCH_OPT_ITERS and
BENCH_DEVICE (``cuda`` by default, which raises without a card).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench_torch as bench  # noqa: E402
from bayesian_inference_tpu_torch.mcmc import programs as programs_mod  # noqa: E402
from bayesian_inference_tpu_torch.mcmc import runner  # noqa: E402
from bayesian_inference_tpu_torch.models.emulator import fit_emulators, resolve_device  # noqa: E402

METRIC = "production_closure_batch_walltime"


@dataclasses.dataclass(frozen=True)
class ClosureSettings:
    """The batch's knobs, with ``scripts/bench_closure.py``'s defaults."""

    steps: int = 50_000
    walkers: int = 100
    points: int = 0  # 0: every validation point
    chunk: int = 1000
    mode: str = "block"
    warmup: bool = True

    @classmethod
    def from_env(cls, environ=os.environ) -> "ClosureSettings":
        s = cls(
            steps=int(environ.get("BENCH_CLOSURE_STEPS", 50_000)),
            walkers=int(environ.get("BENCH_CLOSURE_WALKERS", 100)),
            points=int(environ.get("BENCH_CLOSURE_POINTS", "0") or 0),
            chunk=int(environ.get("BENCH_CLOSURE_CHUNK", 1000)),
            mode=environ.get("BENCH_CLOSURE_MODE", "block"),
            warmup=environ.get("BENCH_CLOSURE_WARMUP", "1") != "0",
        )
        if s.mode not in bench.MODES:
            raise ValueError(f"BENCH_CLOSURE_MODE={s.mode!r}: expected block or lowrank")
        return s


@contextlib.contextmanager
def checkpoint_appends():
    """Time the batch's checkpoint appends (pickle, write, flush) and read
    every record's production log-probs on the way: yields a dict with the
    seconds, the file's bytes, the appends (the header, then one record per
    production chunk) and whether every log-prob seen was finite."""
    seen = {"seconds": 0.0, "bytes": 0, "appends": 0, "log_probs_finite": True, "log_probs_seen": 0}
    inner = runner._CheckpointStream.append

    def append(stream, record):
        if "chain_log_prob" in record:
            lp = record["chain_log_prob"]
            seen["log_probs_finite"] &= bool(np.isfinite(lp).all())
            seen["log_probs_seen"] += lp.size
        t = time.perf_counter()
        inner(stream, record)
        seen["seconds"] += time.perf_counter() - t
        seen["bytes"] = stream.file.tell()
        seen["appends"] += 1

    runner._CheckpointStream.append = append
    try:
        yield seen
    finally:
        runner._CheckpointStream.append = inner


def fitted_production(s: bench.Settings, c: ClosureSettings, device: torch.device) -> dict:
    """The production profile's configs and observables, and its emulators
    fitted in memory (untimed)."""
    s = dataclasses.replace(s, walkers=c.walkers, steps=c.steps)
    table_dir = bench.production_tables()
    config = bench.make_config(bench.WORK_DIR / f"bench_torch_closure_{c.mode}", bench.PRODUCTION_GROUPS, s,
                               str(table_dir), bench.PRODUCTION_EXCLUDE)
    observables = bench.ingest(config)
    emu, mcmc = bench.run_configs(config)
    t = time.perf_counter()
    artifacts = fit_emulators(emu, n_opt_iters=s.opt_iters, device=device, observables=observables, write=False)
    bench.drain(device)
    return {"config": config, "emu": emu, "mcmc": mcmc, "observables": observables, "artifacts": artifacts,
            "fit_s": time.perf_counter() - t}


def with_steps(config: dict, n_steps: int) -> dict:
    """``config`` with ``n_steps`` production steps."""
    config = copy.deepcopy(config)
    config["analyses"][bench.ANALYSIS]["parameters"]["mcmc"]["n_sampling_steps"] = n_steps
    return config


def run_batch(f: dict, mcmc, indices, c: ClosureSettings, device, programs, checkpoint_every=None):
    return runner.run_closure_batch(mcmc, indices, seed=0, device=device, mode=c.mode,
                                    emulation_results=f["artifacts"], observables=f["observables"], write=False,
                                    return_chains=False, checkpoint_every=checkpoint_every, programs=programs,
                                    dispatch_chunk=c.chunk)


def run_closure(s: bench.Settings, c: ClosureSettings, device: torch.device) -> dict:
    """Fit, warm up, then time one closure batch over the validation points;
    every point gated. Returns the result line."""
    f = fitted_production(s, c, device)
    mcmc = f["mcmc"]
    v0, v1 = mcmc.analysis_config["validation_indices"]
    P = c.points or (v1 - v0)
    indices = list(range(P))
    ndim = len(mcmc.parameterization_spec()["names"])
    checkpoint_every = max(1, c.steps // 4)
    slab_gb = c.steps * P * c.walkers * (ndim + 1) * 4 / 2**30
    closure_dir = Path(mcmc.output_dir) / "closure"
    free_gb = shutil.disk_usage(bench.WORK_DIR).free / 2**30
    bench.log(f"closure bench ({c.mode}): {P} points x {c.walkers} walkers x ({s.burn} + {c.steps}) steps in chunks "
              f"of {c.chunk}, checkpoint every {checkpoint_every}; full-batch slabs {slab_gb:.2f} GB f32; "
              f"{free_gb:.1f} GB free under {bench.WORK_DIR}; fit {f['fit_s']:.2f} s (untimed), on {device}")

    t = time.perf_counter()
    programs = programs_mod.prewarm_sampler_programs(mcmc, mode=c.mode, checkpoint_every=checkpoint_every,
                                                     device=device, observables=f["observables"], n_points=P,
                                                     dispatch_chunk=c.chunk)
    result = {"prewarm_s": time.perf_counter() - t}
    if c.warmup:
        warm = bench.run_configs(with_steps(f["config"], min(c.chunk, c.steps)))[1]
        t = time.perf_counter()
        run_batch(f, warm, indices, c, device, programs)
        bench.drain(device)
        result["warmup_s"] = time.perf_counter() - t
        bench.log(f"warm-up (untimed, one dispatch chunk): {result['warmup_s']:.2f} s")

    shutil.rmtree(closure_dir, ignore_errors=True)  # a checkpoint left by a failed run would be resumed
    n0, b0 = bench.launches(), bench.programs_built()
    bench.drain(device)
    bench.reset_peak(device)
    with checkpoint_appends() as ckpt:
        t = time.perf_counter()
        out = run_batch(f, mcmc, indices, c, device, programs, checkpoint_every)
        bench.drain(device)
        total_s = time.perf_counter() - t
    counts = bench.delta(bench.launches(), n0)
    built = bench.delta(bench.programs_built(), b0)
    timings = out[indices[0]]["timings"]

    # The gates, point by point.
    bench.gate(ckpt["log_probs_finite"] and ckpt["log_probs_seen"] == c.steps * P * c.walkers,
               f"closure {c.mode}: {ckpt['log_probs_seen']} production log-probs seen, all finite: "
               f"{ckpt['log_probs_finite']}")
    acceptance = []
    for i in indices:
        o = out[i]
        af = float(np.mean(o["acceptance_fraction"]))
        acceptance.append(af)
        what = f"closure {c.mode} point {i}"
        bench.gate(bool(np.isfinite(o["final_log_prob"]).all()), f"{what}: non-finite final log-probs")
        bench.gate(bench.ACCEPTANCE_RANGE[0] < af < bench.ACCEPTANCE_RANGE[1], f"{what}: mean acceptance {af:.4f}")
        bench.gate(bool(np.isfinite(o["split_rhat"]).all()), f"{what}: non-finite split-R-hat")
    bench.gate_launches(counts, c.mode, s.burn, c.steps, built["sampler"], device, f"closure {c.mode}")
    rel = bench.check_likelihood(f["emu"], mcmc, f["artifacts"], f["observables"], out[indices[0]]["final_coords"],
                                 c.mode, device)

    return {
        "metric": METRIC,
        "value": total_s,
        "unit": "s",
        "likelihood_mode": c.mode,
        "n_points": P,
        "n_walkers": c.walkers,
        "n_burn": s.burn,
        "n_steps": c.steps,
        "point_steps_per_s": P * c.steps / total_s,
        "production_point_steps_per_s": P * c.steps / timings["production"],
        "full_batch_slab_GB": slab_gb,
        "dispatch_chunk": c.chunk,
        "closure_device_budget_bytes": runner.CLOSURE_DEVICE_BUDGET_BYTES,
        "peak_allocated_bytes": bench.peak_bytes(device),
        "phases": dict(timings),
        "checkpoint": {"checkpoint_every": checkpoint_every, "seconds": ckpt["seconds"], "bytes": ckpt["bytes"],
                       "appends": ckpt["appends"],
                       "production_less_checkpoint_s": timings["production"] - ckpt["seconds"]},
        "launches": counts,
        "programs_built": built,
        "acceptance": {"min": min(acceptance), "max": max(acceptance)},
        "split_rhat_max": max(float(np.max(out[i]["split_rhat"])) for i in indices),
        "likelihood_check_rel": rel,
        "fit_s": f["fit_s"],
        **result,
        **bench.device_fields(device),
    }


def main() -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(asctime)s %(name)s: %(message)s")
    s, c = bench.Settings.from_env(), ClosureSettings.from_env()
    device = resolve_device(s.device)
    print(json.dumps(run_closure(s, c, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
