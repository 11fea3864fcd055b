#!/usr/bin/env python3
"""Where a unit of each benchmark cell spends its time, by the program's own
spans, and where the card idles, by ``utils/profiling.device_trace``.

    python3 scripts/trace_units_torch.py --out chiprun_out/trace_units --seed 9131

Needs a CUDA card. Each cell of ``BENCHMARK.json`` is set up as the benchmark
sets it up (``perfbench/pbench/harness.Run``), then:

- ``substructure_block.long_prod``: three analyses, the middle one under
  ``device_trace``: the analysis' seconds with the trace on and off, and the
  seconds of writing the trace;
- ``substructure_lowrank.long_prod``: one analysis, traced over its first
  ``--lowrank-trace-s`` seconds (it runs on a worker thread);
- ``substructure_block.closure30``: two closure batches, the second traced;
- ``substructure_block.refit``: two refits, the second traced.

It writes ``<cell>.idle_by_span.json`` (each traced unit's idle gaps by
program span; the Chrome traces stay under ``--trace-dir``) and prints one
JSON line per cell: every unit's seconds and its root calls' spans
(seconds by span path, summed) and counters. First it times the recorder: the
nanoseconds of a child span and of a root call with no work inside.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "perfbench"), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bayesian_inference_tpu_torch.utils import profiling  # noqa: E402
from pbench import cell as cell_mod  # noqa: E402
from pbench import harness  # noqa: E402

CELLS = ("substructure_block.long_prod", "substructure_lowrank.long_prod", "substructure_block.closure30",
         "substructure_block.refit")


def recorder_cost(n: int = 200_000) -> dict:
    """Nanoseconds per child span and per root call (each with no work)."""
    with profiling.annotate("cost.root"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.annotate("cost.child"):
                pass
        child = (time.perf_counter_ns() - t0) / n
    m = n // 100
    t0 = time.perf_counter_ns()
    for _ in range(m):
        with profiling.annotate("cost.root"):
            pass
    root = (time.perf_counter_ns() - t0) / m
    profiling.clear_history()
    return {"child_span_ns": child, "root_call_ns": root, "n": n, "nvtx": torch.cuda.is_available()}


def breakdown(calls: list[dict]) -> dict:
    """Seconds by span path (summed) and counters of root calls."""
    out = []
    for c in calls:
        paths, seconds = [], {}
        for s in c["spans"]:
            paths.append(s["name"] if s["parent"] < 0 else f"{paths[s['parent']]}/{s['name']}")
            seconds[paths[-1]] = seconds.get(paths[-1], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e9
        out.append({"name": c["name"], "seconds": seconds, "counters": c["counters"]})
    return out


def unit(run: harness.Run, i: int, trace_dir: str | None = None, trace_s: float | None = None) -> dict:
    """Unit ``i`` of the run, traced into ``trace_dir`` when given (over its
    first ``trace_s`` seconds only, with the unit on a worker thread)."""
    n0 = len(profiling.history())
    t0 = time.perf_counter()
    if trace_dir and trace_s:
        worker = threading.Thread(target=run.unit, args=(i,), name="unit")
        with profiling.device_trace(trace_dir):
            worker.start()
            worker.join(trace_s)
        t_trace = time.perf_counter() - t0
        worker.join()
    elif trace_dir:
        with profiling.device_trace(trace_dir):
            run.unit(i)
            t_trace = time.perf_counter() - t0
    else:
        run.unit(i)
    harness.drain(run.device)
    rec = {"index": i, "wall_s": time.perf_counter() - t0, "unit_s": run.units[-1]["unit_s"],
           "traced": bool(trace_dir), "calls": breakdown(profiling.history()[n0:])}
    if trace_dir:
        rec["traced_wall_s"] = t_trace  # with the trace written; unit_s is the unit alone
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/trace_units")
    parser.add_argument("--trace-dir", default=os.path.join(os.environ.get("TMPDIR", "/tmp"), "trace_units"))
    parser.add_argument("--seed", type=int, default=9131)
    parser.add_argument("--cells", nargs="*", default=list(CELLS))
    parser.add_argument("--lowrank-trace-s", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_units_torch: needs a CUDA card", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"recorder": recorder_cost()}), flush=True)
    for name in args.cells:
        cell = cell_mod.load_cell(name)
        run = harness.Run(cell, args.seed, 0.0, False, device="cuda")
        try:
            t0 = time.perf_counter()
            run.setup()
            setup_s = time.perf_counter() - t0
            trace_dir = os.path.join(args.trace_dir, name)
            shutil.rmtree(trace_dir, ignore_errors=True)
            if name == "substructure_lowrank.long_prod":
                units = [unit(run, 0, trace_dir, args.lowrank_trace_s)]
            elif cell.unit == "analysis":
                units = [unit(run, 0), unit(run, 1, trace_dir), unit(run, 2)]
            else:
                units = [unit(run, 0), unit(run, 1, trace_dir)]
            shutil.copy(os.path.join(trace_dir, profiling.IDLE_FILE), out / f"{name}.{profiling.IDLE_FILE}")
            print(json.dumps({"cell": name, "seed": args.seed, "setup_s": setup_s, "units": units}), flush=True)
        finally:
            run.cleanup()
            profiling.clear_history()
    return 0


if __name__ == "__main__":
    sys.exit(main())
