#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up (tables from the seed, ingest, the
programs built, the shapes warmed) is timed as ``setup_s``; then whole units
of the cell's traffic run back to back for ``--seconds``; then the float64
reference judges the window's outputs. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, also printed as the last lines of
standard error. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Kernel builds and caches stay inside the checkout, at fixed paths.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
for p in (str(BENCH_DIR), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card(chips: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} cards, torch finds {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

    from pbench import cell as cell_mod

    cell = cell_mod.load_cell(args.workload)
    device = card(cell.chips)
    try:
        from pbench import harness
    except ImportError as e:
        fail(f"the program under test does not import ({e}): run from the root of a whole checkout")

    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START)
    try:
        run.measure()
        bad = harness.forbidden_modules()
        if bad:
            fail(f"modules of JAX or the JAX package are loaded: {bad}", 3)
        metrics = run.per_layer() if args.trace else run.end_to_end()
        line = harness.result(run, metrics, device, power_limit())
    finally:
        run.cleanup()
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
