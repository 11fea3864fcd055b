#!/usr/bin/env python3
"""Readings for the limits of ``correct``: runs of one cell at its own size,
on several seeds in one process, printing the numbers compared for each.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 1 --variant sound
    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 1 --variant tf32

``sound`` runs the program as the configuration states (float32, TF32 off):
the lower readings; on the same window's outputs it also reads the control
that is the reference put in the program's place one precision lower
(``check.control_numbers``: float32 with TF32 products for the likelihood,
the chain rounded to bfloat16 for the statistics). ``tf32`` is the program's
own lower-precision path as the control: the same program with TF32 switched
on for its float32 matrix products. Both controls give upper readings.
``fit_one_iteration`` plants a fault: the GP fit stops after one L-BFGS
iteration (its state barely leaves the start), the upper reading of
``fit_ascent``, which no precision control moves. The benchmark's own runs
never run this script. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def set_variant(variant: str) -> None:
    import torch

    import bayesian_inference_tpu_torch  # noqa: F401 -- its import sets the precision the control changes

    tf32 = variant == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def readings(workload: str, seed: int, seconds: float, variant: str, device: str = "cuda") -> dict:
    from pbench import cell as cell_mod
    from pbench import check, harness

    set_variant(variant)
    if variant == "fit_one_iteration":
        import dataclasses

        from bayesian_inference_tpu_torch.models import gp_fit

        real = gp_fit.fit_gps

        def one_iteration(spec, *args, **kwargs):
            return real(dataclasses.replace(spec, n_iters=1, halving_keep=0), *args, **kwargs)

        gp_fit.fit_gps = one_iteration
    run = harness.Run(cell_mod.load_cell(workload), seed, seconds, False, device=device)
    try:
        run.measure()
        line = harness.result(run, run.end_to_end(), {"platform": "gpu", "kind": "", "count": 1}, "")
        out = {"workload": workload, "seed": seed, "variant": variant, "correct": line["correct"],
               "units": line["units"]["count"], "checks": {k: c["value"] for k, c in line["checks"].items()}}
        if variant == "sound":
            out["reference_control"] = check.control_numbers(run.cell, run.data, run.kept, run.seed, run.device)
    finally:
        run.cleanup()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--variant", choices=("sound", "tf32", "fit_one_iteration"), default="sound")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    for s in args.seeds.split(","):
        try:
            print(json.dumps(readings(args.workload, int(s), args.seconds, args.variant)), flush=True)
        except Exception as e:  # noqa: BLE001 -- a control that crashes has failed; say so and go on
            print(json.dumps({"workload": args.workload, "seed": int(s), "variant": args.variant,
                              "error": f"{type(e).__name__}: {e}"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
