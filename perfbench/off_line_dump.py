#!/usr/bin/env python3
"""Every move that ``off_line_moves`` flags in whole runs of one cell, judged
two ways on the same kept chains: by ``reference.sampler.off_line`` (the
moved point within ``rtol`` of a stretch segment, its least-squares z clamped
to [1/a, a]) and by the range test that it replaced (the least-squares z
itself within [1/a, a] widened by a fixed 1e-6, the residual at that z
within ``rtol``).

    python3 perfbench/off_line_dump.py --workload substructure_block.long_prod --seeds 11,12 --seconds 51
    python3 perfbench/off_line_dump.py --workload <cell> --seeds 13 --seconds 51 --control --out chiprun_out/off_line

Each seed is one run of the cell as ``run.py`` makes it (set-up, the window,
the comparison that decides ``correct``), in one process. After it, each kept
chain is judged both ways; with ``--control`` so is the same chain rounded
to bfloat16 (``check.control_numbers``' chain). One JSON line per seed on
standard output: ``correct``, the end-to-end metrics and the numbers
compared, whether the range test would have failed the run, and per chain
both counts, the moves, and the ensemble's width as a share of its
coordinates' magnitudes. Each flagged move, with its step, its walker, both
positions and its best candidate partner (the one nearest its segment), goes
to ``<out>/<cell>.jsonl``. The benchmark's own runs never run this script.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import run as bench_run  # noqa: E402 -- also keeps the program's build caches inside the checkout

RANGE_SLACK = 1e-6  # the replaced test's widening of [1/a, a]


def judge_both(x_prev, x_next, a: float = 2.0, rtol: float = 64 * 2.0**-23, block: int = 2**24,
               keep: int = 256) -> dict:
    """Both criteria over one chain's steps (``x_prev``, ``x_next``: (T, W, d)
    float64), in ``reference.sampler.off_line``'s scaled units, candidates and
    blocks: the counts each flags (``segment``: the reference's; ``range``:
    the replaced test's), the moves, and up to ``keep`` flagged moves with
    their best candidate."""
    import torch

    T, W, d = x_prev.shape
    not_self = ~torch.eye(W, dtype=torch.bool, device=x_prev.device).repeat(1, 2)
    lo, hi = (1.0 - RANGE_SLACK) / a, a * (1.0 + RANGE_SLACK)
    rows = max(1, block // (2 * W * W * d))
    out = {"segment": 0, "range": 0, "moves": 0, "flagged": []}
    for s in range(0, T, rows):
        xp, xn = x_prev[s:s + rows], x_next[s:s + rows]
        moved = torch.any(xn != xp, dim=-1)
        cand = torch.cat([xp, xn], dim=1)[:, None]
        scale = (cand.abs() + xp[:, :, None].abs() + xn[:, :, None].abs()).clamp_min(torch.finfo(xp.dtype).tiny)
        v, w = (xp[:, :, None] - cand) / scale, (xn[:, :, None] - cand) / scale
        vv = (v * v).sum(-1)
        z = (v * w).sum(-1) / vv.clamp_min(torch.finfo(v.dtype).tiny)
        zc = z.clamp(1.0 / a, a)
        res = (w - z[..., None] * v).abs().amax(-1)
        res_c = (w - zc[..., None] * v).abs().amax(-1)
        valid = (vv > 0) & not_self
        seg = moved & ~((res_c <= rtol) & valid).any(-1)
        rng = moved & ~((res <= rtol) & valid & (z >= lo) & (z <= hi)).any(-1)
        out["moves"] += int(moved.sum())
        out["segment"] += int(seg.sum())
        out["range"] += int(rng.sum())
        either = (seg | rng).nonzero().tolist()
        for ti, k in either[:max(0, keep - len(out["flagged"]))]:
            score = torch.where(valid[ti, k], res_c[ti, k], torch.full_like(res_c[ti, k], math.inf))
            j = int(score.argmin())
            nv = float(vv[ti, k, j].sqrt())
            zj = float(z[ti, k, j])
            out["flagged"].append({
                "step": s + ti, "walker": k, "x_prev": xp[ti, k].tolist(), "x_next": xn[ti, k].tolist(),
                "flagged_by": [n for n, f in (("segment", seg), ("range", rng)) if bool(f[ti, k])],
                "partner": j % W, "partner_when": "before" if j < W else "after",
                "partner_pos": cand[ti, 0, j].tolist(), "z_fit": zj, "v_norm": nv,
                "residual_fit": float(res[ti, k, j]), "z_clamped": float(zc[ti, k, j]),
                "residual_clamped": float(res_c[ti, k, j]),
                "z_outside": max(1.0 / a - zj, zj - a, 0.0),
                "rounding_allowance": rtol * math.sqrt(d) / nv if nv > 0 else math.inf,
            })
    return out


def width_share(chain) -> list[float]:
    """Per coordinate, the median over every 100th row of the ensemble's
    standard deviation over its mean magnitude."""
    x = chain[::100]
    return (x.std(dim=1) / x.abs().mean(dim=1)).median(dim=0).values.tolist()


def dump(cell, seed: int, seconds: float, device, control: bool, card: dict, power: str) -> tuple[dict, list]:
    """One run of ``cell`` and both judgements of its kept chains: the seed's
    summary line and its flagged moves."""
    import numpy as np
    import torch

    from pbench import check, harness

    run = harness.Run(cell, seed, seconds, False, device=device)
    try:
        run.measure()
        line = harness.result(run, run.end_to_end(), card, power)
        chains, flagged = [], []
        for unit in run.kept:
            for e in unit.get("ensembles", []):
                x_prev, x_next = check._rows_apart(e["chain"], run.device)
                got = judge_both(x_prev, x_next)
                where = {"unit": unit["index"], "point": e.get("point")}
                flagged += [{**where, **m} for m in got.pop("flagged")]
                got.update(where, width_share=width_share(x_prev))
                if control:
                    low = torch.tensor(np.asarray(e["chain"])).to(torch.bfloat16).to(torch.float64).numpy()
                    lowj = judge_both(*check._rows_apart(low, run.device), keep=0)
                    got.update(bf16_segment=lowj["segment"], bf16_range=lowj["range"], bf16_moves=lowj["moves"])
                chains.append(got)
    finally:
        run.cleanup()
    limit = cell.limits["numbers"]["off_line_moves"]
    summary = {"workload": cell.name, "seed": seed, "correct": line["correct"],
               "correct_with_range_test": line["correct"] and all(c["range"] <= limit for c in chains),
               "segment": sum(c["segment"] for c in chains), "range": sum(c["range"] for c in chains),
               "moves": sum(c["moves"] for c in chains), "metrics": line["metrics"],
               "checks": {k: c["value"] for k, c in line["checks"].items()}, "units": line["units"]["count"],
               "check_s": line["units"]["check_s"], "card": power, "chains": chains}
    return summary, flagged


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--control", action="store_true", help="also judge the chains rounded to bfloat16")
    parser.add_argument("--out", default="chiprun_out/off_line")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

    from pbench import cell as cell_mod

    cell = cell_mod.load_cell(args.workload)
    card = bench_run.card(cell.chips)
    power = bench_run.power_limit()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for s in args.seeds.split(","):
        summary, flagged = dump(cell, int(s), args.seconds, "cuda", args.control, card, power)
        with open(out / f"{cell.name}.jsonl", "a") as f:
            for m in flagged:
                f.write(json.dumps({"seed": int(s), **m}) + "\n")
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
