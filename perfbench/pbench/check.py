"""The comparison that decides ``correct``: the program's outputs from the
window, judged by the float64 reference (``perfbench/reference``).

What each number is (the largest over the units and points checked):

* ``lp_gap``: |log-posterior the program recorded - the reference's| at the
  chain's own points, nats (rows drawn from the seed, and the last row).
* ``move_mismatch``: accept decisions of the program that differ from the
  reference's where the reference's log ratio is clear of log u by
  ``move_margin`` nats, plus moves to a point that is not the proposal (a
  count; each checked step, each half). Read in the unit that ran on the
  benchmark's draws.
* ``off_line_moves``: moves, over every production step of every chain
  kept, that no stretch move could make (``reference.sampler.off_line``):
  judged without the draws, so it holds the units that ran on the program's
  own generator too.
* ``tau_gap``: |tau - reference tau| / reference tau, per parameter; 1 where
  the program reports no tau though the chain is over 55 tau long.
* ``rhat_gap``: |split R-hat - reference|.
* ``lml_gap``: |the fit's log marginal likelihood of a PC - the reference's
  at the fit's hyperparameters|, nats.
* ``fit_ascent``: the most the reference's log marginal likelihood rises by
  a step of ``ascent_step`` in one log-hyperparameter from the fit's point,
  inside the bounds, nats: how far the fit stopped from a maximum.

The closure batches' emulators are fitted in set-up; their fit is judged
once, by the same two fit numbers, since every batch's likelihood rests on
it. A unit fails when one of its numbers is above its limit
(``limits/<cell>.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import data as ref_data
from reference import emulator as ref_emulator
from reference import sampler as ref_sampler
from reference import stats as ref_stats
from reference.likelihood import Likelihood

F64 = torch.float64


def rows_to_check(n: int, count: int, rng: np.random.Generator) -> list[int]:
    """``count`` production rows drawn from ``rng`` (from 1: the step from row
    t - 1 to row t is judged), and the last."""
    count = min(count, n - 1)
    return sorted({*rng.choice(np.arange(1, n), size=count, replace=False).tolist(), n - 1})


def lp_gap(prog_lp: np.ndarray, ref_lp: torch.Tensor) -> float:
    p = torch.as_tensor(np.asarray(prog_lp, np.float64).reshape(-1))
    r = ref_lp.cpu().reshape(-1)
    both_inf = torch.isinf(p) & torch.isinf(r) & ((p > 0) == (r > 0))
    gap = torch.where(both_inf, torch.zeros_like(p), (p - r).abs())
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, torch.inf), gap)
    return float(gap.max())


def fit_numbers(data, config: dict, params: dict, device, step: float, pcas: dict) -> dict[str, float]:
    """lml_gap and fit_ascent over every PC of every group (``pcas``: the
    reference's PCA of each group)."""
    X = torch.tensor(data.design, dtype=F64, device=device)
    span = np.asarray(config["prior_max"], float) - np.asarray(config["prior_min"], float)
    f_lo, f_hi = config["kernel"]["length_scale_bounds_factor"]
    n_lo, n_hi = config["kernel"]["noise_level_bounds"]
    lo = torch.tensor(np.r_[np.log(span * f_lo), np.log(n_lo)], dtype=F64, device=device)
    hi = torch.tensor(np.r_[np.log(span * f_hi), np.log(n_hi)], dtype=F64, device=device)
    gap, ascent = 0.0, 0.0
    for g in data.groups:
        p = pcas[g.name]
        y = torch.tensor(p.scores[:, :g.n_pc].T, dtype=F64, device=device)
        theta = torch.tensor(np.c_[params[g.name]["log_length_scale"], params[g.name]["log_noise"]], dtype=F64,
                             device=device)                                            # (k, d + 1)
        gps = ref_emulator.GPs(float(config["kernel"]["nu"]), float(config["alpha"]), X, y, theta[:, :-1],
                               theta[:, -1])
        lml0 = gps.lml()
        gap = max(gap, float((lml0.cpu() - torch.tensor(params[g.name]["lml"])).abs().max()))
        n_par = theta.shape[1]
        moves = torch.cat([torch.eye(n_par, dtype=F64, device=device), -torch.eye(n_par, dtype=F64, device=device)])
        trial = theta[None] + step * moves[:, None, :]                                # (2 n_par, k, n_par)
        lml = gps.lml(trial[..., :-1], trial[..., -1])
        ok = torch.all((trial >= lo) & (trial <= hi), dim=-1)
        rise = torch.where(ok, lml - lml0[None], torch.full_like(lml, -torch.inf)).amax(0)
        ascent = max(ascent, float(rise.clamp(min=0.0).max()))
    return {"lml_gap": gap, "fit_ascent": ascent}


def _rows_apart(chain: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each production row before its step and after it, float64 on ``device``."""
    x = torch.as_tensor(chain, device=device).to(F64)
    return x[:-1], x[1:]


def chain_numbers(chain, log_prob, draws, tau_prog, rhat_prog, rows, like: Likelihood, y, width, margin,
                  device) -> dict:
    """lp_gap, off_line_moves, tau_gap and rhat_gap of one ensemble's chain,
    and move_mismatch where it ran on the benchmark's ``draws``."""
    chain = np.asarray(chain)
    pts = chain[rows].reshape(-1, chain.shape[-1])
    out = {"lp_gap": lp_gap(np.asarray(log_prob)[rows], like.log_posterior(pts, y))}
    out["off_line_moves"] = float(ref_sampler.off_line(*_rows_apart(chain, device)))

    if draws is not None:
        # every checked step's walkers and proposals, evaluated in one call
        steps = [(t, ref_sampler.proposals(chain[t - 1], chain[t], draws, t)) for t in rows if t >= 1]
        pts = torch.cat([torch.cat([p["xp"], *p["y"]]) for _, p in steps])
        W = chain.shape[1]
        lp = like.log_posterior(pts, y).cpu().split(2 * W)
        mism = 0
        for (t, p), lp_t in zip(steps, lp):
            lp_y = [lp_t[W:W + W // 2], lp_t[W + W // 2:]]
            mism += ref_sampler.judge_step(p, lp_t[:W], lp_y, draws, t, width, margin=margin)["mismatches"]
        out["move_mismatch"] = float(mism)
    n = chain.shape[0]
    tau_ref = ref_stats.integrated_time(chain)
    if tau_prog is None:
        out["tau_gap"] = 1.0 if np.all(ref_stats.TAU_TOL * 1.1 * tau_ref < n) else 0.0
    else:
        out["tau_gap"] = float(np.max(np.abs(np.asarray(tau_prog, float) - tau_ref) / tau_ref))
    out["rhat_gap"] = float(np.max(np.abs(np.asarray(rhat_prog, float) - ref_stats.split_rhat(chain))))
    return out


def merge(into: dict[str, float], numbers: dict[str, float]) -> None:
    """The largest of each number; NaN (no reading) counts as infinite."""
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), float("inf") if np.isnan(v) else v)


def judge(numbers: dict[str, float], limits: dict) -> bool:
    """Whether every number that has a limit is within it (a number without
    one, as ``rhat_gap`` in lowrank mode, is read and not compared)."""
    return all(numbers[k] <= limits[k] for k in limits if k in numbers)


def check(cell, data, kept: list[dict], seed: int, device) -> tuple[dict[str, float], int, int, list]:
    """(the numbers compared, units checked, units failed, each unit's
    numbers) of the window's kept outputs: every unit's. Each kept entry
    holds the unit's index, fitted parameters (``params``), and its chains
    where it ran a sampler, with the draws where the benchmark made them."""
    cfg, lim = cell.config, cell.limits
    width = np.asarray(cfg["prior_max"], float) - np.asarray(cfg["prior_min"], float)
    numbers: dict[str, float] = {}
    failed, by_unit = 0, []
    pcas = {g.name: ref_emulator.pca(g.Y, cfg["max_n_components_to_calculate"]) for g in data.groups}
    for unit in kept:
        rng = np.random.default_rng([seed, unit["index"] % 2**32, 7])
        got: dict[str, float] = {}
        if unit.get("params") is not None and (cell.unit != "closure" or unit.get("fit_only")):
            merge(got, fit_numbers(data, cfg, unit["params"], device, lim["ascent_step"], pcas))
        if cell.unit in ("analysis", "closure") and not unit.get("fit_only"):
            like = Likelihood(data, cfg, unit["params"], cfg["likelihood_mode"], device)
            for e in unit["ensembles"]:
                y = None
                if e.get("pseudodata_seed") is not None:
                    y = like.data_vector(ref_data.pseudodata(data, e["point"], e["pseudodata_seed"]))
                rows = rows_to_check(e["chain"].shape[0], lim["check_rows"], rng)
                merge(got, chain_numbers(e["chain"], e["log_prob"], e.get("draws"), e["tau"], e["rhat"], rows, like,
                                         y, width, lim["move_margin"], device))
            for f in unit.get("finals", []):
                y = like.data_vector(ref_data.pseudodata(data, f["point"], f["pseudodata_seed"]))
                merge(got, {"lp_gap": lp_gap(f["log_prob"], like.log_posterior(f["coords"], y))})
            del like
        failed += not judge(got, lim["numbers"])
        merge(numbers, got)
        by_unit.append([unit["index"], got])
    return numbers, len(kept), failed, by_unit


def control_numbers(cell, data, kept: list[dict], seed: int, device) -> dict[str, float]:
    """The reference put in the program's place one precision lower, judged
    like the program on the same window's outputs: the log-posterior at the
    same points in float32 with TF32 matrix products (the configuration
    states float32 with TF32 off), and the chain statistics of the chain
    rounded to bfloat16 (float32 arithmetic that is not a matrix product).
    Never part of a benchmark run (``control.py`` calls it)."""
    cfg, lim = cell.config, cell.limits
    numbers: dict[str, float] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for unit in kept:
            if unit.get("fit_only") or "ensembles" not in unit:
                continue
            rng = np.random.default_rng([seed, unit["index"] % 2**32, 7])
            ref = Likelihood(data, cfg, unit["params"], cfg["likelihood_mode"], device)
            low = Likelihood(data, cfg, unit["params"], cfg["likelihood_mode"], device, dtype=torch.float32)
            for e in unit["ensembles"]:
                y = y_low = None
                if e.get("pseudodata_seed") is not None:
                    pd = ref_data.pseudodata(data, e["point"], e["pseudodata_seed"])
                    y, y_low = ref.data_vector(pd), low.data_vector(pd)
                rows = rows_to_check(e["chain"].shape[0], lim["check_rows"], rng)
                pts = np.asarray(e["chain"])[rows].reshape(-1, e["chain"].shape[-1])
                try:
                    gap = lp_gap(low.log_posterior(pts, y_low).cpu().numpy(), ref.log_posterior(pts, y))
                except RuntimeError:  # a control that fails to compute has failed
                    gap = float("inf")
                chain = np.asarray(e["chain"], np.float64)
                rounded = torch.tensor(chain).to(torch.bfloat16).to(torch.float64).numpy()
                tau_ref, tau_low = ref_stats.integrated_time(chain), ref_stats.integrated_time(rounded)
                merge(numbers, {
                    "lp_gap": gap,
                    "off_line_moves": float(ref_sampler.off_line(*_rows_apart(rounded, device))),
                    "tau_gap": float(np.max(np.abs(tau_low - tau_ref) / tau_ref)),
                    "rhat_gap": float(np.max(np.abs(ref_stats.split_rhat(rounded) - ref_stats.split_rhat(chain)))),
                })
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return numbers
