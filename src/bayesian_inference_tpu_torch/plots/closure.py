"""Closure-test plots (reference plot_closure.py): per-validation-point qhat
posterior vs truth, and summary success fractions with binomial uncertainties. Carried over from
``bayesian_inference_tpu.plots.closure``."""

from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from bayesian_inference_tpu_torch.io import hdf5
from bayesian_inference_tpu_torch.plots import qhat as plot_qhat_mod
from bayesian_inference_tpu_torch.plots.utils import ensure_plot_dir

logger = logging.getLogger(__name__)


def efficiency_uncertainty(k: int, n: int) -> float:
    """Bayesian binomial efficiency uncertainty (uniform prior):
    var = <e^2> - <e>^2 with e ~ Beta(k+1, n-k+1) (reference plot_closure.py:264-290)."""
    if n == 0:
        return 0.0
    mean = (k + 1) / (n + 2)
    second = (k + 2) * (k + 1) / ((n + 3) * (n + 2))
    return float(np.sqrt(second - mean**2))


def plot(config) -> None:
    closure_base = os.path.join(config.output_dir, "closure", "results")
    if not os.path.isdir(closure_base):
        logger.info(f"No closure results at {closure_base}; skipping closure plots")
        return
    plot_dir = ensure_plot_dir(config.output_dir, "plot_closure")

    indices = sorted(int(i) for i in os.listdir(closure_base) if i.isdigit())
    successes_T, totals = 0, 0
    theta_successes = 0
    per_point = []
    names = config.analysis_config["parameterization"][config.parameterization]["names"]
    confidence = getattr(config, "confidence", 0.9)
    from bayesian_inference_tpu_torch.utils.helpers import progress_iter

    for i in progress_iter(indices, "closure plots", logger):
        run_dir = os.path.join(closure_base, str(i))
        if not os.path.exists(os.path.join(run_dir, "mcmc.h5")):
            continue
        results = hdf5.read_dict_from_h5(run_dir, "mcmc.h5", verbose=False)
        full_chain = np.asarray(results["chain"])
        chain = full_chain.reshape(-1, full_chain.shape[-1])
        truth = np.asarray(results["design_point"])
        point_dir = ensure_plot_dir(plot_dir, f"point_{i}")
        # Posterior pairplot with HPDI bands + the holdout truth marker
        # (reference plot_mcmc.py:236-290); returns the theta-space closure
        # verdict (truth inside every marginal HPDI).
        from bayesian_inference_tpu_torch.plots.mcmc import _plot_pairplot

        theta_inside = _plot_pairplot(
            full_chain, names, point_dir,
            confidence=confidence, holdout_point=truth,
            filename="pairplot_holdout.pdf",
        )
        theta_successes += int(bool(theta_inside))
        containment = plot_qhat_mod.plot_qhat_band(
            chain, config, point_dir, "qhat_vs_T.pdf",
            vs="T", fixed=100.0, target_design_point=truth,
        )
        if containment is not None:
            frac = containment.mean()
            per_point.append((i, frac))
            successes_T += int(frac > 0.5)
            totals += 1
    if totals:
        logger.info(
            f"theta-space closure: truth inside all marginal "
            f"{int(confidence * 100)}% HPDIs for {theta_successes}/{totals} points"
        )

    if totals:
        eff = successes_T / totals
        err = efficiency_uncertainty(successes_T, totals)
        fig, ax = plt.subplots(figsize=(6, 4))
        pts = np.array(per_point)
        ax.bar(pts[:, 0], pts[:, 1], color="steelblue")
        ax.axhline(0.9, color="r", ls="--", label="target 90%")
        ax.set_xlabel("validation design point")
        ax.set_ylabel("fraction of qhat(T) curve inside 90% CR")
        ax.set_title(f"closure success: {eff:.2f} +- {err:.2f} ({successes_T}/{totals})")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(plot_dir, "closure_summary.pdf"))
        plt.close(fig)
        plot_closure_summary_qhat(config, plot_dir)


def plot_closure_summary_qhat(config, plot_dir: str, confidence: float = 0.9) -> None:
    """Summary of closure success across the (E, T) plane and vs each true
    parameter (reference plot_closure.py:130-261): for every validation point,
    the fraction of the qhat(E, T) surface whose truth lies inside the
    posterior credible band, binned with Bayesian binomial uncertainties."""
    import itertools

    from bayesian_inference_tpu_torch.physics import qhat as qhat_fn

    closure_base = os.path.join(config.output_dir, "closure", "results")
    indices = sorted(int(i) for i in os.listdir(closure_base) if i.isdigit())
    Es = np.linspace(20, 200, 7)
    Ts = np.linspace(0.2, 0.5, 7)

    truths, rates = [], []
    grid_success = np.zeros((len(Es), len(Ts)))
    grid_total = np.zeros((len(Es), len(Ts)))
    for i in indices:
        run_dir = os.path.join(closure_base, str(i))
        if not os.path.exists(os.path.join(run_dir, "mcmc.h5")):
            continue
        results = hdf5.read_dict_from_h5(run_dir, "mcmc.h5", verbose=False)
        chain = np.asarray(results["chain"]).reshape(-1, np.asarray(results["chain"]).shape[-1])
        truth = np.asarray(results["design_point"])
        rng = np.random.default_rng(0)
        if chain.shape[0] > 3000:
            chain = chain[rng.choice(chain.shape[0], 3000, replace=False)]
        point_success = 0
        for (ei, E), (ti, T) in itertools.product(enumerate(Es), enumerate(Ts)):
            qs = qhat_fn(chain, config.parameterization, T=float(T), E=float(E))
            lo, hi = np.percentile(qs, [(1 - confidence) / 2 * 100, (1 + confidence) / 2 * 100])
            qt = qhat_fn(truth[None, :], config.parameterization, T=float(T), E=float(E))[0]
            inside = lo <= qt <= hi
            grid_success[ei, ti] += inside
            grid_total[ei, ti] += 1
            point_success += inside
        truths.append(truth)
        rates.append(point_success / (len(Es) * len(Ts)))

    if not truths:
        return
    truths = np.asarray(truths)
    rates = np.asarray(rates)

    # (E, T) plane success fraction
    frac = np.where(grid_total > 0, grid_success / np.maximum(grid_total, 1), np.nan)
    fig, ax = plt.subplots(figsize=(6, 4.5))
    im = ax.pcolormesh(Ts, Es, frac, vmin=0, vmax=1, cmap="RdYlGn", shading="nearest")
    fig.colorbar(im, ax=ax, label=f"fraction of closures with truth in {int(confidence*100)}% CR")
    ax.set_xlabel("T (GeV)")
    ax.set_ylabel("E (GeV)")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "closure_summary_ET.pdf"))
    plt.close(fig)

    # success rate vs each true parameter (binned, with binomial errors)
    names = config.analysis_config["parameterization"][config.parameterization]["names"]
    n_params = truths.shape[1]
    fig, axes = plt.subplots(1, n_params, figsize=(2.6 * n_params, 3), squeeze=False)
    for p in range(n_params):
        ax = axes[0][p]
        edges = np.quantile(truths[:, p], np.linspace(0, 1, 4))
        for lo_e, hi_e in zip(edges[:-1], edges[1:]):
            sel = (truths[:, p] >= lo_e) & (truths[:, p] <= hi_e)
            n_tot = int(sel.sum())
            if n_tot == 0:
                continue
            k = float(rates[sel].sum())
            err = efficiency_uncertainty(int(round(k)), n_tot)
            center = 0.5 * (lo_e + hi_e)
            ax.errorbar([center], [k / n_tot], yerr=[err], fmt="o", color="steelblue")
        ax.axhline(confidence, color="r", ls="--", lw=0.8)
        ax.set_ylim(0, 1.1)
        ax.set_xlabel(names[p], fontsize=7)
        if p == 0:
            ax.set_ylabel("closure success rate")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "closure_summary_parameters.pdf"))
    plt.close(fig)
