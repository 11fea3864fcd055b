"""Cross-analysis comparison plots (reference plot_analyses.py): overlay qhat
credible bands from multiple analyses in one figure, with the prior credible
band drawn once for comparison (plot_analyses.py:73-163, plot_prior=True
default) and per-analysis physics labels (:104-107). Carried over from
``bayesian_inference_tpu.plots.analyses``."""

from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from bayesian_inference_tpu_torch.io import hdf5
from bayesian_inference_tpu_torch.mcmc.stats import credible_interval
from bayesian_inference_tpu_torch.physics import qhat
from bayesian_inference_tpu_torch.physics.priors import generate_prior_samples
from bayesian_inference_tpu_torch.pipeline.configs import MCMCConfig

logger = logging.getLogger(__name__)


def analysis_label(analysis_name: str) -> str:
    """Physics label for an analysis (reference plot_analyses.py:104-107).

    The reference hardcodes two labels keyed on 'substructure' in the name;
    we keep that convention and fall back to the raw name for anything else.
    """
    if "substructure" in analysis_name:
        return r"Jet $R_{\mathrm{AA}}$ + substructure"
    if "jet" in analysis_name:
        return r"Jet $R_{\mathrm{AA}}$"
    return analysis_name


def plot(analyses: dict, config_file: str, output_dir: str, confidence: float = 0.9,
         n_samples: int = 5000, config: dict | None = None) -> list[str]:
    """Write qhat_across_analyses.pdf; returns the legend labels drawn
    (prior band first) so tests can assert the overlay content. ``config``:
    the parsed top-level configuration, in place of reading ``config_file``."""
    fig, ax = plt.subplots(figsize=(6, 4.5))
    xs = np.linspace(0.16, 0.5, 50)
    colors = plt.cm.tab10.colors
    plotted = 0
    prior_drawn = False

    for analysis_name, analysis_config in analyses.items():
        for parameterization in analysis_config["parameterizations"]:
            cfg = MCMCConfig(
                analysis_name=analysis_name,
                parameterization=parameterization,
                analysis_config=analysis_config,
                config_file=config_file,
                config=config,
            )
            mcmc_h5 = os.path.join(cfg.mcmc_output_dir, "mcmc.h5")
            if not os.path.exists(mcmc_h5):
                logger.info(f"No mcmc.h5 for {analysis_name}/{parameterization}; skipping")
                continue
            results = hdf5.read_dict_from_h5(cfg.mcmc_output_dir, "mcmc.h5", verbose=False)
            chain = np.asarray(results["chain"])
            flat = chain.reshape(-1, chain.shape[-1])
            rng = np.random.default_rng(0)
            if flat.shape[0] > n_samples:
                flat = flat[rng.choice(flat.shape[0], n_samples, replace=False)]
            color = colors[plotted % len(colors)]

            # Prior credible band: drawn once, from the first analysis's
            # parameterization box (reference draws it with the first
            # analysis's config, plot_analyses.py:146-163).
            if not prior_drawn:
                spec = cfg.parameterization_spec()
                prior = generate_prior_samples(
                    spec["names"], spec["min"], spec["max"],
                    n_samples=flat.shape[0], rng=rng,
                )
                q_prior = np.stack(
                    [qhat(prior, parameterization, T=float(x), E=100.0) for x in xs], axis=1
                )
                ci_prior = np.array([credible_interval(q, confidence) for q in q_prior.T])
                ax.fill_between(
                    xs, ci_prior[:, 0], ci_prior[:, 1], alpha=0.15, color="gray",
                    label=f"Prior {int(confidence * 100)}% Credible Interval",
                )
                prior_drawn = True

            qs = np.stack([qhat(flat, parameterization, T=float(x), E=100.0) for x in xs], axis=1)
            ci = np.array([credible_interval(q, confidence) for q in qs.T])
            ax.fill_between(
                xs, ci[:, 0], ci[:, 1], alpha=0.3, color=color,
                label=f"{analysis_label(analysis_name)}: Posterior {int(confidence * 100)}% CI",
            )
            ax.plot(xs, np.median(qs, axis=0), color=color, lw=1)
            plotted += 1

    labels: list[str] = []
    if plotted:
        ax.set_xlabel("T (GeV)")
        ax.set_ylabel(r"$\hat{q}/T^3$")
        ax.set_title("E = 100 GeV", fontsize=9)
        legend = ax.legend(fontsize=7)
        labels = [t.get_text() for t in legend.get_texts()]
        fig.tight_layout()
        os.makedirs(output_dir, exist_ok=True)
        fig.savefig(os.path.join(output_dir, "qhat_across_analyses.pdf"))
    plt.close(fig)
    return labels
