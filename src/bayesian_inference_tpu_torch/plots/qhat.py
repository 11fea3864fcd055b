"""qhat posterior plots (reference plot_qhat.py): credible bands of qhat/T^3
vs T (fixed E) and vs E (fixed T), with prior bands, MAP curve, and optional
closure-truth overlay + containment bookkeeping. Carried over from
``bayesian_inference_tpu.plots.qhat``; the sensitivity plot's emulator
predictions run on ``device``."""

from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from bayesian_inference_tpu_torch.io import hdf5
from bayesian_inference_tpu_torch.physics import generate_prior_samples, qhat
from bayesian_inference_tpu_torch.plots.utils import ensure_plot_dir

logger = logging.getLogger(__name__)


def plot(config, device="cuda") -> None:
    from bayesian_inference_tpu_torch.models.emulator import resolve_device

    device = resolve_device(device)
    mcmc_h5 = os.path.join(config.mcmc_output_dir, "mcmc.h5")
    if not os.path.exists(mcmc_h5):
        logger.info(f"No mcmc.h5 found at {mcmc_h5}; skipping qhat plots")
        return
    results = hdf5.read_dict_from_h5(config.mcmc_output_dir, "mcmc.h5", verbose=False)
    plot_dir = ensure_plot_dir(config.output_dir, "plot_qhat")

    chain = np.asarray(results["chain"]).reshape(-1, np.asarray(results["chain"]).shape[-1])
    target = results.get("design_point", None)

    plot_qhat_band(
        chain, config, plot_dir, "qhat_vs_T.pdf", vs="T", fixed=100.0,
        target_design_point=target,
    )
    plot_qhat_band(
        chain, config, plot_dir, "qhat_vs_E.pdf", vs="E", fixed=0.3,
        target_design_point=target,
    )
    try:
        plot_observable_sensitivity(chain, config, plot_dir, device=device)
    except FileNotFoundError as e:
        logger.info(f"Skipping sensitivity plots (missing emulator artifacts): {e}")


def plot_qhat_band(
    posterior_samples: np.ndarray,
    config,
    plot_dir: str,
    filename: str,
    vs: str = "T",
    fixed: float = 100.0,
    confidence: float = 0.9,
    n_samples: int = 5000,
    n_x: int = 50,
    plot_prior: bool = True,
    target_design_point: np.ndarray | None = None,
) -> np.ndarray | None:
    """Credible band of qhat/T^3 along T (fixed E) or E (fixed T).

    Returns the per-x containment booleans when a closure target is given
    (reference plot_qhat.py:138-150)."""
    rng = np.random.default_rng(0)
    if posterior_samples.shape[0] > n_samples:
        posterior_samples = posterior_samples[
            rng.choice(posterior_samples.shape[0], n_samples, replace=False)
        ]

    if vs == "T":
        xs = np.linspace(0.16, 0.5, n_x)
        eval_kwargs = [dict(T=float(x), E=fixed) for x in xs]
        xlabel, suffix = "T (GeV)", f"E = {fixed} GeV"
    else:
        xs = np.linspace(5, 200, n_x)
        eval_kwargs = [dict(T=fixed, E=float(x)) for x in xs]
        xlabel, suffix = "E (GeV)", f"T = {fixed} GeV"

    qs = np.stack(
        [qhat(posterior_samples, config.parameterization, **kw) for kw in eval_kwargs], axis=1
    )  # (n_samples, n_x)
    lo, hi = np.percentile(qs, [(1 - confidence) / 2 * 100, (1 + confidence) / 2 * 100], axis=0)
    mid = np.median(qs, axis=0)

    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.fill_between(xs, lo, hi, color="steelblue", alpha=0.4, label=f"{int(confidence*100)}% posterior CR")
    ax.plot(xs, mid, color="steelblue", lw=1.5)

    if plot_prior:
        pspec = config.analysis_config["parameterization"][config.parameterization]
        prior = generate_prior_samples(
            pspec["names"], pspec["min"], pspec["max"], n_samples=min(n_samples, 2000), rng=rng
        )
        qp = np.stack([qhat(prior, config.parameterization, **kw) for kw in eval_kwargs], axis=1)
        plo, phi = np.percentile(qp, [(1 - confidence) / 2 * 100, (1 + confidence) / 2 * 100], axis=0)
        ax.fill_between(xs, plo, phi, color="gray", alpha=0.15, label="prior")

    containment = None
    if target_design_point is not None:
        qt = np.stack(
            [qhat(np.asarray(target_design_point)[None, :], config.parameterization, **kw) for kw in eval_kwargs],
            axis=1,
        )[0]
        ax.plot(xs, qt, "r--", lw=1.5, label="truth")
        containment = (lo <= qt) & (qt <= hi)

    ax.set_xlabel(xlabel)
    ax.set_ylabel(r"$\hat{q}/T^3$")
    ax.set_title(suffix, fontsize=9)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, filename))
    plt.close(fig)
    return containment


def plot_observable_sensitivity(
    flat_chain: np.ndarray, config, plot_dir: str, delta: float = 0.1, device="cuda"
) -> None:
    """Local sensitivity index of every observable bin to each parameter at the
    MAP point: S(x_i, O_j, delta) = [O_j((1+delta) x_i) - O_j(x_i)] / (delta O_j(x_i))
    (reference plot_qhat.py:172-258)."""
    from bayesian_inference_tpu_torch.mcmc.stats import map_parameters
    from bayesian_inference_tpu_torch.models import emulator as emulator_mod
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig

    emulation_config = EmulationConfig.from_config_file(
        analysis_name=config.analysis_name,
        parameterization=config.parameterization,
        analysis_config=config.analysis_config,
        config_file=config.config_file,
        config=config.config,
    )
    results = emulation_config.read_all_emulator_groups()

    theta_map = map_parameters(flat_chain)
    names = config.analysis_config["parameterization"][config.parameterization]["names"]
    n_params = len(names)

    base = emulator_mod.predict(theta_map[None, :], emulation_config,
                                emulation_group_results=results, device=device)["central_value"][0]
    fig, axes = plt.subplots(n_params, 1, figsize=(9, 1.8 * n_params), sharex=True, squeeze=False)
    for i in range(n_params):
        perturbed = np.array(theta_map, copy=True)
        perturbed[i] *= 1.0 + delta
        pred = emulator_mod.predict(perturbed[None, :], emulation_config,
                                    emulation_group_results=results, device=device)["central_value"][0]
        S = (pred - base) / (delta * base)
        ax = axes[i][0]
        ax.bar(np.arange(len(S)), np.clip(S, -5, 5), width=1.0, color="steelblue")
        ax.set_ylabel(names[i], fontsize=7)
        ax.set_ylim(-5, 5)
    axes[-1][0].set_xlabel("observable bin (globally sorted)")
    fig.suptitle(rf"sensitivity index at MAP, $\delta$={delta}", fontsize=10)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "sensitivity_index.pdf"))
    plt.close(fig)
