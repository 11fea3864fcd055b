"""Emulator diagnostics (reference plot_emulation.py): PCA explained variance,
reconstruction error vs n_pc, emulator-vs-model observables on training and
validation sets, residual scatter + normalized-residual histograms. Carried
over from ``bayesian_inference_tpu.plots.emulation``; the residual plots'
emulator predictions run on ``device``."""

from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from bayesian_inference_tpu_torch.io import observables as obs_io
from bayesian_inference_tpu_torch.models import emulator as emulator_mod
from bayesian_inference_tpu_torch.plots.utils import ensure_plot_dir

logger = logging.getLogger(__name__)


def plot(config, device="cuda") -> None:
    device = emulator_mod.resolve_device(device)
    missing = [
        g.emulation_outputfile
        for g in config.emulation_groups_config.values()
        if not os.path.exists(g.emulation_outputfile)
    ]
    if missing:
        logger.info(f"Missing emulator artifacts {missing}; skipping emulation plots")
        return
    results = config.read_all_emulator_groups()
    plot_dir = ensure_plot_dir(config.output_dir, "plot_emulation")

    for name, art in results.items():
        _plot_pca_explained_variance(art, name, plot_dir)
        _plot_reconstruction_error(art, name, plot_dir)
        _plot_per_feature_reconstruction(art, name, plot_dir)
        _plot_pca_sweep(art, name, plot_dir)
        _plot_pca_reconstruction_observables(config, art, name, plot_dir)

    _plot_residuals(config, results, plot_dir, validation_set=False, device=device)
    _plot_residuals(config, results, plot_dir, validation_set=True, device=device)
    for name in results:
        _plot_cross_validation(config, name, plot_dir)


def _plot_cross_validation(config, name: str, plot_dir: str) -> None:
    """k-fold CV diagnostics from cross_validation_<group>.h5 (models/cv.py):
    held-out predictions vs truth and standardized residuals vs N(0,1)."""
    from bayesian_inference_tpu_torch.io import hdf5

    path = os.path.join(config.output_dir, f"cross_validation_{name}.h5")
    if not os.path.exists(path):
        return
    art = hdf5.read_dict_from_h5(config.output_dir, f"cross_validation_{name}.h5", verbose=False)
    truth = np.asarray(art["truth"]).reshape(-1)
    preds = np.asarray(art["predictions"]).reshape(-1)
    z = np.asarray(art["normalized_residuals"]).reshape(-1)
    k = int(np.asarray(art["k"]))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.plot(truth, preds, ".", ms=1, alpha=0.3)
    lims = [min(truth.min(), preds.min()), max(truth.max(), preds.max())]
    ax1.plot(lims, lims, "k--", lw=1)
    ax1.set_xlabel("model (held-out)")
    ax1.set_ylabel("emulator (CV)")
    ax1.set_title(f"{name}: {k}-fold cross-validation")

    ax2.hist(np.clip(z, -6, 6), bins=80, density=True)
    xs = np.linspace(-5, 5, 200)
    ax2.plot(xs, np.exp(-0.5 * xs**2) / np.sqrt(2 * np.pi), "r--", lw=1, label="N(0,1)")
    cov1 = float((np.abs(z) < 1).mean())
    ax2.set_xlabel("(emulator - model) / sigma  (held-out)")
    ax2.set_title(f"1$\\sigma$ coverage {cov1:.2f} (want ~0.68)")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"cross_validation__{name}.pdf"))
    plt.close(fig)


def _plot_pca_explained_variance(art: dict, name: str, plot_dir: str) -> None:
    evr = np.asarray(art["PCA"]["explained_variance_ratio"])
    n_pc = int(art["n_pc"])
    fig, ax = plt.subplots(figsize=(5, 4))
    xs = np.arange(1, len(evr) + 1)
    ax.plot(xs, np.cumsum(evr), "o-", ms=3)
    ax.axvline(n_pc, color="r", ls="--", label=f"n_pc = {n_pc}")
    ax.set_xlabel("number of principal components")
    ax.set_ylabel("cumulative explained variance")
    ax.set_xscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"pca_explained_variance__{name}.pdf"))
    plt.close(fig)


def _plot_reconstruction_error(art: dict, name: str, plot_dir: str) -> None:
    Y = np.asarray(art["PCA"]["Y"])
    Y_pca = np.asarray(art["PCA"]["Y_pca"])
    comps = np.asarray(art["PCA"]["components"])
    mean, scale = np.asarray(art["PCA"]["mean"]), np.asarray(art["PCA"]["scale"])
    n_max = min(Y_pca.shape[1], comps.shape[0])
    errs = []
    ns = np.unique(np.linspace(1, n_max, 12).astype(int))
    for n in ns:
        recon = (Y_pca[:, :n] @ comps[:n]) * scale + mean
        errs.append(np.sqrt(np.mean((recon - Y) ** 2)))
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(ns, errs, "o-", ms=3)
    ax.axvline(int(art["n_pc"]), color="r", ls="--")
    ax.set_xlabel("n_pc")
    ax.set_ylabel("RMS reconstruction error")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"reconstruction_error__{name}.pdf"))
    plt.close(fig)


def _plot_residuals(config, results: dict, plot_dir: str, validation_set: bool, device) -> None:
    label = "validation" if validation_set else "training"
    try:
        theta = obs_io.design_array_from_h5(
            config.output_dir, config.observables_filename, validation_set=validation_set
        )
        Y_true = obs_io.predictions_matrix_from_h5(
            config.output_dir, config.observables_filename,
            validation_set=validation_set, observable_filter=config.observable_filter,
        )
    except (KeyError, FileNotFoundError, ValueError) as e:
        logger.info(f"Could not load {label} set for residual plots: {e}")
        return

    pred = emulator_mod.predict(np.asarray(theta), config, emulation_group_results=results, device=device)
    mean = pred["central_value"]
    std = np.sqrt(np.maximum(np.einsum("bff->bf", pred["cov"]), 1e-30))

    # The merged prediction spans the GLOBAL sorted feature axis with zeros at
    # observables no group covers; Y_true is filtered to covered observables.
    # Slice predictions to the covered columns (slice-map order == filtered
    # sorted order) so partial-coverage group sets compare correctly.
    if mean.shape[1] != Y_true.shape[1]:
        slice_map = emulator_mod.GroupSliceMap.learn(config)
        cols = np.concatenate([np.arange(e[2].start, e[2].stop) for e in slice_map.entries])
        mean = mean[:, cols]
        std = std[:, cols]

    resid = mean - Y_true
    normed = resid / std

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.plot(Y_true.ravel(), mean.ravel(), ".", ms=1, alpha=0.3)
    lims = [min(Y_true.min(), mean.min()), max(Y_true.max(), mean.max())]
    ax1.plot(lims, lims, "k--", lw=1)
    ax1.set_xlabel("model")
    ax1.set_ylabel("emulator")
    ax1.set_title(f"{label} set")

    ax2.hist(np.clip(normed.ravel(), -6, 6), bins=80, density=True)
    xs = np.linspace(-5, 5, 200)
    ax2.plot(xs, np.exp(-0.5 * xs**2) / np.sqrt(2 * np.pi), "r--", lw=1, label="N(0,1)")
    ax2.set_xlabel("(emulator - model) / sigma")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"residuals__{label}.pdf"))
    plt.close(fig)


def _plot_per_feature_reconstruction(art: dict, name: str, plot_dir: str) -> None:
    """Per-feature relative reconstruction error at the configured n_pc
    (reference plot_emulation.py:121-226)."""
    Y = np.asarray(art["PCA"]["Y"])
    recon = np.asarray(art["PCA"]["Y_reconstructed_truncated_unscaled"])
    rel = np.sqrt(np.mean(((recon - Y) / Y) ** 2, axis=0))
    fig, ax = plt.subplots(figsize=(9, 3.2))
    ax.bar(np.arange(rel.size), rel, width=1.0, color="steelblue")
    ax.set_xlabel("feature (observable bin, group-sorted)")
    ax.set_ylabel("RMS relative reconstruction error")
    ax.set_title(f"{name} (n_pc = {int(art['n_pc'])})", fontsize=9)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"per_feature_reconstruction__{name}.pdf"))
    plt.close(fig)


def _plot_pca_sweep(art: dict, name: str, plot_dir: str, n_pcs=(1, 2, 5, 10, 20)) -> None:
    """Observables reconstructed with increasing numbers of PCs
    (reference plot_emulation.py:230-291): per-feature error quantiles vs n_pc."""
    Y = np.asarray(art["PCA"]["Y"])
    Y_pca = np.asarray(art["PCA"]["Y_pca"])
    comps = np.asarray(art["PCA"]["components"])
    mean, scale = np.asarray(art["PCA"]["mean"]), np.asarray(art["PCA"]["scale"])
    fig, ax = plt.subplots(figsize=(6, 4))
    n_max = min(Y_pca.shape[1], comps.shape[0])
    for q, color in ((50, "steelblue"), (90, "darkorange")):
        errs = []
        ns = [n for n in n_pcs if n <= n_max]
        for n in ns:
            recon = (Y_pca[:, :n] @ comps[:n]) * scale + mean
            errs.append(np.percentile(np.abs((recon - Y) / Y), q))
        ax.plot(ns, errs, "o-", label=f"{q}th percentile |rel err|", color=color)
    ax.axvline(int(art["n_pc"]), color="r", ls="--", label=f"n_pc = {int(art['n_pc'])}")
    ax.set_xlabel("number of principal components")
    ax.set_ylabel("relative reconstruction error")
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"pca_sweep__{name}.pdf"))
    plt.close(fig)

def _plot_pca_reconstruction_observables(config, art: dict, name: str, plot_dir: str) -> None:
    """Per-observable panels of the observables BEFORE vs AFTER PCA truncation
    (reference plot_emulation.py:230-250 _plot_pca_reconstruction_observables
    and :252-291 .._per_n_pc): one subplot per observable via the shared
    ``observable_panels`` machinery. Where the reference draws one design
    point's curve per n_pc, the ensemble here is summarized as the median +
    5-95% band over ALL design points (observable_panels semantics) — same
    information, tighter panels. Two artifacts per group: the fitted-n_pc
    before/after overlay, and a truncation sweep."""
    from bayesian_inference_tpu_torch.io import hdf5
    from bayesian_inference_tpu_torch.plots.utils import observable_panels

    group_cfg = config.emulation_groups_config[name]
    observables = hdf5.read_dict_from_h5(
        config.output_dir, config.observables_filename, verbose=False
    )
    sorted_labels = obs_io.sorted_observable_list_from_dict(
        observables, observable_filter=group_cfg.observable_filter
    )
    Y = np.asarray(art["PCA"]["Y"])
    Y_pca = np.asarray(art["PCA"]["Y_pca"])
    comps = np.asarray(art["PCA"]["components"])
    mean, scale = np.asarray(art["PCA"]["mean"]), np.asarray(art["PCA"]["scale"])
    n_pc = int(art["n_pc"])
    n_max = min(Y_pca.shape[1], comps.shape[0])

    def recon(n: int) -> np.ndarray:
        return (Y_pca[:, :n] @ comps[:n]) * scale + mean

    observable_panels(
        plot_list=[{"central_value": Y}, {"central_value": recon(min(n_pc, n_max))}],
        labels=["model (before PCA)", f"after PCA (n_pc = {n_pc})"],
        colors=["gray", "steelblue"],
        config=config,
        plot_dir=plot_dir,
        filename=f"pca_observables__{name}.pdf",
        observables=observables,
        sorted_labels=sorted_labels,
        plot_exp_data=False,
    )

    ns = sorted({n for n in (1, 2, 5, 10, n_pc) if n <= n_max})
    cmap = plt.get_cmap("magma")
    observable_panels(
        plot_list=[{"central_value": Y}] + [{"central_value": recon(n)} for n in ns],
        labels=["model (before PCA)"] + [f"PCA {n}" for n in ns],
        colors=["gray"] + [cmap(f) for f in np.linspace(0.25, 0.8, len(ns))],
        config=config,
        plot_dir=plot_dir,
        filename=f"pca_observables_sweep__{name}.pdf",
        observables=observables,
        sorted_labels=sorted_labels,
        plot_exp_data=False,
    )
