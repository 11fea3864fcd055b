"""Emulator stack: per-group PCA + GP fit, persistence, group-merged layout.

Port of ``bayesian_inference_tpu.models.emulator``. Each emulation group
(disjoint observable subset) gets its own scaler+PCA and one GP per retained
principal component. Artifacts are the same plain dicts of numpy arrays,
pickled to ``emulation_group_<name>.pkl``, so the two packages read each
other's fits. Functions that would read ``observables.h5`` also take the
already-read observables dict.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from bayesian_inference_tpu_torch.io import observables as obs_io
from bayesian_inference_tpu_torch.models import gp_fit
from bayesian_inference_tpu_torch.models import pca as pca_mod
from bayesian_inference_tpu_torch.models.gp import GPPosterior
from bayesian_inference_tpu_torch.ops.gram import KernelConfig, KernelParams
from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig, EmulationGroupConfig

logger = logging.getLogger(__name__)


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU (parity tests), float32 on CUDA."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. The entry points default to
    ``"cuda"``; where torch finds no card that raises, and nothing falls back
    to the CPU: pass ``device="cpu"`` for that."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: torch finds no CUDA device; pass device='cpu' to run on the CPU")
    return device


def _fit_gate_open(config: EmulationGroupConfig) -> bool:
    """True when this group needs (re)fitting; removes stale output when forced."""
    if os.path.exists(config.emulation_outputfile):
        if config.force_retrain:
            os.remove(config.emulation_outputfile)
            logger.info(f"Removed {config.emulation_outputfile}")
        else:
            logger.info(f"Emulators already exist: {config.emulation_outputfile}")
            return False
    return True


def _prepare_group(config: EmulationGroupConfig, n_opt_iters: int, observables: dict[str, Any]) -> dict[str, Any]:
    """Host-side setup for one group from the already-read observables:
    prediction matrix, PCA, design, fit spec."""
    Y = obs_io.predictions_matrix_from_h5(
        config.output_dir, filename=config.observables_filename,
        observable_filter=config.observable_filter, observables=observables,
    )
    state, Y_pca = pca_mod.fit_pca(Y, max_n_components=config.max_n_components_to_calculate)
    n_pc = config.n_pc
    logger.info(f"Variance explained by first {n_pc} components: {state.explained_variance_ratio[:n_pc].sum()}")
    return {
        "Y": Y,
        "state": state,
        "Y_pca": Y_pca,
        "Y_pca_truncated": Y_pca[:, :n_pc],
        "design": np.asarray(observables["Design"]),
        "spec": config.fit_spec(n_iters=n_opt_iters),
        "n_pc": n_pc,
    }


def _host(posts: GPPosterior, sl: slice) -> dict[str, np.ndarray]:
    return {
        "log_length_scale": posts.params.log_length_scale[sl].cpu().numpy(),
        "log_noise": posts.params.log_noise[sl].cpu().numpy(),
        "log_constant": posts.params.log_constant[sl].cpu().numpy(),
        "alpha": posts.alpha[sl].cpu().numpy(),
        "Kinv": posts.Kinv[sl].cpu().numpy(),
        "prior_var": posts.prior_var[sl].cpu().numpy(),
        "lml": posts.lml[sl].cpu().numpy(),
    }


def _artifact_from_fit(config: EmulationGroupConfig, prep: dict[str, Any], fit: dict[str, np.ndarray]) -> dict[str, Any]:
    state = prep["state"]
    n_pc = prep["n_pc"]
    Y_pca_truncated = np.asarray(prep["Y_pca_truncated"])
    Y_recon = Y_pca_truncated @ state.components[:n_pc]
    cfg = config.kernel_config()
    for i, lml in enumerate(fit["lml"]):
        ls = np.exp(fit["log_length_scale"][i]).round(3)
        logger.info(f"  PC {i}: LML={lml:.3f} ls={ls} noise={np.exp(fit['log_noise'][i]):.4f}")
    return {
        "PCA": {
            "Y": np.asarray(prep["Y"]),
            "Y_pca": np.asarray(prep["Y_pca"]),
            "Y_pca_truncated": Y_pca_truncated,
            "Y_reconstructed_truncated": Y_recon,
            "Y_reconstructed_truncated_unscaled": state.unscale_features(Y_recon),
            **state.to_host_dict(),
        },
        "emulators": {
            "kernel": {"nu": cfg.nu, "with_noise": cfg.with_noise, "with_constant": cfg.with_constant},
            "alpha_jitter": config.alpha,
            "X": np.asarray(prep["design"]),
            "params": {k: fit[k] for k in ("log_length_scale", "log_noise", "log_constant")},
            **{k: fit[k] for k in ("alpha", "Kinv", "prior_var", "lml")},
        },
        "n_pc": n_pc,
    }


def _specs_compatible(a: gp_fit.GPFitSpec, b: gp_fit.GPFitSpec) -> bool:
    return (
        a.cfg == b.cfg
        and a.n_restarts == b.n_restarts
        and a.n_iters == b.n_iters
        and a.alpha_jitter == b.alpha_jitter
        and np.array_equal(a.theta0, b.theta0)
        and np.array_equal(a.log_lo, b.log_lo)
        and np.array_equal(a.log_hi, b.log_hi)
    )


def fit_emulators(
    emulation_config: EmulationConfig,
    seed: int = 0,
    n_opt_iters: int = 60,
    device="cuda",
    observables: dict[str, Any] | None = None,
    write: bool = True,
) -> dict[str, dict[str, Any]]:
    """Fit every pending emulation group; returns {group name: artifact}.

    When all pending groups share identical fit settings (the common case),
    their PCs are fitted in one fused batch, in float64 on the CPU and
    float32 on CUDA. ``observables``: the
    already-read observables dict (read from the configured h5 file when
    None). ``write=False`` keeps the artifacts in memory only.
    """
    device = resolve_device(device)
    dtype = default_dtype(device)
    t0 = time.perf_counter()
    pending: dict[str, dict[str, Any]] = {}
    for name, group_config in emulation_config.emulation_groups_config.items():
        if _fit_gate_open(group_config):
            if observables is None:
                observables = obs_io.read_observables(group_config.output_dir, group_config.observables_filename)
            pending[name] = _prepare_group(group_config, n_opt_iters, observables)
    if not pending:
        return {}
    logger.info(f"fit stage: ingest+PCA prep {time.perf_counter() - t0:.2f}s")

    names = list(pending)
    specs = [pending[n]["spec"] for n in names]
    fuse = all(_specs_compatible(specs[0], s) for s in specs[1:])
    batches = [names] if fuse else [[n] for n in names]

    artifacts: dict[str, dict[str, Any]] = {}
    for batch in batches:
        Y_all = np.concatenate([pending[n]["Y_pca_truncated"] for n in batch], axis=1)
        design = torch.as_tensor(pending[batch[0]]["design"], dtype=dtype, device=device)
        Y_t = torch.as_tensor(Y_all, dtype=dtype, device=device)
        spec = pending[batch[0]]["spec"]
        logger.info(
            f"GP fit: {Y_all.shape[1]} PCs across {len(batch)} groups x "
            f"{spec.n_restarts + 1} restarts (design: {tuple(design.shape)})..."
        )
        gen = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        posts = gp_fit.fit_gps(spec, design, Y_t, generator=gen)
        offset = 0
        for n in batch:
            k = pending[n]["n_pc"]
            group_cfg = emulation_config.emulation_groups_config[n]
            artifacts[n] = _artifact_from_fit(group_cfg, pending[n], _host(posts, slice(offset, offset + k)))
            if write:
                write_emulators(group_cfg, artifacts[n])
            offset += k
        logger.info(f"fit stage: fit_gps + artifacts {time.perf_counter() - t0:.2f}s")
    return artifacts


def write_emulators(config: EmulationGroupConfig, artifact: dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(config.emulation_outputfile), exist_ok=True)
    with open(config.emulation_outputfile, "wb") as f:
        pickle.dump(artifact, f)


def read_emulators(config: EmulationGroupConfig) -> dict[str, Any]:
    with open(config.emulation_outputfile, "rb") as f:
        return pickle.load(f)


def posterior_from_artifact(
    artifact: dict[str, Any], device="cuda", dtype: torch.dtype | None = None
) -> tuple[KernelConfig, GPPosterior]:
    """The stacked GPPosterior (leading axis = PC) of an artifact written by
    either package, on ``device`` in ``dtype``."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    em = artifact["emulators"]

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    posts = GPPosterior(
        params=KernelParams(*(t(em["params"][k]) for k in ("log_length_scale", "log_noise", "log_constant"))),
        X=t(em["X"]),
        alpha=t(em["alpha"]),
        Kinv=t(em["Kinv"]),
        prior_var=t(em["prior_var"]),
        lml=t(em["lml"]),
    )
    return KernelConfig(**em["kernel"]), posts


def pca_state_from_artifact(artifact: dict[str, Any]) -> pca_mod.PCAState:
    p = artifact["PCA"]
    return pca_mod.PCAState(
        **{k: np.asarray(p[k]) for k in (
            "mean", "scale", "components", "explained_variance", "explained_variance_ratio", "singular_values",
        )}
    )


def compute_emulator_group_cov_unexplained(
    emulation_group_config: EmulationGroupConfig, emulation_group_result: dict[str, Any]
) -> np.ndarray:
    """Sigma_unexplained in *scaled* feature space (eqs 21-22 of arXiv:2102.11337)."""
    state = pca_state_from_artifact(emulation_group_result)
    return pca_mod.truncation_covariance(state, emulation_group_config.n_pc)


def compute_emulator_cov_unexplained(
    emulation_config: EmulationConfig, emulation_results: dict[str, Any] | None = None
) -> dict[str, np.ndarray]:
    if not emulation_results:
        emulation_results = emulation_config.read_all_emulator_groups()
    return {
        name: compute_emulator_group_cov_unexplained(cfg, emulation_results[name])
        for name, cfg in emulation_config.emulation_groups_config.items()
    }


@dataclass
class GroupSliceMap:
    """Mapping from per-group feature matrices to the globally sorted observable matrix.

    entries: per observable (in global sorted order):
        (observable_label, group_name, global_slice, group_slice)
    n_features: total global feature count.
    """

    entries: list[tuple[str, str, slice, slice]]
    n_features: int

    @classmethod
    def learn(cls, emulation_config: EmulationConfig, observables: dict[str, Any] | None = None) -> "GroupSliceMap":
        """Learn the map from the configured observables file, or from the
        already-read ``observables`` dict."""
        if observables is None:
            observables = obs_io.read_observables(emulation_config.output_dir, emulation_config.observables_filename)
        pred = observables["Prediction"]

        global_slices: dict[str, slice] = {}
        pos = 0
        for label in obs_io.sorted_observable_list_from_dict(pred):
            n_bins = np.atleast_2d(pred[label]["y"]).shape[0]
            global_slices[label] = slice(pos, pos + n_bins)
            pos += n_bins

        by_label: dict[str, tuple[str, slice, slice]] = {}
        for group_name, group_cfg in emulation_config.emulation_groups_config.items():
            group_pos = 0
            for label in obs_io.sorted_observable_list_from_dict(pred, observable_filter=group_cfg.observable_filter):
                g_slice = global_slices[label]
                width = g_slice.stop - g_slice.start
                by_label[label] = (group_name, g_slice, slice(group_pos, group_pos + width))
                group_pos += width

        entries = [(label, *by_label[label]) for label in global_slices if label in by_label]
        return cls(entries=entries, n_features=pos)
