"""Emulator stack: per-group PCA + GP fit, persistence, group-merged prediction.

Port of ``bayesian_inference_tpu.models.emulator``. Each emulation group
(disjoint observable subset) gets its own scaler+PCA and one GP per retained
principal component. Artifacts are the same plain dicts of numpy arrays,
pickled to ``emulation_group_<name>.pkl``, so the two packages read each
other's fits. Functions that would read ``observables.h5`` also take the
already-read observables dict.

Merged predictions follow the reference's convention: central values are
inserted at the globally sorted feature slices, and the covariance keeps
only the per-observable diagonal blocks (the reference's
SortEmulationGroupObservables.convert, emulation.py:346-406).
"""

from __future__ import annotations

import logging
import os
import pickle
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from bayesian_inference_tpu_torch.io import observables as obs_io
from bayesian_inference_tpu_torch.models import gp_fit
from bayesian_inference_tpu_torch.models import pca as pca_mod
from bayesian_inference_tpu_torch.models.gp import GPPosterior, predict_all_shared
from bayesian_inference_tpu_torch.ops.gram import KernelConfig, KernelParams
from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig, EmulationGroupConfig
from bayesian_inference_tpu_torch.utils import profiling

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
        and (a.halving_iters, a.halving_keep) == (b.halving_iters, b.halving_keep)
        and tuple(map(tuple, a.halving_schedule)) == tuple(map(tuple, b.halving_schedule))
        and tuple(a.trial_steps) == tuple(b.trial_steps)
        and np.array_equal(a.theta0, b.theta0)
        and np.array_equal(a.log_lo, b.log_lo)
        and np.array_equal(a.log_hi, b.log_hi)
    )


def _fit_batch(
    group_configs: dict[str, EmulationGroupConfig], preps: dict[str, dict[str, Any]], seed: int, device
) -> dict[str, dict[str, Any]]:
    """One fit of the PCs of the groups in ``preps`` (all of the same fit
    settings) on ``device``: float64 on the CPU, float32 on CUDA, where the
    fit's blocked Cholesky runs K3. Returns {group name: artifact}."""
    dtype = default_dtype(device)
    names = list(preps)
    Y_all = np.concatenate([preps[n]["Y_pca_truncated"] for n in names], axis=1)
    design = torch.as_tensor(preps[names[0]]["design"], dtype=dtype, device=device)
    Y_t = torch.as_tensor(Y_all, dtype=dtype, device=device)
    spec = preps[names[0]]["spec"]
    logger.info(
        f"GP fit: {Y_all.shape[1]} PCs across {len(names)} groups x "
        f"{spec.n_restarts + 1} restarts (design: {tuple(design.shape)})..."
    )
    posts = gp_fit.fit_gps(spec, design, Y_t, generator=torch.Generator(device=device).manual_seed(seed))
    artifacts: dict[str, dict[str, Any]] = {}
    offset = 0
    with profiling.annotate("fit.artifacts"):
        for n in names:
            k = preps[n]["n_pc"]
            artifacts[n] = _artifact_from_fit(group_configs[n], preps[n], _host(posts, slice(offset, offset + k)))
            offset += k
    return artifacts


def fit_emulator_group(
    config: EmulationGroupConfig,
    seed: int = 0,
    n_opt_iters: int = 60,
    device="cuda",
    observables: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """PCA + GP fit of one emulation group on ``device``; returns its artifact
    (nothing is written), or {} when the output file already exists and
    force_retrain is False. ``observables``: the already-read observables
    dict (read from the configured h5 file when None)."""
    device = resolve_device(device)
    if not _fit_gate_open(config):
        return {}
    if observables is None:
        observables = obs_io.read_observables(config.output_dir, config.observables_filename)
    name = config.group_name or ""
    return _fit_batch({name: config}, {name: _prepare_group(config, n_opt_iters, observables)}, seed, device)[name]


@profiling.annotate("fit_emulators")
def fit_emulators(
    emulation_config: EmulationConfig,
    seed: int = 0,
    n_opt_iters: int = 60,
    device="cuda",
    observables: dict[str, Any] | None = None,
    write: bool = True,
) -> dict[str, dict[str, Any]]:
    """Fit every pending emulation group; returns {group name: artifact} of
    the groups it fitted (a group whose pickle exists is skipped unless
    force_retrain).

    When all pending groups share identical fit settings (the common case),
    their PCs are fitted in one fused batch, in float64 on the CPU and
    float32 on CUDA. ``observables``: the
    already-read observables dict (read from the configured h5 file when
    None). ``write=False`` keeps the artifacts in memory only.
    """
    device = resolve_device(device)
    pending: dict[str, dict[str, Any]] = {}
    for name, group_config in emulation_config.emulation_groups_config.items():
        if _fit_gate_open(group_config):
            with profiling.annotate("fit.prepare"):
                if observables is None:
                    observables = obs_io.read_observables(group_config.output_dir, group_config.observables_filename)
                pending[name] = _prepare_group(group_config, n_opt_iters, observables)
    if not pending:
        return {}

    names = list(pending)
    specs = [pending[n]["spec"] for n in names]
    fuse = all(_specs_compatible(specs[0], s) for s in specs[1:])
    batches = [names] if fuse else [[n] for n in names]

    artifacts: dict[str, dict[str, Any]] = {}
    for batch in batches:
        fitted = _fit_batch(emulation_config.emulation_groups_config, {n: pending[n] for n in batch}, seed, device)
        for n, artifact in fitted.items():
            if write:
                write_emulators(emulation_config.emulation_groups_config[n], artifact)
        artifacts.update(fitted)
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

    def merge(self, group_matrices: dict[str, dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        """Merge per-group predictions into global arrays (reference convert()).

        central_value: (B, n_features); cov: block-diagonal per observable,
        (B, n_features, n_features).
        """
        out: dict[str, np.ndarray] = {}
        value_types = {vt for g in group_matrices.values() for vt in g}

        if "central_value" in value_types:
            B = next(iter(group_matrices.values()))["central_value"].shape[0]
            merged = np.zeros((B, self.n_features))
            for _, group, g_slice, grp_slice in self.entries:
                merged[:, g_slice] = group_matrices[group]["central_value"][:, grp_slice]
            out["central_value"] = merged

        if "cov" in value_types:
            B = next(iter(group_matrices.values()))["cov"].shape[0]
            cov = np.zeros((B, self.n_features, self.n_features))
            for _, group, g_slice, grp_slice in self.entries:
                cov[:, g_slice, g_slice] = group_matrices[group]["cov"][:, grp_slice, grp_slice]
            out["cov"] = cov
        return out


def predict_emulation_group(
    parameters: np.ndarray,
    results: dict[str, Any],
    n_pc: int | None = None,
    emulator_group_cov_unexplained: np.ndarray | None = None,
    scale_cov_unexplained_by_n_samples: bool = True,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Emulator central values and covariance of one group at ``parameters`` (B, d).

    central_value: (B, F) = unscale(z @ S_k); cov: (B, F, F) =
    scale x [S_k diag(v) S_k^T + Sigma_unexplained (/B)] x scale, both
    float64 numpy, as the JAX package returns them. The GP predict (z, v) and
    the covariance run on ``device`` (float32 on CUDA, float64 on the CPU);
    the central values are host float64 math on the downloaded z.

    ``scale_cov_unexplained_by_n_samples`` reproduces the reference's division
    of the truncation covariance by the number of prediction samples
    (emulation.py:531-532). In the reference's production MCMC each walker is a
    separate call (B=1), so the likelihood path uses the undivided form; keep
    the flag True only for API parity with reference batch predictions.

    Memory: the covariance is B * F^2 values, 4 * F^2 bytes per point on the
    card (10.8 MB at F = 1,644) and 8 * F^2 on the host; B is not chunked.
    """
    device = resolve_device(device)
    if n_pc is None:
        n_pc = int(results["n_pc"])
    state = pca_state_from_artifact(results)
    if emulator_group_cov_unexplained is None:
        emulator_group_cov_unexplained = pca_mod.truncation_covariance(state, n_pc)
    cfg, posts = posterior_from_artifact(results, device)
    dtype = posts.alpha.dtype

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    z, v = predict_all_shared(cfg, posts, t(parameters))  # (B, k), (B, k)
    S_k = state.components[:n_pc]                         # (k, F)
    mean = state.unscale_features(z.cpu().numpy() @ S_k)

    B = np.asarray(parameters).shape[0]
    S = t(S_k)
    cov = torch.einsum("kf,bk,kg->bfg", S, v, S)
    sigma = emulator_group_cov_unexplained / B if scale_cov_unexplained_by_n_samples else emulator_group_cov_unexplained
    cov += t(sigma)[None, :, :]
    cov *= t(np.outer(state.scale, state.scale))[None, :, :]
    return {"central_value": mean, "cov": cov.cpu().numpy().astype(np.float64, copy=False)}


def predict(
    parameters: np.ndarray,
    emulation_config: EmulationConfig,
    merge_predictions_over_groups: bool = True,
    emulation_group_results: dict[str, dict[str, Any]] | None = None,
    emulator_cov_unexplained: dict[str, np.ndarray] | None = None,
    slice_map: GroupSliceMap | None = None,
    scale_cov_unexplained_by_n_samples: bool = True,
    device="cuda",
    observables: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Emulator predictions of every group at ``parameters`` (B, d), merged
    over the groups (reference predict(), emulation.py:410-462), or
    {group name: prediction} without the merge. Each group's prediction is
    ``predict_emulation_group`` on ``device``. ``observables``: the
    already-read observables dict for the slice map (read from the configured
    h5 file when None). The merged covariance is (B, n_features, n_features)
    float64 on the host, 8 * n_features^2 bytes per point beside the groups'.
    """
    device = resolve_device(device)
    if emulation_group_results is None:
        emulation_group_results = emulation_config.read_all_emulator_groups()
    if emulator_cov_unexplained is None:
        emulator_cov_unexplained = compute_emulator_cov_unexplained(emulation_config, emulation_group_results)

    per_group = {
        name: predict_emulation_group(
            parameters,
            emulation_group_results[name],
            n_pc=cfg.n_pc,
            emulator_group_cov_unexplained=emulator_cov_unexplained[name],
            scale_cov_unexplained_by_n_samples=scale_cov_unexplained_by_n_samples,
            device=device,
        )
        for name, cfg in emulation_config.emulation_groups_config.items()
    }
    if not merge_predictions_over_groups:
        return per_group
    if slice_map is None:
        slice_map = GroupSliceMap.learn(emulation_config, observables=observables)
    return slice_map.merge(per_group)
