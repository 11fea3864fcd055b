"""k-fold cross-validation of the GP emulators (port of
``bayesian_inference_tpu.models.cv``).

Per fold: scaler+PCA and GP hyperparameters are refit on the k-1 training
folds only (no leakage), the held-out design points are emulated, and
residuals are standardized by the emulator's own predictive uncertainty
(GP variance propagated through the PC basis + truncation covariance
diagonal, the same uncertainty model the MCMC likelihood uses). Each fold's
fit is the production fit (``gp_fit.fit_gps``, kernel K3 on CUDA) and its
prediction ``gp.predict_all_shared``.

Artifact: ``cross_validation_<group>.h5`` with per-point predictions, truth,
predictive std, fold assignments, and summary metrics. Well-calibrated
emulators give standardized residuals ~ N(0, 1).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Sequence

import numpy as np
import torch

from bayesian_inference_tpu_torch.io import hdf5, observables as obs_io
from bayesian_inference_tpu_torch.models import gp as gp_mod
from bayesian_inference_tpu_torch.models import gp_fit
from bayesian_inference_tpu_torch.models import pca as pca_mod
from bayesian_inference_tpu_torch.models.emulator import default_dtype, resolve_device

logger = logging.getLogger(__name__)


def cross_validate_group(
    group_config,
    k: int | None = None,
    seed: int = 0,
    n_opt_iters: int = 60,
    device="cuda",
    observables: dict[str, Any] | None = None,
    rand_logs: Sequence | None = None,
) -> dict[str, Any]:
    """k-fold CV for one emulation group; returns the artifact dict.

    Design points are shuffled (``default_rng(seed)``) and split into k equal
    folds; a remainder of ``n mod k`` points is left out of every test fold
    (but always trains). Fold f's restart points come from a generator seeded
    with ``seed + f``, or from ``rand_logs[f]`` ((n_pc, n_restarts, P), as
    ``gp_fit.fit_gps`` takes them). ``observables``: the already-read
    observables dict (read from the configured h5 file when None). The fit
    runs on ``device`` in its default dtype (float64 on the CPU, float32 on
    CUDA); the artifact is float64 numpy.
    """
    device = resolve_device(device)
    if k is None:
        k = group_config.cross_validation_k
    if observables is None:
        observables = obs_io.read_observables(group_config.output_dir, group_config.observables_filename)
    Y = obs_io.predictions_matrix_from_h5(
        group_config.output_dir, group_config.observables_filename,
        observable_filter=group_config.observable_filter, observables=observables,
    )
    design = np.asarray(
        obs_io.design_array_from_h5(group_config.output_dir, group_config.observables_filename,
                                    observables=observables),
        float,
    )
    n, F = Y.shape
    if k < 2 or k > n // 2:
        raise ValueError(f"cross_validation_k={k} invalid for {n} design points")
    fold_size = n // k
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = perm[: fold_size * k].reshape(k, fold_size)
    n_pc = group_config.n_pc
    dtype = default_dtype(device)
    spec = group_config.fit_spec(n_iters=n_opt_iters)
    cfg = group_config.kernel_config()

    preds = np.zeros((k, fold_size, F))
    stds = np.zeros((k, fold_size, F))
    truth = np.zeros((k, fold_size, F))
    lml = np.zeros((k, n_pc))

    def on_device(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    for f in range(k):
        test_idx = folds[f]
        train_idx = np.setdiff1d(perm, test_idx)
        state, Y_pca = pca_mod.fit_pca(Y[train_idx], max_n_components=group_config.max_n_components_to_calculate)
        if rand_logs is None:
            fold_draws = {"generator": torch.Generator(device=device).manual_seed(seed + f)}
        else:
            fold_draws = {"rand_logs": on_device(rand_logs[f])}
        posts = gp_fit.fit_gps(spec, on_device(design[train_idx]), on_device(Y_pca[:, :n_pc]), **fold_draws)
        z, v = gp_mod.predict_all_shared(cfg, posts, on_device(design[test_idx]))
        z, v = z.double().cpu().numpy(), v.double().cpu().numpy()

        S_k = state.components[:n_pc]     # (n_pc, F)
        preds[f] = state.unscale_features(z @ S_k)
        # Predictive variance in physical space: GP variance through the PC
        # basis + the truncation covariance diagonal (undivided per-point form,
        # same as the MCMC likelihood).
        trunc_diag = np.diag(pca_mod.truncation_covariance(state, n_pc))
        var_scaled = v @ (S_k**2) + trunc_diag[None, :]
        stds[f] = np.sqrt(var_scaled) * state.scale[None, :]
        truth[f] = Y[test_idx]
        lml[f] = posts.lml.double().cpu().numpy()

    resid = preds - truth
    zscores = resid / np.where(stds > 0, stds, np.inf)
    artifact = {
        "fold_indices": folds,
        "predictions": preds,
        "truth": truth,
        "predictive_std": stds,
        "normalized_residuals": zscores,
        "rmse_per_feature": np.sqrt(np.mean(resid.reshape(-1, F) ** 2, axis=0)),
        "lml_per_fold": lml,
        "k": np.asarray(k),
        "seed": np.asarray(seed),
    }
    z_flat = zscores.ravel()
    logger.info(
        f"CV[{group_config.group_name}]: k={k}, "
        f"RMSE median {np.median(artifact['rmse_per_feature']):.4g}, "
        f"|z| mean {np.abs(z_flat).mean():.3f} (1sigma coverage "
        f"{(np.abs(z_flat) < 1).mean():.2f}, want ~0.68)"
    )
    return artifact


def cross_validate(
    emulation_config,
    seed: int = 0,
    n_opt_iters: int = 60,
    device="cuda",
    observables: dict[str, Any] | None = None,
    write: bool = True,
) -> dict[str, Any]:
    """CV for every group with ``cross_validation: true``; returns {group:
    artifact} and, with ``write``, writes each to
    ``cross_validation_<group>.h5`` in the run directory."""
    device = resolve_device(device)
    out: dict[str, Any] = {}
    for name, group_config in emulation_config.emulation_groups_config.items():
        if not group_config.cross_validation:
            continue
        artifact = cross_validate_group(group_config, seed=seed, n_opt_iters=n_opt_iters, device=device,
                                        observables=observables)
        if write:
            filename = f"cross_validation_{name}.h5"
            hdf5.write_dict_to_h5(artifact, group_config.output_dir, filename, verbose=False)
            logger.info(f"Wrote {os.path.join(group_config.output_dir, filename)}")
        out[name] = artifact
    return out
