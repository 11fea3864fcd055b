"""Input-data preprocessing: statistical-outlier detection and smoothing
(host numpy/scipy, carried over from
``bayesian_inference_tpu.preprocess.outliers``).

Behavioral contract mirrors the reference preprocess_input_data.py: two outlier
finders — (a) large relative statistical error vs. the RMS over design points,
(b) large central-value jumps between adjacent bins with AND-of-neighbors and
special edge handling — followed by a quality gate (runs of more than
``max_n_feature_outliers_to_interpolate`` consecutive outlier bins are not
interpolated and are reported as design-point exclusion candidates) and
linear / cubic-spline interpolation over the remaining good bins.

``preprocess`` reads ``observables.h5`` from the run directory, or smooths
the already-read observables dict it is given.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import numpy.typing as npt
import scipy.interpolate

from bayesian_inference_tpu_torch.io import observables as obs_io
from bayesian_inference_tpu_torch.io.observables import sorted_observable_list_from_dict
from bayesian_inference_tpu_torch.pipeline.configs import PreprocessingConfig

logger = logging.getLogger(__name__)


def preprocess(preprocessing_config: PreprocessingConfig, observables: dict[str, Any] | None = None) -> dict[str, Any]:
    """Full preprocessing: smoothing of both outlier classes, train + validation.
    ``observables``: the already-read observables dict (read from the run
    directory's observables.h5 when None)."""
    return smooth_statistical_outliers_in_predictions(preprocessing_config, observables)


def smooth_statistical_outliers_in_predictions(
    preprocessing_config: PreprocessingConfig,
    observables: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Smoothed copy of observables.h5 contents (reference :103-157 flow:
    first the large-statistical-error pass, then the central-value-difference
    pass applied on top of the already-smoothed values)."""
    logger.info("Smoothing outliers in predictions...")
    all_observables = (
        obs_io.read_observables(str(preprocessing_config.output_dir), "observables.h5")
        if observables is None else observables
    )

    new_observables: dict[str, Any] = {}
    for validation_set in (False, True):
        new_observables.update(
            _smooth_predictions(
                all_observables, validation_set, preprocessing_config, method="large_statistical_errors"
            )
        )
    # Carry over everything that isn't smoothed (Data, Design, indices, ...)
    for key, value in all_observables.items():
        if key not in new_observables:
            new_observables[key] = value
    for validation_set in (False, True):
        new_observables.update(
            _smooth_predictions(
                new_observables, validation_set, preprocessing_config, method="large_central_value_difference"
            )
        )
    return new_observables


def find_physics_motivated_outliers(
    observables: dict[str, Any],
    validation_set: bool = False,
    raa_min: float = -0.2,
    raa_max: float = 1.3,
) -> dict[str, set[int]]:
    """Ad-hoc physics checks on RAA-like observables (reference
    preprocess_input_data.py:46-100, dormant there as well): hadron / inclusive
    jet ratios should not be strongly negative or far above unity. Returns
    {observable_label: design-point column indices violating the bounds}.
    """
    prediction_key = "Prediction_validation" if validation_set else "Prediction"
    suspects: dict[str, set[int]] = {}
    for label in sorted_observable_list_from_dict(observables[prediction_key]):
        keys = label.split("__")
        observable_type, observable = keys[2], keys[3]
        is_raa = observable_type in ("hadron", "inclusive_chjet", "inclusive_jet") and not any(
            sub in observable for sub in ("Dz", "tg", "zg")
        )
        if not is_raa:
            continue
        y = np.atleast_2d(observables[prediction_key][label]["y"])
        bad = np.where((y < raa_min) | (y > raa_max))[1]
        if bad.size:
            suspects[label] = set(int(i) for i in bad)
    if suspects:
        all_points = sorted({i for s in suspects.values() for i in s})
        logger.warning(f"physics-motivated outlier candidates (design columns): {all_points}")
    return suspects


def find_large_statistical_uncertainty_points(
    values: npt.NDArray[np.float64],
    y_err: npt.NDArray[np.float64],
    n_RMS: float,
) -> tuple[npt.NDArray[np.intp], npt.NDArray[np.intp]]:
    """Bins whose relative statistical error exceeds n_RMS x the per-feature RMS
    over design points. Returns (feature_indices, design_indices)."""
    relative_error = y_err / values
    rms = np.sqrt(np.mean(relative_error**2, axis=-1))
    return np.where(relative_error > n_RMS * rms[:, None])


def find_outliers_based_on_central_values(
    values: npt.NDArray[np.float64],
    n_RMS: float,
) -> tuple[npt.NDArray[np.intp], npt.NDArray[np.intp]]:
    """Bins whose central value jumps vs BOTH neighbors exceed n_RMS x the RMS
    of adjacent-bin differences; edges validated by re-running with the 1st and
    second-to-last bins removed and AND-ing with the one-sided test."""
    diffs = np.abs(np.diff(values, axis=0))
    rms = np.sqrt(np.mean(diffs**2, axis=-1))
    jump = diffs > n_RMS * rms[:, None]

    flagged = np.zeros_like(values, dtype=bool)
    flagged[1:-1, :] = jump[:-1, :] & jump[1:, :]

    if values.shape[0] > 4:
        keep = np.ones(values.shape[0], dtype=bool)
        keep[1] = False
        keep[-2] = False
        edge_diffs = np.abs(np.diff(values[keep, :], axis=0))
        edge_rms = np.sqrt(np.mean(edge_diffs**2, axis=-1))
        edge_jump = edge_diffs > n_RMS * edge_rms[:, None]
        flagged[0, :] = edge_jump[0, :] & jump[0, :]
        flagged[-1, :] = edge_jump[-1, :] & jump[-1, :]
    else:
        flagged[0, :] = jump[0, :]
        flagged[-1, :] = jump[-1, :]

    return np.where(flagged)


def gate_consecutive_outliers(
    outliers: tuple[npt.NDArray[np.intp], npt.NDArray[np.intp]],
    max_consecutive: int,
) -> tuple[dict[int, list[int]], dict[int, set[int]]]:
    """Split flagged bins into interpolatable vs. un-fixable per design point.

    Runs of consecutive flagged bins longer than ``max_consecutive`` are not
    interpolated (too little anchoring information); they are returned in the
    second dict as exclusion candidates. Matches reference
    _perform_QA_and_reformat_outliers (:313-407).
    """
    per_design: dict[int, list[int]] = {}
    for feat, design in zip(*outliers):
        per_design.setdefault(int(design), []).append(int(feat))

    to_interpolate: dict[int, list[int]] = {}
    unfixable: dict[int, set[int]] = {}
    for design, feats in per_design.items():
        feats = sorted(set(feats))
        removed: set[int] = set()
        run: set[int] = set()
        for lo, hi in zip(feats[:-1], feats[1:]):
            if hi - lo == 1:
                run.update((lo, hi))
            else:
                if len(run) > max_consecutive:
                    removed.update(run)
                run = set()
        if len(run) > max_consecutive:
            removed.update(run)

        to_interpolate[design] = sorted(set(feats) - removed)
        if removed:
            unfixable[design] = removed
    return to_interpolate, unfixable


def _smooth_predictions(
    all_observables: dict[str, Any],
    validation_set: bool,
    config: PreprocessingConfig,
    method: str,
) -> dict[str, Any]:
    prediction_key = "Prediction_validation" if validation_set else "Prediction"
    out: dict[str, Any] = {prediction_key: {}}
    unremovable: dict[str, dict[int, set[int]]] = {}

    for label in sorted_observable_list_from_dict(all_observables[prediction_key]):
        values = np.atleast_2d(all_observables[prediction_key][label]["y"])
        if method == "large_statistical_errors":
            outliers = find_large_statistical_uncertainty_points(
                values, np.atleast_2d(all_observables[prediction_key][label]["y_err"]), config.outlier_n_RMS
            )
        elif method == "large_central_value_difference":
            if values.shape[0] > 2:
                outliers = find_outliers_based_on_central_values(values, config.outlier_n_RMS)
            else:
                outliers = (np.array([], dtype=np.intp), np.array([], dtype=np.intp))
        else:
            raise ValueError(f"Unrecognized outlier identification method {method}")

        to_interpolate, unfixable = gate_consecutive_outliers(
            outliers, config.max_n_feature_outliers_to_interpolate
        )
        if unfixable:
            unremovable.setdefault(label, {}).update(unfixable)

        data = all_observables["Data"][label]
        centers = data["xmin"] + (data["xmax"] - data["xmin"]) / 2.0

        entry: dict[str, npt.NDArray] = {}
        for key_type in ("y", "y_err"):
            arr = np.array(np.atleast_2d(all_observables[prediction_key][label][key_type]), copy=True)
            entry[key_type] = arr
            if len(centers) == 1:
                continue  # cannot interpolate a single-bin observable
            for design, points in to_interpolate.items():
                if not points:
                    continue
                good = np.ones_like(centers, dtype=bool)
                good[points] = False
                if good.sum() == 1:
                    logger.info(
                        f"Skipping {label} design {design}: only one anchor point for interpolation"
                    )
                    unremovable.setdefault(label, {}).setdefault(design, set()).update(points)
                    continue
                if config.interpolation_method == "linear":
                    interp = np.interp(centers[points], centers[good], arr[good, design])
                else:
                    cs = scipy.interpolate.CubicSpline(centers[good], arr[good, design])
                    interp = cs(centers[points])
                arr[points, design] = interp
        out[prediction_key][label] = entry

    # Report which actual design points (by id) we might want to exclude
    ids_key = "Design_indices_validation" if validation_set else "Design_indices"
    if ids_key in all_observables:
        ids = np.asarray(all_observables[ids_key])
    else:  # older files without stored ids: fall back to positional indices
        n = np.atleast_2d(
            all_observables["Design_validation" if validation_set else "Design"]
        ).shape[0]
        ids = np.arange(n)
    candidates: dict[int, dict[str, set[int]]] = {}
    for label, per_design in unremovable.items():
        for i_design, feats in per_design.items():
            actual = int(ids[i_design])
            candidates.setdefault(actual, {}).setdefault(label, set()).update(feats)
    logger.warning(
        f"Method: {method}, design points we may want to remove: {sorted(candidates)}, "
        f"length: {len(candidates)}"
    )
    return out
