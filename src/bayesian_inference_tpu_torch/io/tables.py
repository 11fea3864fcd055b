"""Ingest of JETSCAPE-STAT .dat tables into the canonical observables dict
(host code, carried over from ``bayesian_inference_tpu.io.tables`` with its
numpy parser only).

    observables['Data'][label]{xmin,xmax,y,y_err}
    observables['Design'] / ['Design_validation']                (n_points, n_params)
    observables['Design_indices'] / ['Design_indices_validation']
    observables['Prediction'] / ['Prediction_validation'][label]{y,y_err}
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import numpy.typing as npt

from bayesian_inference_tpu_torch.io.observables import (
    ObservableFilter,
    observable_label_to_keys,
    sort_observable_labels,
)

logger = logging.getLogger(__name__)


def load_table(path) -> npt.NDArray[np.float64]:
    return np.loadtxt(path, ndmin=2)


def parse_table_filename(filename: str) -> tuple[str | None, str | None]:
    """Return (observable_label, parameterization) encoded in a table filename."""
    parts = filename[:-4].split("__")  # strip ".dat"
    kind = parts[0]
    if kind == "Data":
        return "__".join(parts[1:]), None
    if kind == "Design":
        return None, parts[1]
    if kind == "Prediction":
        return "__".join(parts[2:-1]), parts[1]
    raise ValueError(f"Unrecognized table filename: {filename}")


def _centrality_accepted(centrality: str, centrality_ranges: Any) -> bool:
    lo, hi = (int(c) for c in centrality.split("-"))
    if not isinstance(centrality_ranges[0], (list, tuple)):
        centrality_ranges = [list(centrality_ranges)]
    return any(lo >= sel_lo and hi <= sel_hi for sel_lo, sel_hi in centrality_ranges)


def accept_observable(analysis_config: Mapping[str, Any], filename: str) -> bool:
    """Acceptance by sqrts, centrality, and any emulation group's observable filter."""
    label, _ = parse_table_filename(filename)
    sqrts, _, _, _, _, centrality = observable_label_to_keys(label)

    if int(sqrts) not in analysis_config["sqrts_list"]:
        return False
    if not _centrality_accepted(centrality, analysis_config["centrality_range"]):
        return False

    global_exclude = analysis_config.get("global_observable_exclude_list", [])
    for group in analysis_config["parameters"]["emulators"].values():
        f = ObservableFilter(
            include_list=group["observable_list"],
            exclude_list=group.get("observable_exclude_list", []) + global_exclude,
        )
        if f.accept_observable(filename):
            return True
    return False


def read_design_points_from_design_dat(
    observable_table_dir: Path | str, parameterization: str
) -> npt.NDArray[np.int32]:
    """Design-point ids from the 'Design point indices' header of Design__<param>.dat."""
    path = os.path.join(observable_table_dir, "Design", f"Design__{parameterization}.dat")
    with open(path) as f:
        for line in f:
            if "Design point indices" in line:
                ids = np.array([int(tok) for tok in line.split(":")[1].split()], dtype=np.int32)
                break
        else:
            raise ValueError(f"No 'Design point indices' header found in {path}")
    if len(ids) != len(set(ids.tolist())):
        raise ValueError("Design points are not unique")
    return ids


def read_design_points_from_predictions_dat(
    prediction_dir: Path | str, filename_prediction_values: str
) -> npt.NDArray[np.int32]:
    """Design-point ids from the '# design_point<i> ...' header of a Prediction values file."""
    prefix_len = len("design_point")
    with open(os.path.join(prediction_dir, filename_prediction_values)) as f:
        for line in f:
            if "design_point" in line:
                ids = np.array(
                    [int(tok[prefix_len:]) for tok in line.split("#")[1].split()], dtype=np.int32
                )
                break
        else:
            raise ValueError(f"No design_point header found in {filename_prediction_values}")
    if len(ids) != len(set(ids.tolist())):
        raise ValueError("Design points are not unique")
    return ids


def split_training_validation_indices(
    design_points: npt.NDArray[np.int32],
    validation_indices: list[int] | range,
    design_points_to_exclude: list[int] | None = None,
) -> tuple[npt.NDArray[np.int64], npt.NDArray[np.int32], npt.NDArray[np.int64], npt.NDArray[np.int32]]:
    """Column indices + design-point ids for the training and validation sets;
    ids in ``design_points_to_exclude`` are dropped from both."""
    is_validation = np.isin(design_points, list(validation_indices))
    train_idx = np.where(~is_validation)[0]
    val_idx = np.where(is_validation)[0]
    train_ids = design_points[train_idx]
    val_ids = design_points[val_idx]

    if design_points_to_exclude:
        keep_train = np.isin(train_ids, design_points_to_exclude, invert=True)
        keep_val = np.isin(val_ids, design_points_to_exclude, invert=True)
        train_idx, train_ids = train_idx[keep_train], train_ids[keep_train]
        val_idx, val_ids = val_idx[keep_val], val_ids[keep_val]

    return train_idx, train_ids, val_idx, val_ids


def initialize_observables_dict_from_tables(
    table_dir: str,
    analysis_config: Mapping[str, Any],
    parameterization: str,
) -> dict[str, Any]:
    """Read all tables into the canonical observables dict (see module docstring)."""
    observables: dict[str, Any] = {"Data": {}, "Prediction": {}, "Prediction_validation": {}}
    val_range = analysis_config["validation_indices"]
    validation_indices = range(val_range[0], val_range[1])
    exclude = analysis_config.get("design_points_to_exclude", [])

    data_dir = os.path.join(table_dir, "Data")
    for filename in os.listdir(data_dir):
        if not accept_observable(analysis_config, filename):
            continue
        table = load_table(os.path.join(data_dir, filename))
        label, _ = parse_table_filename(filename)
        entry = {"xmin": table[:, 0], "xmax": table[:, 1], "y": table[:, 2], "y_err": table[:, 3]}
        if 0 in entry["y"]:
            raise ValueError(f"{filename} has value=0")
        observables["Data"][label] = entry

    design_dir = os.path.join(table_dir, "Design")
    for filename in os.listdir(design_dir):
        if parse_table_filename(filename)[1] != parameterization:
            continue
        params = load_table(os.path.join(design_dir, filename))
        ids = read_design_points_from_design_dat(table_dir, parameterization)
        train_idx, train_ids, val_idx, val_ids = split_training_validation_indices(
            ids, validation_indices, exclude
        )
        observables["Design"] = params[train_idx]
        observables["Design_indices"] = train_ids
        observables["Design_validation"] = params[val_idx]
        observables["Design_indices_validation"] = val_ids

    prediction_dir = os.path.join(table_dir, "Prediction")
    accepted = [
        f for f in os.listdir(prediction_dir)
        if "values" in f and parameterization in f and accept_observable(analysis_config, f)
    ]
    for filename in accepted:
        label, _ = parse_table_filename(filename)
        values = load_table(os.path.join(prediction_dir, filename))
        errors = load_table(os.path.join(prediction_dir, filename.replace("values", "errors")))

        if label not in observables["Data"]:
            raise ValueError(f"{label} not found in observables[Data]: {list(observables['Data'])}")
        if observables["Data"][label]["y"].shape[0] != values.shape[0]:
            raise ValueError(f"({filename}) shape mismatch vs Data -- before cuts")

        # x-range cuts: keep bins within [x_min, x_max] for matching observables
        for obs_key, (x_min, x_max) in analysis_config.get("cuts", {}).items():
            if obs_key in label:
                d = observables["Data"][label]
                mask = (x_min <= d["xmin"]) & (d["xmax"] <= x_max)
                values, errors = values[mask, :], errors[mask, :]
                observables["Data"][label] = {k: v[mask] for k, v in d.items()}

        if observables["Data"][label]["y"].shape[0] != values.shape[0]:
            raise ValueError(f"({filename}) shape mismatch vs Data -- after cuts")

        ids = read_design_points_from_predictions_dat(prediction_dir, filename)
        train_idx, _, val_idx, _ = split_training_validation_indices(ids, validation_indices, exclude)

        observables["Prediction"][label] = {
            "y": np.take(values, train_idx, axis=1),
            "y_err": np.take(errors, train_idx, axis=1),
        }
        observables["Prediction_validation"][label] = {
            "y": np.take(values, val_idx, axis=1),
            "y_err": np.take(errors, val_idx, axis=1),
        }

        if 0 in values:
            logger.warning(f"{filename} has value=0 at design points {np.where(values == 0)[1]}")

        if not np.any(observables["Prediction"][label]["y"]):
            for key in ("Prediction", "Prediction_validation", "Data"):
                del observables[key][label]
            logger.info(f"Removing {label}: no bins left after cuts")

    for label in sort_observable_labels(list(observables["Prediction"])):
        logger.info(f"  {label}")
    return observables
