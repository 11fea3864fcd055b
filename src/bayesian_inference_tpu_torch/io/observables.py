"""Observable naming, ordering, filtering and matrix assembly (host code,
carried over from ``bayesian_inference_tpu.io.observables``).

Labels follow ``{sqrts}__{system}__{observable_type}__{observable}__{subobservable}__{centrality}``;
the deterministic sort below is the contract that makes the stacked
(n_design, n_features) matrices line up across stages. Functions that read
``observables.h5`` also take the already-read dict, so callers without h5py
can pass the observables in memory.
"""

from __future__ import annotations

import fnmatch
import logging
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import numpy.typing as npt

logger = logging.getLogger(__name__)

# Sort precedence over the label fields: observable_type, observable,
# subobservable, centrality, sqrts.
_SORT_PRECEDENCE = (2, 3, 4, 5, 0)


def observable_label_to_keys(observable_label: str) -> tuple[str, str, str, str, str, str]:
    """Split a label into (sqrts, system, observable_type, observable, subobservable, centrality)."""
    parts = observable_label.split("__")
    return tuple(parts[:6])  # type: ignore[return-value]


def sort_observable_labels(labels: Sequence[str]) -> list[str]:
    """Lexicographic pre-sort, then a stable sort by the label-field precedence."""
    keyed = [observable_label_to_keys(lbl) for lbl in sorted(labels)]
    keyed.sort(key=lambda t: tuple(t[i] for i in _SORT_PRECEDENCE))
    return ["__".join(t) for t in keyed]


def sorted_observable_list_from_dict(
    observables: Mapping[str, Any],
    observable_filter: "ObservableFilter | None" = None,
) -> list[str]:
    """Sorted observable labels from an observables dict (or its 'Prediction' subdict)."""
    keys = list(observables["Prediction"].keys()) if "Prediction" in observables else list(observables.keys())
    if observable_filter is not None:
        keys = [k for k in keys if observable_filter.accept_observable(k)]
    return sort_observable_labels(keys)


def _matches_any(name: str, patterns: Sequence[str], use_glob: bool) -> bool:
    if use_glob:
        return any("*" in p and fnmatch.fnmatch(name, f"*{p}*") for p in patterns)
    return any(p in name for p in patterns)


@dataclass
class ObservableFilter:
    """Accept a name that matches the include list (substring or glob) and
    does not match the exclude list (substring or glob)."""

    include_list: list[str]
    exclude_list: list[str] = field(default_factory=list)

    def accept_observable(self, observable_name: str) -> bool:
        included = _matches_any(observable_name, self.include_list, use_glob=False) or _matches_any(
            observable_name, self.include_list, use_glob=True
        )
        excluded = _matches_any(observable_name, self.exclude_list, use_glob=False) or _matches_any(
            observable_name, self.exclude_list, use_glob=True
        )
        return included and not excluded


def read_observables(output_dir: str, filename: str) -> dict[str, Any]:
    from bayesian_inference_tpu_torch.io.hdf5 import read_dict_from_h5

    return read_dict_from_h5(output_dir, filename, verbose=False)


def predictions_matrix_from_h5(
    output_dir: str,
    filename: str,
    validation_set: bool = False,
    observable_filter: ObservableFilter | None = None,
    observables: dict[str, Any] | None = None,
) -> npt.NDArray[np.float64]:
    """Stack per-observable prediction bins into one (n_design, n_features) matrix.

    A pre-read ``observables`` dict skips the h5 read.
    """
    if observables is None:
        observables = read_observables(output_dir, filename)
    labels = sorted_observable_list_from_dict(observables, observable_filter=observable_filter)
    key = "Prediction_validation" if validation_set else "Prediction"
    blocks = [np.atleast_2d(observables[key][lbl]["y"]).T for lbl in labels]
    if not blocks or sum(b.shape[1] for b in blocks) == 0:
        raise ValueError(f"No observables found in the prediction file for {observable_filter}")
    Y = np.concatenate(blocks, axis=1)
    logger.info(f"Prediction matrix ({key}) shape (n_samples, n_features): {Y.shape}")
    return Y


def design_array_from_h5(
    output_dir: str,
    filename: str,
    validation_set: bool = False,
    observables: dict[str, Any] | None = None,
) -> npt.NDArray[np.float64]:
    """The (n_design, n_params) design matrix (of the validation set when
    ``validation_set``). A pre-read ``observables`` dict skips the h5 read."""
    if observables is None:
        observables = read_observables(output_dir, filename)
    return observables["Design_validation" if validation_set else "Design"]


def data_dict_from_h5(
    output_dir: str,
    filename: str,
    observable_table_dir: str | None = None,
    observables: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """The experimental-data dict {label: {xmin, xmax, y, y_err}}; with
    ``observable_table_dir``, cross-checked against the original
    ``Data/Data__<label>.dat`` tables (a mismatch raises ValueError). A
    pre-read ``observables`` dict skips the h5 read."""
    if observables is None:
        observables = read_observables(output_dir, filename)
    data = observables["Data"]
    if observable_table_dir:
        import os

        for label, entry in data.items():
            table = np.loadtxt(os.path.join(observable_table_dir, "Data", f"Data__{label}.dat"), ndmin=2)
            for col, key in enumerate(("xmin", "xmax", "y", "y_err")):
                if not np.allclose(entry[key], table[:, col]):
                    raise ValueError(f"{filename}: Data/{label}/{key} differs from its table in {observable_table_dir}")
    return data


def data_array_from_h5(
    output_dir: str,
    filename: str,
    pseudodata_index: int = -1,
    observable_filter: ObservableFilter | None = None,
    rng: np.random.Generator | None = None,
    observables: dict[str, Any] | None = None,
) -> dict[str, npt.NDArray[np.float64]]:
    """The stacked experimental data vector {'y', 'y_err'}, shape (n_features,).

    With ``pseudodata_index >= 0`` (closure test) the validation prediction at
    that index is smeared with N(0, sigma_exp). A pre-read ``observables``
    dict skips the h5 read.
    """
    if observables is None:
        observables = read_observables(output_dir, filename)
    labels = sorted_observable_list_from_dict(observables, observable_filter=observable_filter)
    if rng is None:
        rng = np.random.default_rng()

    ys, yerrs = [], []
    for lbl in labels:
        if pseudodata_index < 0:
            y = np.atleast_1d(observables["Data"][lbl]["y"])
            y_err = np.atleast_1d(observables["Data"][lbl]["y_err"])
        else:
            exp_err = np.atleast_1d(observables["Data"][lbl]["y_err"])
            central = np.atleast_2d(observables["Prediction_validation"][lbl]["y"])[:, pseudodata_index]
            y = central + rng.normal(loc=0.0, scale=exp_err)
            y_err = exp_err
        ys.append(y)
        yerrs.append(y_err)

    data = {"y": np.concatenate(ys), "y_err": np.concatenate(yerrs)}
    logger.info(f"Data vector shape (n_features,): {data['y'].shape}")
    return data


def observable_dict_from_matrix(
    Y: npt.NDArray[np.float64],
    observables: Mapping[str, Any],
    cov: npt.NDArray[np.float64] | None = None,
    validation_set: bool = False,
    observable_filter: ObservableFilter | None = None,
) -> dict[str, dict[str, npt.NDArray[np.float64]]]:
    """Unstack a (n_samples, n_features) matrix into per-observable blocks.

    Returns {'central_value': {label: (n_samples, n_bins)}, 'cov': {label:
    (n_samples, n_bins, n_bins)}} (cov only when given; the cross-observable
    terms are dropped, as in the reference).
    """
    if cov is not None and isinstance(cov, np.ndarray) and cov.size == 0:
        cov = None
    key = "Prediction_validation" if validation_set else "Prediction"
    labels = sorted_observable_list_from_dict(observables, observable_filter=observable_filter)

    out: dict[str, dict[str, npt.NDArray[np.float64]]] = {"central_value": {}}
    if cov is not None:
        out["cov"] = {}
    start = 0
    for lbl in labels:
        n_bins = np.atleast_2d(observables[key][lbl]["y"]).shape[0]
        out["central_value"][lbl] = Y[:, start : start + n_bins]
        if cov is not None:
            out["cov"][lbl] = cov[:, start : start + n_bins, start : start + n_bins]
        start += n_bins
    if start != Y.shape[1]:
        raise ValueError(f"bin count mismatch: the observables hold {start} bins, the matrix {Y.shape[1]} columns")
    return out


def observable_matrix_from_dict(
    Y_dict: Mapping[str, Mapping[str, npt.NDArray[np.float64]]],
    values_to_return: str = "central_value",
) -> npt.NDArray[np.float64]:
    """Re-stack per-observable blocks (already in sorted order) into one matrix."""
    return np.concatenate([np.asarray(v) for v in Y_dict[values_to_return].values()], axis=1)
