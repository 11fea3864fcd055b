"""The analysis' data, read from the table files as the JETSCAPE-STAT format
defines them: per emulation group the training and validation prediction
matrices, and the experimental values and errors of every selected bin:
the labels the group selects, less the bins outside the analysis' x-range
cuts, less a label that the cuts leave empty.

Independent of the port's ingest. Feature order within a group does not
enter any number the reference compares (PCA, the GP fits and the
log-likelihood are invariant to it), except the closure pseudodata, whose
draws follow the labels in the analysis' documented sort order.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os

import numpy as np

# Label fields: sqrts, system, observable type, observable, subobservable, centrality.
# The analysis sorts labels lexicographically, then stably by these fields.
SORT_FIELDS = (2, 3, 4, 5, 0)


@dataclasses.dataclass
class Group:
    name: str
    n_pc: int
    labels: list[str]            # the group's observables, in the analysis' sort order
    widths: list[int]            # bins per observable
    Y: np.ndarray                # (n_train, F_g) training predictions
    Y_val: np.ndarray            # (n_val, F_g) validation predictions
    y_exp: np.ndarray            # (F_g,)
    y_err: np.ndarray            # (F_g,)


@dataclasses.dataclass
class Data:
    design: np.ndarray           # (n_train, d)
    design_val: np.ndarray       # (n_val, d)
    groups: list[Group]
    labels: list[str]            # every selected label, in the analysis' sort order

    @property
    def widths(self) -> list[int]:
        return [w for g in self.groups for w in g.widths]

    @property
    def n_features(self) -> int:
        return sum(self.widths)


def sort_labels(labels) -> list[str]:
    keyed = [tuple(lbl.split("__")[:6]) for lbl in sorted(labels)]
    keyed.sort(key=lambda t: tuple(t[i] for i in SORT_FIELDS))
    return ["__".join(t) for t in keyed]


def _matches(name: str, patterns) -> bool:
    return any(p in name for p in patterns) or any("*" in p and fnmatch.fnmatch(name, f"*{p}*") for p in patterns)


def _selected(label: str, config: dict, group: dict) -> bool:
    sqrts, _, _, _, _, cent = label.split("__")[:6]
    if int(sqrts) not in config["sqrts_list"]:
        return False
    lo, hi = (int(c) for c in cent.split("-"))
    c_lo, c_hi = config["centrality_range"]
    if not (lo >= c_lo and hi <= c_hi):
        return False
    return _matches(label, group["observable_list"]) and not _matches(label, group.get("observable_exclude_list", []))


def kept_bins(label: str, data: np.ndarray, config: dict) -> np.ndarray:
    """The bins of ``label`` that the analysis' x-range ``cuts`` keep: for
    each key the label contains, those with xmin >= lo and xmax <= hi."""
    keep = np.ones(data.shape[0], dtype=bool)
    for key, (lo, hi) in config.get("cuts", {}).items():
        if key in label:
            keep &= (lo <= data[:, 0]) & (data[:, 1] <= hi)
    return keep


def _ids(path: str, marker: str) -> np.ndarray:
    with open(path) as f:
        for line in f:
            if marker in line:
                if marker == "design_point":
                    return np.array([int(t[len(marker):]) for t in line.split("#")[1].split()])
                return np.array([int(t) for t in line.split(":")[1].split()])
    raise ValueError(f"no {marker!r} header in {path}")


def read(table_dir: str, config: dict) -> Data:
    """The configuration's data from the table set under ``table_dir``."""
    param = config["parameterization"]
    v0, v1 = config["validation_indices"]
    exclude = set(config.get("design_points_to_exclude", []))
    design_path = os.path.join(table_dir, "Design", f"Design__{param}.dat")
    ids = _ids(design_path, "Design point indices")
    theta = np.loadtxt(design_path, ndmin=2)
    is_val = (ids >= v0) & (ids < v1)
    keep = np.array([i not in exclude for i in ids])
    train_cols, val_cols = ~is_val & keep, is_val & keep

    all_labels = [f[len("Data__"):-4] for f in os.listdir(os.path.join(table_dir, "Data"))]
    groups, selected = [], []
    for gname, g in config["emulators"].items():
        labels = sort_labels([lbl for lbl in all_labels if _selected(lbl, config, g)])
        Ys, Yv, ye, ys, widths, kept = [], [], [], [], [], []
        for lbl in labels:
            data = np.loadtxt(os.path.join(table_dir, "Data", f"Data__{lbl}.dat"), ndmin=2)
            pred_path = os.path.join(table_dir, "Prediction", f"Prediction__{param}__{lbl}__values.dat")
            pred = np.loadtxt(pred_path, ndmin=2)
            pred_ids = _ids(pred_path, "design_point")
            if not np.array_equal(pred_ids, ids):
                raise ValueError(f"{lbl}: prediction columns are not the design's")
            rows = kept_bins(lbl, data, config)
            if not rows.any():
                continue                                 # no bins left after the cuts: the label goes
            data, pred = data[rows], pred[rows]
            kept.append(lbl)
            Ys.append(pred[:, train_cols].T)
            Yv.append(pred[:, val_cols].T)
            ye.append(data[:, 2])
            ys.append(data[:, 3])
            widths.append(data.shape[0])
        groups.append(Group(gname, int(g["n_pc"]), kept, widths, np.concatenate(Ys, axis=1),
                            np.concatenate(Yv, axis=1), np.concatenate(ye), np.concatenate(ys)))
        selected.extend(kept)
    return Data(design=theta[train_cols], design_val=theta[val_cols], groups=groups, labels=sort_labels(selected))


def pseudodata(data: Data, point: int, seed: int) -> dict[str, np.ndarray]:
    """The closure test's data vector of validation point ``point``: its
    prediction smeared with N(0, y_err), drawn from ``default_rng(seed)``
    over the labels in sort order. Returned per group, in each group's
    feature order."""
    rng = np.random.default_rng(seed)
    by_label = {}
    for g in data.groups:
        off = 0
        for lbl, w in zip(g.labels, g.widths):
            by_label[lbl] = (g, slice(off, off + w))
            off += w
    out = {g.name: np.empty_like(g.y_exp) for g in data.groups}
    for lbl in data.labels:
        g, sl = by_label[lbl]
        out[g.name][sl] = g.Y_val[point, sl] + rng.normal(loc=0.0, scale=g.y_err[sl])
    return out
