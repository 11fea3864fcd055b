"""Frozen copy of ``src/bayesian_inference_tpu_torch/io/synthetic.py`` at commit 7be95f0.

The benchmark's table generator: it writes the synthetic production-width
JETSCAPE-STAT table set (144 observables, 1,644 selected features, 230 design
ids with three holes) from the run's seed. Later changes to the program's
generator do not move the benchmark's inputs.

Synthetic production-width JETSCAPE-STAT table sets.

The bundled test fixture covers 16 observables / 215 features; the real
production analysis spans the full table set selected by the observable lists
in the reference config (jet_substructure.yaml:199-266: ``jet__pt_``,
``chjet__zg_``/``chjet__tg_``, ``jet__Dz_`` across ALICE/ATLAS/CMS/STAR,
sqrts 200/2760/5020, multiple R and pt selections — a few hundred observables
and O(1-2k) features). This module writes a deterministic synthetic table set
at that width, in the exact on-disk format the ingest layer parses
(reference data_IO.py:39-214: ``Data__*.dat`` xmin/xmax/y/y_err columns,
``Design__<param>.dat`` with the 'Design point indices' header,
``Prediction__<param>__*__values/errors.dat`` with the '# design_point<i>'
header), so production-DATA-scale runs exercise the same ingest -> PCA -> GP
-> MCMC path as the real analysis.

The synthetic physics: each observable bin is a smooth positive RAA-like
response surface over the 6-D parameter space (low-order polynomial + mild
interaction terms in normalized theta), plus per-design-point statistical
noise. Smooth theta-dependence matters: the GP hyperparameter fit and the
MCMC acceptance behave like the real analysis, so the benchmark measures
realistic per-step work rather than a white-noise pathology.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# Parameter box of the 'exponential' parameterization (jet_substructure.yaml).
THETA_MIN = np.array([0.1, 1.0, 0.006737946999085467, 0.006737946999085467, 0.0, 0.049787068367863944])
THETA_MAX = np.array([0.5, 10.0, 10.0, 10.0, 1.5, 100.0])
PARAM_NAMES = ["AlphaS", "Q0", "C1", "C2", "Tau0", "C3"]


def production_observable_labels() -> dict[str, int]:
    """Label -> n_bins for the synthetic production-width observable set.

    Families and multiplicities mirror the reference production analysis's
    observable lists (jet_substructure.yaml:199-266) at realistic bin counts:
    jet RAA spectra (10-22 bins), groomed substructure zg/tg (5-7 bins),
    fragmentation Dz (10-14 bins), plus hadron RAA tables that the production
    emulation groups do NOT select (they exercise ingest-side filtering).
    """
    labels: dict[str, int] = {}

    def add(sqrts, system, otype, obs, sub, cent, nb):
        labels[f"{sqrts}__{system}__{otype}__{obs}__{sub}__{cent}"] = nb

    lhc = [(2760, "PbPb"), (5020, "PbPb")]
    cents = ["0-5", "5-10"]

    # --- jet__pt_ (jet_group, n_pc 5) ---------------------------------------
    for sqrts, system in lhc:
        for cent in cents:
            for r in ("R0.2", "R0.3", "R0.4", "R0.5", "R0.6"):
                add(sqrts, system, "jet", "pt_alice", r, cent, 14)
            add(sqrts, system, "jet", "pt_y_atlas", "R0.4", cent, 22)
            add(sqrts, system, "jet", "pt_atlas", "R0.4", cent, 18)
            for r in ("R0.2", "R0.3", "R0.4"):
                add(sqrts, system, "jet", "pt_cms", r, cent, 16)
    for cent in cents:
        for r in ("R0.2", "R0.3", "R0.4", "R0.5"):
            add(200, "AuAu", "chjet", "pt_star", r, cent, 10)

    # --- chjet__zg_ / chjet__tg_ (groomed group, n_pc 11) -------------------
    pt_windows = ("pt20-40", "pt40-60", "pt60-80", "pt80-100", "pt100-120")
    for sqrts, system in lhc:
        for r in ("R0.2", "R0.4"):
            for pt in pt_windows:
                add(sqrts, system, "chjet", "zg_alice", f"{r}_{pt}", "0-10", 6)
                add(sqrts, system, "chjet", "tg_alice", f"{r}_{pt}", "0-10", 7)

    # --- jet__Dz_ (Dz group, n_pc 25) ---------------------------------------
    atlas_pt = ("pt100-126", "pt126-158", "pt158-200", "pt200-251", "pt251-316", "pt316-398")
    for sqrts, system in lhc:
        for cent in cents:
            for pt in atlas_pt:
                add(sqrts, system, "jet", "Dz_atlas", f"R0.4_{pt}", cent, 12)
        for r in ("R0.2", "R0.4"):
            for pt in ("pt60-80", "pt80-100", "pt100-120", "pt120-140"):
                add(sqrts, system, "jet", "Dz_alice", f"{r}_{pt}", "0-10", 10)
        for cent in cents:
            for pt in ("pt100-120", "pt120-150", "pt150-200", "pt200-300"):
                add(sqrts, system, "jet", "Dz_cms", f"R0.4_{pt}", cent, 14)

    # --- hadron RAA (NOT selected by the production groups) ------------------
    for sqrts, system in lhc:
        for cent in cents:
            add(sqrts, system, "hadron", "pt_ch_alice", "", cent, 16)
            add(sqrts, system, "hadron", "pt_ch_cms", "", cent, 21)
            add(sqrts, system, "hadron", "pt_pi_alice", "", cent, 15)
    for cent in cents:
        add(200, "AuAu", "hadron", "pt_ch_star", "", cent, 6)
        add(200, "AuAu", "hadron", "pt_pi0_phenix", "", cent, 15)

    return labels


def _response_surface(rng: np.random.Generator, n_bins: int, theta_design: np.ndarray) -> np.ndarray:
    """Smooth positive per-bin response over the design: (n_bins, n_design).

    RAA-like: base spectrum shape in x times a suppression factor that varies
    smoothly (linear + pairwise quadratic in normalized theta) bin by bin.
    """
    t = (theta_design - THETA_MIN) / (THETA_MAX - THETA_MIN)  # (n_design, 6)
    n_design = t.shape[0]
    base = rng.uniform(0.3, 0.9, size=(n_bins, 1))
    slope = rng.normal(0.0, 0.12, size=(n_bins, 6))
    # one random pairwise interaction per observable, shared across bins with
    # a per-bin amplitude — keeps the surface smooth but not purely additive
    i, j = rng.choice(6, size=2, replace=False)
    quad_amp = rng.normal(0.0, 0.08, size=(n_bins, 1))
    resp = (
        base
        + slope @ t.T
        + quad_amp * (t[:, i] * t[:, j])[None, :]
        + 0.05 * np.sin(2.0 * np.pi * (rng.uniform(size=(n_bins, 1)) + t[:, :1].T))
    )
    return np.clip(resp, 0.05, None)  # positive, bounded away from zero


def make_production_tables(
    table_dir: str | os.PathLike,
    parameterization: str = "exponential",
    n_design: int = 230,
    seed: int = 20260817,
) -> dict[str, int]:
    """Write the synthetic production-width table set under ``table_dir``.

    Layout: ``Data/Data__<label>.dat``, ``Design/Design__<param>.dat``,
    ``Prediction/Prediction__<param>__<label>__values/errors.dat``. Design ids
    run 0..n_design-1 with three ids missing (as in the real table set, where
    failed simulations leave holes — exercises the id-vs-column bookkeeping of
    the ingest layer, reference data_IO.py:696-814). Deterministic in ``seed``.

    Returns the label -> n_bins map (accepted + hadron tables).
    """
    table_dir = Path(table_dir)
    (table_dir / "Data").mkdir(parents=True, exist_ok=True)
    (table_dir / "Design").mkdir(parents=True, exist_ok=True)
    (table_dir / "Prediction").mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    labels = production_observable_labels()

    # Design: ids with holes, Latin-hypercube-ish uniform draw over the box.
    missing = {37, 111, 184}
    ids = np.array([i for i in range(n_design) if i not in missing])
    theta = rng.uniform(THETA_MIN, THETA_MAX, size=(len(ids), 6))

    header = ["# Version 1.0", f"# - Design points for {parameterization} PDF",
              "# Parameter " + " ".join(PARAM_NAMES),
              "# Design point indices (row index): " + " ".join(str(i) for i in ids)]
    with open(table_dir / "Design" / f"Design__{parameterization}.dat", "w") as f:
        f.write("\n".join(header) + "\n")
        np.savetxt(f, theta, fmt="%.10g")

    pred_header = "# Version 1.0\n# " + " ".join(f"design_point{i}" for i in ids) + "\n"
    for label, nb in labels.items():
        x = np.linspace(1.0, 10.0, nb + 1) ** 2  # spectrum-like widening bins
        y_pred = _response_surface(rng, nb, theta)  # (nb, n_design)
        stat_err = y_pred * rng.uniform(0.01, 0.06, size=(nb, 1))
        y_pred_noisy = np.clip(y_pred + rng.normal(0.0, 1.0, y_pred.shape) * stat_err, 0.01, None)

        # "truth" = the surface at a random interior point + experimental noise
        theta_truth = rng.uniform(THETA_MIN + 0.2 * (THETA_MAX - THETA_MIN),
                                  THETA_MAX - 0.2 * (THETA_MAX - THETA_MIN))
        # nearest design point's surface value is a cheap smooth stand-in
        nearest = np.argmin(np.sum((theta - theta_truth) ** 2, axis=1))
        y_exp = y_pred[:, nearest]
        y_exp_err = y_exp * rng.uniform(0.03, 0.10, size=nb)
        y_exp = np.clip(y_exp + rng.normal(0.0, 1.0, nb) * y_exp_err, 0.02, None)

        data_tab = np.column_stack([x[:-1], x[1:], y_exp, y_exp_err])
        np.savetxt(table_dir / "Data" / f"Data__{label}.dat", data_tab, fmt="%.10g",
                   header="Version 1.0\nxmin xmax y y_err")

        vpath = table_dir / "Prediction" / f"Prediction__{parameterization}__{label}__values.dat"
        epath = table_dir / "Prediction" / f"Prediction__{parameterization}__{label}__errors.dat"
        with open(vpath, "w") as f:
            f.write(pred_header)
            np.savetxt(f, y_pred_noisy, fmt="%.8g")
        with open(epath, "w") as f:
            f.write(pred_header)
            np.savetxt(f, stat_err, fmt="%.8g")

    return labels
