"""Input-data plots (reference plot_input_data.py): all-design-point prediction
spaghetti per observable (standard and preprocessed), design-point pairplot,
and per-bin pairwise correlation studies with OLS regression, RMS-distance
outlier identification, and design-point annotation. Carried over from
``bayesian_inference_tpu.plots.input_data``."""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Iterable

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from bayesian_inference_tpu_torch.io import hdf5, observables as obs_io
from bayesian_inference_tpu_torch.plots.utils import ensure_plot_dir

logger = logging.getLogger(__name__)

# Memory/figure-size guard when chunking wide feature matrices into pair grids
# (reference plot_input_data.py:118 uses the same cap for emulator groups).
MAX_CHUNK_SIZE = 30

# Per-observable grids are additionally chunked: matplotlib cost grows with
# axes-count squared (a 21-bin observable is a 441-axes figure, ~1 min to
# render), so wide observables are split into blocks of this many bins. The
# reference renders the full grid in one figure (plot_input_data.py:88-104);
# the outlier identification is unaffected (it is pairwise within each chunk).
MAX_BINS_PER_OBSERVABLE_GRID = 8


@dataclass(frozen=True)
class ObservableGrouping:
    """How to group observable bins into pair-correlation grids (reference
    plot_input_data.py:53-147): one grid per observable, one per emulator
    group (chunked at MAX_CHUNK_SIZE), or fixed-size chunks of the globally
    sorted feature matrix.

    ``max_bins_per_grid``: render-cost chunking bound for per-observable
    grids (default MAX_BINS_PER_OBSERVABLE_GRID); None/0 disables chunking —
    every observable renders its FULL bin grid in one figure, exactly the
    reference's layout (plot_input_data.py:88-104). Config key:
    ``plot_correlations_single_figure: true``."""

    observable_by_observable: bool = False
    emulator_groups: bool = False
    fixed_size: int | None = None
    max_bins_per_grid: int | None = MAX_BINS_PER_OBSERVABLE_GRID

    @property
    def label(self) -> str:
        if self.observable_by_observable:
            return "observable_by_observable"
        if self.emulator_groups:
            return "emulator_groups"
        if self.fixed_size is not None:
            return f"observable_group_by_{self.fixed_size}"
        raise ValueError(f"Invalid ObservableGrouping settings: {self}")

    def gen(
        self, config, observables_filename: str, validation_set: bool
    ) -> Iterable[tuple[str, str, np.ndarray, np.ndarray, list[str]]]:
        """Yield (label, title, matrix (n_design, n_cols), design_point_ids,
        column_names) per grid."""
        observables = hdf5.read_dict_from_h5(
            config.output_dir, observables_filename, verbose=False
        )
        design_key = "Design_indices_validation" if validation_set else "Design_indices"
        pred_key = "Prediction_validation" if validation_set else "Prediction"
        n_design = obs_io.design_array_from_h5(
            config.output_dir, observables_filename, validation_set=validation_set
        ).shape[0]
        design_points = np.asarray(observables.get(design_key, np.arange(n_design)))

        if self.observable_by_observable:
            for label in obs_io.sorted_observable_list_from_dict(
                observables[pred_key], observable_filter=config.observable_filter
            ):
                y = np.atleast_2d(observables[pred_key][label]["y"]).T  # (n_design, n_bins)
                bins_cap = self.max_bins_per_grid or y.shape[1]
                if y.shape[1] <= bins_cap:
                    cols = [f"bin {i}" for i in range(y.shape[1])]
                    yield f"observable_{label}", label, y, design_points, cols
                else:
                    for i_chunk, start in enumerate(
                        range(0, y.shape[1], bins_cap)
                    ):
                        sl = slice(start, min(start + bins_cap, y.shape[1]))
                        cols = [f"bin {i}" for i in range(sl.start, sl.stop)]
                        yield (
                            f"observable_{label}__bins_{i_chunk}",
                            f"{label} (bins {sl.start}-{sl.stop - 1})",
                            y[:, sl], design_points, cols,
                        )
        elif self.emulator_groups:
            for group_name, group_cfg in config.emulation_groups_config.items():
                Y = obs_io.predictions_matrix_from_h5(
                    config.output_dir, observables_filename,
                    validation_set=validation_set,
                    observable_filter=group_cfg.observable_filter,
                )
                yield from _chunk_matrix(
                    Y, design_points, chunk_size=MAX_CHUNK_SIZE,
                    base_label=group_name, base_title=f"Group {group_name}",
                )
        elif self.fixed_size is not None:
            Y = obs_io.predictions_matrix_from_h5(
                config.output_dir, observables_filename,
                validation_set=validation_set,
                observable_filter=config.observable_filter,
            )
            yield from _chunk_matrix(
                Y, design_points, chunk_size=self.fixed_size,
                base_label="", base_title=f"Fixed size: {self.fixed_size}",
            )
        else:
            raise ValueError(f"Invalid ObservableGrouping settings: {self}")


def _chunk_matrix(Y, design_points, chunk_size, base_label, base_title):
    n_features = Y.shape[1]
    if n_features <= chunk_size:
        cols = [f"feature {i}" for i in range(n_features)]
        yield base_label, base_title, Y, design_points, cols
        return
    for i_chunk, start in enumerate(range(0, n_features, chunk_size)):
        sl = slice(start, min(start + chunk_size, n_features))
        cols = [f"feature {i}" for i in range(sl.start, sl.stop)]
        yield (
            f"{base_label}_chunk_{i_chunk}" if base_label else f"chunk_{i_chunk}",
            f"{base_title} (features {sl.start}-{sl.stop - 1})",
            Y[:, sl], design_points, cols,
        )


def plot(config) -> None:
    h5_path = os.path.join(config.output_dir, "observables.h5")
    if not os.path.exists(h5_path):
        logger.info(f"No observables.h5 at {h5_path}; skipping input-data plots")
        return
    plot_dir = ensure_plot_dir(config.output_dir, "plot_input_data")

    for filename, tag in (("observables.h5", "standard"), ("observables_preprocessed.h5", "preprocessed")):
        if not os.path.exists(os.path.join(config.output_dir, filename)):
            continue
        observables = hdf5.read_dict_from_h5(config.output_dir, filename, verbose=False)
        _plot_prediction_spaghetti(observables, plot_dir, tag)

    observables = hdf5.read_dict_from_h5(config.output_dir, "observables.h5", verbose=False)
    _plot_design_pairplot(np.atleast_2d(observables["Design"]), plot_dir)

    # Per-bin correlation studies (reference plot_input_data.py:190-232):
    # observable-by-observable with outlier identification, then with every
    # design point annotated, on the preprocessed file when available.
    corr_filename = "observables_preprocessed.h5"
    if not os.path.exists(os.path.join(config.output_dir, corr_filename)):
        corr_filename = "observables.h5"
    # plot_correlations_single_figure: true -> full bin grid per observable
    # in ONE figure (reference plot_input_data.py:88-104 layout); default
    # keeps the 8-bins-per-figure render-cost chunking.
    single_fig = (
        bool(config.config.get("plot_correlations_single_figure", False))
        if hasattr(config, "config") else False
    )
    grouping = ObservableGrouping(
        observable_by_observable=True,
        max_bins_per_grid=None if single_fig else MAX_BINS_PER_OBSERVABLE_GRID,
    )
    # The reference (plot_input_data.py:190-232) renders all four studies
    # unconditionally: (training, validation) x (outlier-identified,
    # annotate-every-point). We match that default output set. The config key
    # `plot_correlations_full: false` reverts to the training-set outlier
    # study alone — the load-bearing exclusion-candidate sweep — for
    # render-constrained hosts; `plot_correlations_max_rendered` bounds how
    # many grids are RENDERED in either mode (the numeric outlier sweep is
    # never truncated).
    full = (
        bool(config.config.get("plot_correlations_full", True))
        if hasattr(config, "config") else True
    )
    max_rendered = (
        config.config.get("plot_correlations_max_rendered")
        if hasattr(config, "config") else None
    )
    validation_sets = (
        (False, True)
        if full and "Prediction_validation" in observables
        else (False,)
    )
    for validation_set in validation_sets:
        identified = plot_pairplot_correlations(
            config, plot_dir, observable_grouping=grouping,
            outliers_n_rms=4.0, validation_set=validation_set,
            observables_filename=corr_filename,
            max_rendered_groups=max_rendered,
        )
        summary: set[int] = set()
        for pts in identified.values():
            summary.update(pts)
        logger.info(
            f"correlation-study outlier design points "
            f"(validation={validation_set}, n={len(summary)}): {sorted(summary)}"
        )
        if full:
            plot_pairplot_correlations(
                config, plot_dir, observable_grouping=grouping,
                annotate_design_points=True, validation_set=validation_set,
                observables_filename=corr_filename,
                max_rendered_groups=max_rendered,
            )


def _plot_prediction_spaghetti(observables: dict, plot_dir: str, tag: str) -> None:
    labels = obs_io.sorted_observable_list_from_dict(observables["Prediction"])
    ncols = 4
    nrows = int(np.ceil(len(labels) / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, label in enumerate(labels):
        ax = axes[i // ncols][i % ncols]
        data = observables["Data"][label]
        x = 0.5 * (np.atleast_1d(data["xmin"]) + np.atleast_1d(data["xmax"]))
        y = np.atleast_2d(observables["Prediction"][label]["y"])
        ax.plot(x, y, lw=0.2, alpha=0.3, color="steelblue")
        ax.errorbar(x, np.atleast_1d(data["y"]), yerr=np.atleast_1d(data["y_err"]),
                    fmt="ko", ms=2, lw=1)
        ax.set_title(label.replace("__", " "), fontsize=6)
    for j in range(len(labels), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"predictions__{tag}.pdf"))
    plt.close(fig)


def _plot_design_pairplot(design: np.ndarray, plot_dir: str) -> None:
    d = design.shape[1]
    fig, axes = plt.subplots(d, d, figsize=(2 * d, 2 * d))
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if i == j:
                ax.hist(design[:, i], bins=20, color="darkorange")
            elif i > j:
                ax.plot(design[:, j], design[:, i], ".", ms=2)
            else:
                ax.axis("off")
            ax.tick_params(labelsize=5)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "design_pairplot.pdf"))
    plt.close(fig)


def _ols_fit(x: np.ndarray, y: np.ndarray) -> tuple[float, float, float]:
    """Least-squares line y = a + b x; returns (a, b, r_squared)."""
    A = np.c_[np.ones_like(x), x]
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ coef
    ss_res = np.sum((y - pred) ** 2)
    ss_tot = np.sum((y - y.mean()) ** 2)
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return float(coef[0]), float(coef[1]), float(r2)


def _distance_from_line(x: np.ndarray, y: np.ndarray, m: float, b: float) -> np.ndarray:
    """Perpendicular distance of each point from y = m x + b (reference
    plot_input_data.py:481-492)."""
    return np.abs(m * x - y + b) / np.sqrt(m**2 + 1)


def _pairwise_fits(Y: np.ndarray, design_points: np.ndarray, n_rms: float | None):
    """OLS fit + RMS-outlier identification for every lower-triangle pair of
    columns of Y. Returns ({(i, j): (a, b, r2, rms, bad_indices)}, outlier_ids).
    This numeric sweep is the load-bearing output of the correlation study
    (the candidate design-point exclusion list); rendering is separate so the
    sweep always covers every group even when rendering is capped."""
    fits: dict[tuple[int, int], tuple[float, float, float, float, np.ndarray]] = {}
    outlier_ids: set[int] = set()
    n = Y.shape[1]
    for i in range(n):
        for j in range(i):
            x, y = Y[:, j], Y[:, i]
            a, b, r2 = _ols_fit(x, y)
            rms, bad = 0.0, np.empty(0, dtype=int)
            if n_rms is not None:
                dist = _distance_from_line(x, y, m=b, b=a)
                rms = float(np.sqrt(np.mean(dist**2)))
                bad = np.where(dist > n_rms * rms)[0]
                outlier_ids.update(int(design_points[k]) for k in bad)
            fits[(i, j)] = (a, b, r2, rms, bad)
    return fits, outlier_ids


def plot_pairplot_correlations(
    config,
    plot_dir: str,
    observable_grouping: ObservableGrouping | None = None,
    outliers_n_rms: float | None = None,
    annotate_design_points: bool = False,
    validation_set: bool = False,
    observables_filename: str = "observables.h5",
    max_rendered_groups: int | None = None,
) -> dict[str, set]:
    """Per-bin pair-correlation grids across design points (reference
    plot_input_data.py:323-478 + PairGridWithRegression :494-692, statsmodels
    OLS replaced by a numpy least-squares fit): lower triangle = scatter with a
    regression line, diagonal = histogram. With ``outliers_n_rms``, bins whose
    perpendicular RMS distance from the fit exceeds n_RMS * RMS are marked and
    annotated with their design-point index and +-n_RMS bands are drawn; with
    ``annotate_design_points``, every point carries its design index.

    ``max_rendered_groups`` bounds how many grids are RENDERED (matplotlib
    dominates the cost at hundreds of panels); the numeric outlier sweep always
    covers every group, so the returned exclusion candidates are unaffected.
    Skipped renders are logged. Default None renders everything (reference
    behavior).

    Returns {grid_label: set of outlier design-point ids}.
    """
    if observable_grouping is None:
        observable_grouping = ObservableGrouping(fixed_size=5)

    base = f"{observables_filename.split('.')[0]}_pairplot_correlations"
    if validation_set:
        base += "_validation"
    base += f"__{observable_grouping.label}"
    if annotate_design_points:
        base += "__annotated"
    if outliers_n_rms is not None:
        base += "__outliers"

    identified_outliers: dict[str, set[int]] = {}
    n_rendered = n_skipped = 0
    for label, title, Y, design_points, cols in observable_grouping.gen(
        config, observables_filename, validation_set
    ):
        n = Y.shape[1]
        if n < 2:
            continue
        fits, grid_outliers = _pairwise_fits(Y, design_points, outliers_n_rms)
        if grid_outliers:
            identified_outliers[label] = grid_outliers
        if max_rendered_groups is not None and n_rendered >= max_rendered_groups:
            n_skipped += 1
            continue
        n_rendered += 1

        # Build only the axes that carry content (diagonal + lower triangle);
        # the upper triangle would be blank and axes construction is ~40% of
        # figure cost at this panel count.
        fig = plt.figure(figsize=(1.9 * n, 1.9 * n))
        gs = fig.add_gridspec(n, n)
        for i in range(n):
            for j in range(i + 1):
                ax = fig.add_subplot(gs[i, j])
                ax.locator_params(nbins=4)
                if i == j:
                    ax.hist(Y[:, i], bins=20, color="steelblue")
                else:
                    x, y = Y[:, j], Y[:, i]
                    ax.plot(x, y, ".", ms=2, color="steelblue")
                    a, b, r2, rms, bad = fits[(i, j)]
                    xs = np.linspace(x.min(), x.max(), 100)
                    if outliers_n_rms is not None:
                        ax.plot(xs, a + b * xs, "r-", lw=0.8)
                        # +-n_RMS bands around the fit for reference
                        ax.plot(xs, a + b * xs + outliers_n_rms * rms, "r--", lw=0.6)
                        ax.plot(xs, a + b * xs - outliers_n_rms * rms, "r--", lw=0.6)
                        for k in bad:
                            ax.annotate(
                                str(design_points[k]), (x[k], y[k]),
                                fontsize=5, color="tab:blue",
                            )
                        ax.text(0.03, 0.9, f"$R^2$={r2:.2f}", transform=ax.transAxes, fontsize=5)
                    if annotate_design_points:
                        for k in range(len(x)):
                            ax.annotate(str(design_points[k]), (x[k], y[k]), fontsize=5, color="red")
                ax.tick_params(labelsize=4)
                if i == n - 1:
                    ax.set_xlabel(cols[j], fontsize=5)
                if j == 0 and i > 0:
                    ax.set_ylabel(cols[i], fontsize=5)
        fig.suptitle(title, fontsize=min(26, 6 + 2 * n))
        if n <= 6:
            fig.tight_layout()
        else:
            # tight_layout costs ~n^2; plain spacing is fine for big grids
            fig.subplots_adjust(hspace=0.35, wspace=0.35, top=0.94)
        fig.savefig(os.path.join(plot_dir, f"{base}__{label}.pdf"))
        plt.close(fig)
    if n_skipped:
        logger.info(
            f"pairplot correlations ({base}): rendered {n_rendered} grids, "
            f"skipped rendering {n_skipped} (max_rendered_groups="
            f"{max_rendered_groups}); outlier sweep covered all groups"
        )
    return identified_outliers
