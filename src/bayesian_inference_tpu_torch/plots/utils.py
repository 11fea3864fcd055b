"""Shared plotting helpers (reference plot_utils.py), carried over from
``bayesian_inference_tpu.plots.utils``."""

from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import yaml

logger = logging.getLogger(__name__)


def ensure_plot_dir(base_dir: str, name: str) -> str:
    plot_dir = os.path.join(base_dir, name)
    os.makedirs(plot_dir, exist_ok=True)
    return plot_dir


def latex_from_tlatex(s: str) -> str:
    """Convert ROOT TLatex markup to matplotlib LaTeX (reference plot_utils.py:175-192).

    Same conversion set as the reference, with one fix: the ``, {#beta} = 0``
    and ``{#Delta R}`` removals run *before* spaces are escaped, so they
    actually match (the reference applies them after ``' '`` -> ``'\\;'``,
    which makes those patterns unreachable).
    """
    s = s.replace(", {#beta} = 0", "")
    s = s.replace("{#Delta R}", "")
    s = f"${s}$"
    s = s.replace("#it", "")
    s = s.replace(" ", r"\;")
    s = s.replace("} {", r"},\;{")
    s = s.replace("#", "\\")
    s = s.replace("SD", r",\;SD")
    s = s.replace("Standard_WTA", r"\mathrm{Standard-WTA}")
    s = s.replace(r"{\lambda}_{{\alpha}},\;{\alpha}\;=\;", r"\lambda_")
    return s


def _load_stat_plot_block(config, sqrts: str, observable_type: str, observable: str, cache: dict):
    """Axis-title block for one observable from the JETSCAPE-analysis
    ``STAT_<sqrts>.yaml`` config (reference plot_utils.py:49-61). Returns None
    when the config dir or block is unavailable (fixture runs)."""
    config_dir = getattr(config, "observable_config_dir", None)
    if not config_dir:
        return None
    if sqrts not in cache:
        path = os.path.join(config_dir, f"STAT_{sqrts}.yaml")
        if os.path.exists(path):
            with open(path) as f:
                cache[sqrts] = yaml.safe_load(f)
        else:
            cache[sqrts] = None
    stat = cache[sqrts]
    if not stat:
        return None
    try:
        return stat[observable_type][observable]
    except (KeyError, TypeError):
        return None


def _panel_axes_iter(shapes: list[tuple[int, int]], n: int):
    """Yield (figure_index, rows, cols, panels_in_figure) covering n panels,
    repeating the last shape if the config lists fewer panels than observables."""
    covered = 0
    i = 0
    while covered < n:
        rows, cols = shapes[min(i, len(shapes) - 1)]
        yield i, int(rows), int(cols), int(rows) * int(cols)
        covered += int(rows) * int(cols)
        i += 1


def observable_panels(
    plot_list: list[dict],
    labels: list[str],
    colors: list[str],
    config,
    plot_dir: str,
    filename: str,
    observables: dict,
    sorted_labels: list[str],
    ylabel: str = "",
    plot_exp_data: bool = True,
):
    """Multi-panel per-observable grid (reference plot_observable_panels,
    plot_utils.py:24-172): one subplot per observable, x = bin centers, one
    curve/band per entry of plot_list ({'central_value': (B, F)}).

    Follows the analysis config's ``plot_panel_shapes`` list — each entry is
    one output figure ``<filename>__<i>.pdf`` of that shape (repeating the
    last shape if more observables remain). Axis titles come from the
    JETSCAPE-analysis ``STAT_<sqrts>.yaml`` blocks via ``latex_from_tlatex``
    when ``config.observable_config_dir`` provides them.
    """
    from bayesian_inference_tpu_torch.io.observables import observable_label_to_keys

    n = len(sorted_labels)
    if n == 0:
        return
    shapes = None
    if config is not None:
        shapes = getattr(config, "analysis_config", {}).get("plot_panel_shapes")
    if not shapes:
        shapes = [[int(np.ceil(n / 4)), 4]]

    # Feature offsets of each observable in the stacked matrices
    offsets = {}
    start = 0
    for label in sorted_labels:
        n_bins = len(np.atleast_1d(observables["Data"][label]["xmin"]))
        offsets[label] = (start, n_bins)
        start += n_bins

    stat_cache: dict = {}
    base, ext = os.path.splitext(filename)
    ext = ext or ".pdf"

    i_obs = 0
    for i_fig, nrows, ncols, n_panels in _panel_axes_iter(shapes, n):
        fig, axes = plt.subplots(
            nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False
        )
        fontsize = max(5, int(14 / nrows))
        for i_panel in range(n_panels):
            ax = axes[i_panel // ncols][i_panel % ncols]
            if i_obs >= n:
                ax.axis("off")
                continue
            label = sorted_labels[i_obs]
            data = observables["Data"][label]
            x = 0.5 * (np.atleast_1d(data["xmin"]) + np.atleast_1d(data["xmax"]))
            start, n_bins = offsets[label]
            for entry, curve_label, color in zip(plot_list, labels, colors):
                vals = entry["central_value"][:, start : start + n_bins]
                mid = np.median(vals, axis=0)
                lo, hi = np.percentile(vals, [5, 95], axis=0)
                ax.plot(x, mid, color=color, label=curve_label, lw=1)
                if vals.shape[0] > 1:
                    ax.fill_between(x, lo, hi, color=color, alpha=0.25, lw=0)
            if plot_exp_data:
                ax.errorbar(
                    x, np.atleast_1d(data["y"]), yerr=np.atleast_1d(data["y_err"]),
                    fmt="ks", ms=3, lw=1, label="Experimental data",
                )
            sqrts, _system, obs_type, obs_name, *_ = observable_label_to_keys(label)
            block = _load_stat_plot_block(config, sqrts, obs_type, obs_name, stat_cache)
            if block:
                ax.set_xlabel(latex_from_tlatex(block["xtitle"]), fontsize=fontsize)
                ax.set_ylabel(
                    ylabel or latex_from_tlatex(block["ytitle_AA"]), fontsize=fontsize
                )
            else:
                ax.set_ylabel(ylabel, fontsize=7)
            ax.set_title(label.replace("__", " "), fontsize=6)
            if i_panel == 0:
                ax.legend(fontsize=6)
            i_obs += 1
        fig.tight_layout()
        suffix = f"__{i_fig}" if len(shapes) > 1 or i_fig > 0 else ""
        fig.savefig(os.path.join(plot_dir, f"{base}{suffix}{ext}"))
        plt.close(fig)
