"""The port's carried plots against the JAX package's on the same inputs: the
across-analyses overlay's legend labels (from the config file and from the
parsed config), the posterior pairplot's closure verdict, and the STAT axis
titles that reach a plot through ``EmulationGroupConfig.observable_config_dir``."""

import copy
import os
from types import SimpleNamespace

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
import yaml
from config_factory import make_analysis_yaml

from bayesian_inference_tpu.plots import analyses as janalyses
from bayesian_inference_tpu.plots import mcmc as jmcmc_plots
from bayesian_inference_tpu.plots import utils as jutils
from bayesian_inference_tpu_torch.io import hdf5 as thdf5
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs
from bayesian_inference_tpu_torch.plots import analyses as tanalyses
from bayesian_inference_tpu_torch.plots import mcmc as tmcmc_plots
from bayesian_inference_tpu_torch.plots import utils as tutils


def test_across_analyses_labels_match_jax(tmp_path):
    """Two analyses (one named for substructure), each with an mcmc.h5 of a
    chain in the prior box: the port's overlay from the config file and from
    the parsed config draws the same legend labels as JAX's, prior first."""
    path, name, param = make_analysis_yaml(tmp_path)
    cfg = yaml.safe_load(path.read_text())
    cfg["analyses"]["jet_substructure"] = copy.deepcopy(cfg["analyses"][name])
    path.write_text(yaml.safe_dump(cfg))
    rng = np.random.default_rng(0)
    for analysis, ac in cfg["analyses"].items():
        box = ac["parameterization"][param]
        lo, hi = np.asarray(box["min"]), np.asarray(box["max"])
        chain = lo + (hi - lo) * rng.uniform(0.2, 0.8, (50, 8, lo.size))
        thdf5.write_dict_to_h5({"chain": chain}, os.path.join(cfg["output_dir"], f"{analysis}_{param}"), "mcmc.h5",
                               verbose=False)

    ref = janalyses.plot(cfg["analyses"], str(path), str(tmp_path / "jax"))
    ours = tanalyses.plot(cfg["analyses"], str(path), str(tmp_path / "torch"))
    parsed = tanalyses.plot(cfg["analyses"], "", str(tmp_path / "parsed"), config=cfg)
    assert ours == parsed == ref
    assert len(ref) == 3 and ref[0].startswith("Prior") and "substructure" in ref[2]
    for out in ("jax", "torch", "parsed"):
        assert (tmp_path / out / "qhat_across_analyses.pdf").is_file()


@pytest.mark.parametrize("truth_quantile,inside", [(0.5, True), (0.999, False)])
def test_pairplot_closure_verdict_matches_jax(tmp_path, truth_quantile, inside):
    """The holdout check of a posterior pairplot (truth inside every marginal
    90% HPDI): the port's verdict equals JAX's on the same chain and truth."""
    chain = np.random.default_rng(1).normal(size=(300, 8, 3))
    truth = np.quantile(chain.reshape(-1, 3), truth_quantile, axis=0)
    kw = dict(confidence=0.9, holdout_point=truth)
    ref = jmcmc_plots._plot_pairplot(chain, ["a", "b", "c"], str(tmp_path), filename="jax.pdf", **kw)
    ours = tmcmc_plots._plot_pairplot(chain, ["a", "b", "c"], str(tmp_path), filename="torch.pdf", **kw)
    assert ours is ref is inside
    assert (tmp_path / "torch.pdf").is_file()


def test_observable_config_dir_gives_the_stat_axis_titles(tmp_path, monkeypatch, test_data_dir):
    """A group config carries ``observable_config_dir`` from the config, as
    JAX's does, so observable panels drawn with it take their axis titles
    from tests/test_data/STAT_<sqrts>.yaml: the same titles as JAX's panels
    given that directory (compare tests/test_io.py)."""
    path, name, param = make_analysis_yaml(tmp_path)
    cfg = yaml.safe_load(path.read_text())
    group = tconfigs.EmulationConfig.from_config_file(name, param, cfg["analyses"][name],
                                                      config=cfg).emulation_groups_config["group_ch"]
    assert group.observable_config_dir == str(test_data_dir)
    observables = tobs.read_observables(str(test_data_dir), "observables.h5")
    labels = tobs.sorted_observable_list_from_dict(observables, observable_filter=group.observable_filter)
    n_features = sum(len(np.atleast_1d(observables["Data"][label]["xmin"])) for label in labels)
    preds = {"central_value": np.random.default_rng(0).uniform(0.5, 1.0, (10, n_features))}

    def titles(panels, config, out):
        out.mkdir(exist_ok=True)
        figures = []
        monkeypatch.setattr(plt, "close", figures.append)
        panels([preds], ["pred"], ["steelblue"], config, str(out), "panels.pdf", observables, labels)
        monkeypatch.undo()
        found = [(ax.get_xlabel(), ax.get_ylabel()) for fig in figures for ax in fig.axes if ax.get_title()]
        plt.close("all")
        return found

    ours = titles(tutils.observable_panels, group, tmp_path / "torch")
    ref = titles(jutils.observable_panels, SimpleNamespace(analysis_config=group.analysis_config,
                                                           observable_config_dir=str(test_data_dir)), tmp_path)
    assert len(ours) == len(labels) and ours == ref
    assert (r"$p_{T}\;(GeV/{c})$", r"${R}_{AA}$") in ours
    assert (tmp_path / "torch" / "panels.pdf").is_file()
