"""Port parity of the prediction and statistics API the plots stand on:
``predict_emulation_group`` and ``predict`` (merged and per group, with and
without the truncation covariance divided by the sample count) on the
fixture's fitted artifacts, ``fit_emulator_group``'s artifact, the host
chain statistics and ``physics/``, each against the JAX package on the same
inputs, in float64 on the CPU."""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from config_factory import make_analysis_yaml

from bayesian_inference_tpu import physics as jphysics
from bayesian_inference_tpu.mcmc import stats as jstats
from bayesian_inference_tpu.models import emulator as jemulator
from bayesian_inference_tpu.pipeline import configs as jconfigs
from bayesian_inference_tpu_torch import physics as tphysics
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.mcmc import stats as tstats
from bayesian_inference_tpu_torch.models import emulator as temulator
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

# Prediction parity: the same float64 math in another order (the GP predict
# contracts the shared design distances once; JAX vmaps per PC), so every
# central value and covariance entry agrees to rtol 1e-10, as GP predict is
# held (tests/test_torch_gp.py).
RTOL = 1e-10


def _configs(path, module):
    config = module.load_yaml(path)
    name = next(iter(config["analyses"]))
    kw = dict(analysis_name=name, parameterization="exponential", analysis_config=config["analyses"][name],
              config_file=str(path))
    return module.EmulationConfig.from_config_file(**kw), kw


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The fixture analysis (2 + 2 PCs) fitted by the JAX package, both
    packages' configs, and prediction points in the prior box."""
    tmp = tmp_path_factory.mktemp("torch_predict")
    path, _, _ = make_analysis_yaml(tmp, n_restarts=1)
    jemu, kw = _configs(path, jconfigs)
    temu, _ = _configs(path, tconfigs)
    jemulator.fit_emulators(jemu, seed=0, n_opt_iters=10)
    box = kw["analysis_config"]["parameterization"]["exponential"]
    lo, hi = np.asarray(box["min"]), np.asarray(box["max"])
    theta = lo + (hi - lo) * np.random.default_rng(0).uniform(0.05, 0.95, (7, lo.size))
    return SimpleNamespace(jemu=jemu, temu=temu, artifacts=jemu.read_all_emulator_groups(), theta=theta)


def _assert_prediction_close(ours: dict, ref: dict) -> None:
    assert sorted(ours) == sorted(ref)
    for key in ref:
        ref_v = np.asarray(ref[key])
        assert ours[key].shape == ref_v.shape and ours[key].dtype == np.float64, key
        np.testing.assert_allclose(ours[key], ref_v, rtol=RTOL, atol=0, err_msg=key)


@pytest.mark.parametrize("scale", [True, False])
def test_predict_emulation_group_matches_jax(fitted, scale):
    """One group's central values (B, F) and covariance (B, F, F)."""
    art = fitted.artifacts["group_ch"]
    ref = jemulator.predict_emulation_group(fitted.theta, art, scale_cov_unexplained_by_n_samples=scale)
    ours = temulator.predict_emulation_group(fitted.theta, art, scale_cov_unexplained_by_n_samples=scale,
                                             device="cpu")
    _assert_prediction_close(ours, ref)


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("scale", [True, False])
def test_predict_matches_jax(fitted, merge, scale):
    """The merged prediction over both groups (per-observable covariance
    blocks on the global sorted feature axis), or the per-group dict."""
    kw = dict(merge_predictions_over_groups=merge, emulation_group_results=fitted.artifacts,
              scale_cov_unexplained_by_n_samples=scale)
    ref = jemulator.predict(fitted.theta, fitted.jemu, **kw)
    ours = temulator.predict(fitted.theta, fitted.temu, device="cpu", **kw)
    if merge:
        _assert_prediction_close(ours, ref)
        assert ours["cov"].shape == (7, 215, 215)
    else:
        assert sorted(ours) == sorted(ref) == ["group_ch", "group_pi"]
        for name in ref:
            _assert_prediction_close(ours[name], ref[name])


def test_predict_reads_the_artifacts_and_observables_from_disk(fitted):
    """Without the artifacts and the slice map, predict reads the pickles
    and the configured observables file, as the JAX package does: the same
    result as with them given."""
    observables = tobs.read_observables(fitted.temu.output_dir, "observables.h5")
    given = temulator.predict(fitted.theta[:2], fitted.temu, emulation_group_results=fitted.artifacts,
                              device="cpu", observables=observables)
    read = temulator.predict(fitted.theta[:2], fitted.temu, device="cpu")
    for key in given:
        np.testing.assert_array_equal(read[key], given[key])


def test_fit_emulator_group_matches_jax(tmp_path, monkeypatch):
    """One group's fit (1 + 1 restarts, 10 iterations), the port fed the
    restart points JAX draws from the same seed: the same artifact keys and
    kernel, the scaler + PCA at rtol 1e-10, the fitted LML per PC within
    0.1 nat (the repo's fit bar). Nothing is written."""
    monkeypatch.setenv("BIQ_FIT_LML", "matmul")  # the JAX fit's TPU path, as the port always runs
    path, _, _ = make_analysis_yaml(tmp_path, n_restarts=1)
    jgroup = _configs(path, jconfigs)[0].emulation_groups_config["group_pi"]
    tgroup = _configs(path, tconfigs)[0].emulation_groups_config["group_pi"]
    ref = jemulator.fit_emulator_group(jgroup, seed=3, n_opt_iters=10)
    spec = jgroup.fit_spec(n_iters=10)
    rand_logs = np.asarray(jax.random.uniform(jax.random.key(3), (jgroup.n_pc, spec.n_restarts, spec.theta0.shape[0]),
                                              dtype=spec.theta0.dtype, minval=spec.log_lo, maxval=spec.log_hi))
    inner = temulator.gp_fit.fit_gps
    monkeypatch.setattr(temulator.gp_fit, "fit_gps",
                        lambda spec, X, Y, generator=None: inner(spec, X, Y, rand_logs=torch_parity.t64(rand_logs)))
    ours = temulator.fit_emulator_group(tgroup, seed=3, n_opt_iters=10, device="cpu")

    assert sorted(ours) == sorted(ref) and sorted(ours["PCA"]) == sorted(ref["PCA"])
    assert sorted(ours["emulators"]) == sorted(ref["emulators"]) and ours["n_pc"] == ref["n_pc"]
    for key, value in ref["PCA"].items():
        np.testing.assert_allclose(ours["PCA"][key], value, rtol=1e-10, atol=1e-12, err_msg=key)
    assert ours["emulators"]["kernel"] == ref["emulators"]["kernel"]
    np.testing.assert_array_equal(ours["emulators"]["X"], ref["emulators"]["X"])
    np.testing.assert_allclose(ours["emulators"]["lml"], ref["emulators"]["lml"], rtol=0, atol=0.1)
    assert not os.path.exists(tgroup.emulation_outputfile)


def _chain(shape, seed):
    """A random walk with a drift, so that the autocorrelation is long."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=shape), axis=0) * 0.1 + rng.normal(size=shape)


@pytest.mark.parametrize("interval_type", ["hpd", "quantile"])
def test_credible_interval_and_map_match_jax(interval_type):
    samples = np.random.default_rng(1).gamma(2.0, size=5000)
    assert tstats.credible_interval(samples, 0.9, interval_type) == jstats.credible_interval(samples, 0.9,
                                                                                           interval_type)
    posterior = np.random.default_rng(2).normal(size=(4000, 6))
    np.testing.assert_array_equal(tstats.map_parameters(posterior), jstats.map_parameters(posterior))


def test_autocorrelation_statistics_match_jax():
    """autocorr_function_1d, integrated_time_per_walker (values and the
    reliable mask) and tau_vs_length_from_power on the same chain: equal."""
    chain = _chain((600, 8, 3), seed=4)
    np.testing.assert_array_equal(tstats.autocorr_function_1d(chain[:, 0, 0]),
                                  jstats.autocorr_function_1d(chain[:, 0, 0]))
    for ours, ref in zip(tstats.integrated_time_per_walker(chain), jstats.integrated_time_per_walker(chain)):
        np.testing.assert_array_equal(ours, ref)
    power, nfft = tstats.device_mean_power(torch_parity.t64(chain))
    lengths = [100, 250, 600]
    np.testing.assert_array_equal(tstats.tau_vs_length_from_power(power, nfft, 600, lengths),
                                  jstats.tau_vs_length_from_power(power, nfft, 600, lengths))


@pytest.mark.parametrize("T,E", [(0.16, 100.0), (0.3, 5.0), (0.5, 200.0)])
def test_physics_matches_jax(T, E):
    """qhat on prior samples drawn by both packages from the same seed."""
    names = ["alpha_s", "Q0", "c_1", "c_2", "tau_0", "c_3"]
    lo, hi = [0.1, 1, 0.0067, 0.0067, 0, 0.0498], [0.5, 10, 10, 10, 1.5, 100]
    ours = tphysics.generate_prior_samples(names, lo, hi, n_samples=500, rng=np.random.default_rng(5))
    ref = jphysics.generate_prior_samples(names, lo, hi, n_samples=500, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tphysics.qhat(ours, "exponential", T=T, E=E), jphysics.qhat(ref, "exponential",
                                                                                              T=T, E=E))
