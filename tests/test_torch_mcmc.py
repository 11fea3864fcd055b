"""Port parity of the sampling half of the main path: block- and lowrank-mode
likelihoods (also with swapped residual offsets, one per closure point),
stretch move, host and device chain statistics and run_mcmc, fed the JAX
package's fitted emulator artifacts on the bundled fixture; plus the port's
own fit-then-sample run and its import hygiene."""

import inspect
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from config_factory import make_analysis_yaml
from torch_parity import t64, to_np

from bayesian_inference_tpu.io import observables as jobs
from bayesian_inference_tpu.mcmc import likelihood as jlik
from bayesian_inference_tpu.mcmc import runner as jrunner
from bayesian_inference_tpu.mcmc import stats as jstats
from bayesian_inference_tpu.mcmc import stretch as jstretch
from bayesian_inference_tpu.models import emulator as jemulator
from bayesian_inference_tpu.pipeline import configs as jconfigs
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.mcmc import likelihood as tlik
from bayesian_inference_tpu_torch.mcmc import runner as trunner
from bayesian_inference_tpu_torch.mcmc import stats as tstats
from bayesian_inference_tpu_torch.mcmc import stretch as tstretch
from bayesian_inference_tpu_torch.mcmc.sampler_archive import EnsembleSamplerArchive
from bayesian_inference_tpu_torch.models import cv as tcv
from bayesian_inference_tpu_torch.models import emulator as temulator
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs
from bayesian_inference_tpu_torch.pipeline import steer as tsteer
from bayesian_inference_tpu_torch.plots import emulation as tplot_emulation
from bayesian_inference_tpu_torch.plots import mcmc as tplot_mcmc
from bayesian_inference_tpu_torch.plots import qhat as tplot_qhat

N_WALKERS, N_BURN, N_STEPS = 16, 40, 100


def _configs(path: Path, module):
    config = module.load_yaml(path)
    analysis_name = next(iter(config["analyses"]))
    ac = config["analyses"][analysis_name]
    kw = dict(analysis_name=analysis_name, parameterization="exponential", analysis_config=ac,
              config_file=str(path))
    return module.EmulationConfig.from_config_file(**kw), module.MCMCConfig(**kw), ac


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    """The fixture analysis (2 + 2 PCs, 4 restarts, 20 iterations) fitted by
    the JAX package, and both packages' likelihoods built from its artifacts."""
    tmp = tmp_path_factory.mktemp("torch_mcmc")
    path, _, _ = make_analysis_yaml(tmp, n_walkers=N_WALKERS, n_burn_steps=N_BURN,
                                    n_sampling_steps=N_STEPS, n_restarts=4)
    jemu, jmcmc, ac = _configs(path, jconfigs)
    temu, tmcmc, _ = _configs(path, tconfigs)
    jemulator.fit_emulators(jemu, seed=0, n_opt_iters=20)
    artifacts = jemu.read_all_emulator_groups()
    observables = tobs.read_observables(temu.output_dir, "observables.h5")
    exp = jobs.data_array_from_h5(jemu.output_dir, "observables.h5", observable_filter=jemu.observable_filter)
    box = ac["parameterization"]["exponential"]
    lo, hi = np.asarray(box["min"]), np.asarray(box["max"])
    jlike = {mode: jlik.build_likelihood(jemu, artifacts, exp, theta_min=lo, theta_max=hi, mode=mode)
             for mode in ("block", "lowrank")}
    tlike = {mode: tlik.build_likelihood(temu, artifacts, exp, theta_min=lo, theta_max=hi, mode=mode,
                                         device="cpu", observables=observables)
             for mode in ("block", "lowrank")}
    return SimpleNamespace(path=path, tmp=tmp, jemu=jemu, jmcmc=jmcmc, temu=temu, tmcmc=tmcmc, artifacts=artifacts,
                           observables=observables, exp=exp, lo=lo, hi=hi, jlike=jlike, tlike=tlike)


def _thetas(r, n=12, seed=0):
    """n positions in the prior box, four of them outside (one on the boundary)."""
    rng = np.random.default_rng(seed)
    theta = r.lo + (r.hi - r.lo) * rng.uniform(0.02, 0.98, (n, r.lo.size))
    theta[[2, 5, 9], [0, 3, 5]] = [r.lo[0] - 0.1, r.hi[3] + 1.0, r.hi[5] * 2]
    theta[7] = r.lo  # on the boundary: outside (the box is open)
    return theta


def _log_posterior_matches_jax(r, mode):
    """log_posterior on JAX-fitted artifacts, inside and outside the prior box:
    rtol 1e-8 where finite and the same -inf pattern."""
    theta = _thetas(r)
    ref = np.asarray(r.jlike[mode].log_posterior(jnp.asarray(theta)))
    ours = to_np(r.tlike[mode].log_posterior(t64(theta)))
    outside = np.isneginf(ref)
    assert outside.sum() == 4
    np.testing.assert_array_equal(np.isneginf(ours), outside)
    np.testing.assert_allclose(ours[~outside], ref[~outside], rtol=1e-8)
    assert len(r.tlike[mode].U) == len(r.jlike[mode].U)  # same bucket layout
    for ours_b, ref_b in zip(r.tlike[mode].U, r.jlike[mode].U):
        np.testing.assert_array_equal(to_np(ours_b), np.asarray(ref_b))
    if mode == "lowrank":
        for name in ("b", "G", "c0", "half_logdet_D", "U", "d0"):
            np.testing.assert_allclose(to_np(getattr(r.tlike[mode].wb, name)),
                                       np.asarray(getattr(r.jlike[mode].wb, name)), rtol=1e-10, atol=1e-12)


def test_block_log_posterior_matches_jax(fixture_run):
    _log_posterior_matches_jax(fixture_run, "block")


def test_lowrank_log_posterior_matches_jax(fixture_run):
    """Lowrank mode: also the Woodbury pieces against JAX's (rtol 1e-10)."""
    _log_posterior_matches_jax(fixture_run, "lowrank")


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_log_posterior_with_d0_matches_jax(fixture_run, mode):
    """The closure batch's likelihood: two validation points' pseudodata as
    residual offsets (bucketed in block mode, flat in lowrank mode), equal to
    JAX's offsets; the batched log-posterior over (P, W, d) walkers and the
    single-point one against JAX's log_posterior_with_d0 per point (rtol 1e-8,
    same -inf pattern)."""
    r = fixture_run
    ys = np.stack([jobs.data_array_from_h5(r.jemu.output_dir, "observables.h5", pseudodata_index=i,
                                           observable_filter=r.jemu.observable_filter,
                                           rng=np.random.default_rng(i))["y"] for i in (0, 1)])
    if mode == "block":
        jd0 = jlik.pad_residual_offsets(r.jemu, r.artifacts, ys)
        td0 = tlik.pad_residual_offsets(r.temu, r.artifacts, ys, observables=r.observables)
        for a, b in zip(td0, jd0):
            np.testing.assert_array_equal(a, b)
        td0 = tuple(t64(d) for d in td0)
        jpoint, tpoint = (lambda p: tuple(jnp.asarray(d[p]) for d in jd0)), (lambda p: tuple(d[p] for d in td0))
    else:
        jd0 = jlik.residual_offsets_flat(r.jemu, r.artifacts, ys)
        td0 = tlik.residual_offsets_flat(r.temu, r.artifacts, ys, observables=r.observables)
        np.testing.assert_array_equal(td0, jd0)
        td0 = t64(td0)
        jpoint, tpoint = (lambda p: jnp.asarray(jd0[p])), (lambda p: td0[p])
    theta = np.stack([_thetas(r, seed=1), _thetas(r, seed=2)])
    batched = to_np(r.tlike[mode].log_posterior_with_d0(td0, t64(theta)))
    assert batched.shape == (2, 12)
    for p in range(2):
        ref = np.asarray(r.jlike[mode].log_posterior_with_d0(jpoint(p), jnp.asarray(theta[p])))
        single = to_np(r.tlike[mode].log_posterior_with_d0(tpoint(p), t64(theta[p])))
        outside = np.isneginf(ref)
        for ours in (batched[p], single):
            np.testing.assert_array_equal(np.isneginf(ours), outside)
            np.testing.assert_allclose(ours[~outside], ref[~outside], rtol=1e-8)


def test_block_likelihood_is_one_all_bucket_call(fixture_run, monkeypatch):
    """A block-mode evaluation hands every bucket to one call of the fused
    kernel's wrapper (one launch on the card), whatever the bucket count."""
    r = fixture_run
    like = r.tlike["block"]
    inner, calls = tlik.fused_block_mvn_loglike_buckets, []

    def counted(Us, Ds, d0s, z, v):
        calls.append(len(Us))
        return inner(Us, Ds, d0s, z, v)

    monkeypatch.setattr(tlik, "fused_block_mvn_loglike_buckets", counted)
    lp = like.log_posterior(t64(_thetas(r)))
    assert calls == [len(like.U)]
    assert np.isfinite(to_np(lp)).sum() == 8


def test_unknown_likelihood_mode_is_refused(fixture_run):
    r = fixture_run
    with pytest.raises(ValueError, match="unknown likelihood mode"):
        tlik.build_likelihood(r.temu, r.artifacts, r.exp, r.lo, r.hi, mode="dense", device="cpu",
                              observables=r.observables)


def test_stretch_move_with_injected_jax_draws(fixture_run):
    """20 ensemble steps of 16 walkers on the fixture likelihood, the port fed
    the JAX sampler's own pregenerated draws: chains and log-probs agree at
    rtol 1e-10 and every accept decision is the same."""
    r = fixture_run
    key = jax.random.key(3)
    x0 = r.lo + (r.hi - r.lo) * np.random.default_rng(1).uniform(0.1, 0.9, (N_WALKERS, r.lo.size))
    fn = r.jlike["block"].log_posterior
    _, (jchain, jlogp, jacc) = jstretch.run_chunk(jstretch.init_state(key, fn, jnp.asarray(x0)), fn, 20)
    rands, _ = jstretch._pregen_rands(key, 20, N_WALKERS, jnp.float64, True)
    rands = {k: torch.tensor(np.asarray(v)) for k, v in rands.items()}
    tfn = r.tlike["block"].log_posterior
    state = tstretch.init_state(tfn, t64(x0))
    final, (chain, logp, acc) = tstretch.run_chunk(state, tfn, 20, rands=rands)
    np.testing.assert_allclose(to_np(chain), np.asarray(jchain), rtol=1e-10)
    np.testing.assert_allclose(to_np(logp), np.asarray(jlogp), rtol=1e-10)
    np.testing.assert_array_equal(to_np(acc), np.asarray(jacc))
    assert 0 < int(final.n_accepted.sum()) < 20 * N_WALKERS


def _jax_run_mcmc_draws(like, config, lo, hi, seed=0):
    """The key schedule of JAX's run_mcmc, replayed: its start, the burn-in
    phases run as run_mcmc runs them without AOT programs (run_ensemble), and
    every phase's pregenerated draws."""
    W, n0 = config.n_walkers, config.n_burn_steps // 2
    n1 = config.n_burn_steps - n0
    key, k_init = jax.random.split(jax.random.key(seed))
    x0 = jax.random.uniform(k_init, (W, lo.size), minval=jnp.asarray(lo), maxval=jnp.asarray(hi),
                            dtype=jnp.float64)
    key, k1 = jax.random.split(key)
    out1 = jstretch.run_ensemble(k1, like.log_posterior, x0, n0)
    x_top = jrunner.resample_walkers_to_top_positions(np.asarray(out1["chain"]), np.asarray(out1["log_prob"]), W)
    key, k2 = jax.random.split(key)
    out2 = jstretch.run_ensemble(k2, like.log_posterior, jnp.asarray(x_top), n1)
    _, k3 = jax.random.split(key)

    def draws(k, n):
        return {name: np.asarray(v) for name, v in jstretch._pregen_rands(k, n, W, jnp.float64, True)[0].items()}

    burn_log_prob = np.concatenate([np.asarray(out1["log_prob"]), np.asarray(out2["log_prob"])])
    return {"x0": np.asarray(x0), "burn": [draws(k1, n0), draws(k2, n1)],
            "production": draws(k3, config.n_sampling_steps)}, burn_log_prob


def _run_mcmc_matches_jax_under_injected_draws(r, mode):
    """JAX artifacts in, the port's run_mcmc out. With JAX's draws injected,
    the burn-in log-probs equal JAX's (rtol 1e-8), and the production chain
    equals the chain JAX's own run_mcmc writes to mcmc.h5."""
    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

    draws, jburn = _jax_run_mcmc_draws(r.jlike[mode], r.jmcmc, r.lo, r.hi)
    out = trunner.run_mcmc(r.tmcmc, device="cpu", emulation_results=r.artifacts, observables=r.observables,
                           write=False, draws=draws, mode=mode)
    np.testing.assert_allclose(out["burn_log_prob"], jburn, rtol=1e-8)

    jrunner.run_mcmc(r.jmcmc, seed=0, mode=mode)
    jout = read_dict_from_h5(r.jmcmc.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_allclose(out["log_prob"], jout["log_prob"], rtol=1e-8)
    np.testing.assert_allclose(out["chain"], jout["chain"], rtol=1e-10)
    np.testing.assert_allclose(out["acceptance_fraction"], jout["acceptance_fraction"], rtol=1e-12)
    np.testing.assert_allclose(out["split_rhat"], jout["split_rhat"], rtol=1e-10)


def test_run_mcmc_matches_jax_under_injected_draws(fixture_run):
    """The slice's sampling half as a whole (block mode)."""
    _run_mcmc_matches_jax_under_injected_draws(fixture_run, "block")


def test_lowrank_run_mcmc_matches_jax_under_injected_draws(fixture_run):
    """The lowrank analysis as a whole: Woodbury likelihood and the tiny-MVN
    kernel's plain version inside the port's run_mcmc."""
    _run_mcmc_matches_jax_under_injected_draws(fixture_run, "lowrank")


def test_port_fit_then_sample_on_fixture(fixture_run, tmp_path):
    """The port's own main path on the fixture through files, as a user runs
    it: fit_emulators writes the emulator pickles, run_mcmc reads them and
    writes mcmc.h5 and mcmc_sampler.pkl."""
    path, _, _ = make_analysis_yaml(tmp_path, n_walkers=N_WALKERS, n_burn_steps=N_BURN,
                                    n_sampling_steps=N_STEPS, n_restarts=4)
    temu, tmcmc, _ = _configs(path, tconfigs)
    artifacts = temulator.fit_emulators(temu, seed=0, n_opt_iters=20, device="cpu")
    assert sorted(artifacts) == ["group_ch", "group_pi"]
    for name, art in artifacts.items():
        assert Path(temu.emulation_groups_config[name].emulation_outputfile).exists()
        assert np.isfinite(art["emulators"]["lml"]).all()
    out = trunner.run_mcmc(tmcmc, seed=1, device="cpu")
    assert out["chain"].shape == (N_STEPS, N_WALKERS, 6)
    assert np.isfinite(out["log_prob"]).all()
    assert 0.0 < out["acceptance_fraction"].mean() < 1.0
    assert out["burn_log_prob"].shape == (N_BURN, N_WALKERS)

    archive = EnsembleSamplerArchive.load(tmcmc.sampler_outputfile)
    np.testing.assert_array_equal(archive.get_chain(), out["chain"])
    np.testing.assert_array_equal(archive.get_log_prob(discard=10, thin=2), out["log_prob"][10::2])
    sliced = archive.get_chain(discard=20, thin=2)
    np.testing.assert_allclose(archive.get_autocorr_time(discard=20, thin=2, quiet=True),
                               2 * tstats.integrated_time(sliced, quiet=True))


def _random_walk(shape, seed=8):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=shape), axis=0) * 0.05 + rng.normal(size=shape)


def test_chain_statistics_match_jax():
    """integrated_time and split_rhat on one random-walk chain, rtol 1e-10."""
    chain = _random_walk((600, 8, 3))
    np.testing.assert_allclose(tstats.split_rhat(chain), jstats.split_rhat(chain), rtol=1e-10)
    np.testing.assert_allclose(tstats.integrated_time(chain, quiet=True),
                               jstats.integrated_time(chain, quiet=True), rtol=1e-10)
    with pytest.raises(tstats.AutocorrError):
        tstats.integrated_time(chain)


def test_integrated_time_from_a_power_spectrum_matches_jax():
    """integrated_time(mean_power=...) on the same spectrum as JAX's
    (rtol 1e-8); the port's device spectrum and R-hat, computed on a CPU
    tensor, against JAX's device functions and its host estimators."""
    chain = _random_walk((600, 8, 3), seed=9)
    power, nfft = tstats.device_mean_power(torch.tensor(chain))
    jpower, jnfft = jstats.device_mean_power(jnp.asarray(chain))
    assert nfft == jnfft == 2048
    np.testing.assert_allclose(power, np.asarray(jpower), rtol=1e-10, atol=1e-14)
    ours = tstats.integrated_time(chain, quiet=True, mean_power=(power, nfft))
    np.testing.assert_allclose(ours, jstats.integrated_time(chain, quiet=True, mean_power=(power, nfft)), rtol=1e-8)
    np.testing.assert_allclose(ours, jstats.integrated_time(chain, quiet=True), rtol=1e-8)
    with pytest.raises(tstats.AutocorrError):
        tstats.integrated_time(chain, mean_power=(power, nfft))
    np.testing.assert_allclose(tstats.device_split_rhat(torch.tensor(chain)), jstats.split_rhat(chain), rtol=1e-10)


def test_batched_and_device_closure_statistics_match_jax():
    """integrated_time_batched on (n_t, P, W, d) chains and the per-point
    device spectra and R-hats, against JAX's batched and per-point host
    estimators (rtol 1e-8; R-hat 1e-10)."""
    chain = _random_walk((500, 3, 8, 2), seed=10)
    tau, reliable = tstats.integrated_time_batched(chain)
    jtau, jreliable = jstats.integrated_time_batched(chain)
    np.testing.assert_allclose(tau, jtau, rtol=1e-8)
    np.testing.assert_array_equal(reliable, jreliable)
    powers, nfft, rhat = tstats.device_closure_stats(torch.tensor(chain))
    jpowers, jnfft, jrhat = jstats.device_closure_stats([jnp.asarray(chain)])
    assert nfft == jnfft
    np.testing.assert_allclose(powers, jpowers, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(rhat, jrhat, rtol=1e-10)
    for p in range(3):
        tau_p, rel_p = tstats.integrated_time_from_power(powers[p], nfft, 500, out_dtype=np.float64)
        jtau_p, jrel_p = jstats.integrated_time_from_power(jpowers[p], nfft, 500, out_dtype=np.float64)
        np.testing.assert_allclose(tau_p, jtau_p, rtol=1e-10)
        np.testing.assert_allclose(tau_p, jstats.integrated_time(chain[:, p], quiet=True), rtol=1e-8)
        np.testing.assert_array_equal(rel_p, jrel_p)
        np.testing.assert_allclose(rhat[p], jstats.split_rhat(chain[:, p]), rtol=1e-10)


# The port's entry points, each with the arguments of a call on the fixture
# that leaves ``device`` at its default.
ENTRY_POINTS = {
    "fit_emulators": (temulator.fit_emulators, lambda r: ((r.temu,), {"write": False})),
    "posterior_from_artifact": (temulator.posterior_from_artifact,
                                lambda r: ((r.artifacts[next(iter(r.artifacts))],), {})),
    "cross_validate_group": (tcv.cross_validate_group,
                             lambda r: ((next(iter(r.temu.emulation_groups_config.values())),), {"k": 2})),
    "cross_validate": (tcv.cross_validate, lambda r: ((r.temu,), {"write": False})),
    "run_mcmc": (trunner.run_mcmc, lambda r: ((r.tmcmc,), {"emulation_results": r.artifacts, "write": False})),
    "run_closure_batch": (trunner.run_closure_batch,
                          lambda r: ((r.tmcmc, [0]), {"emulation_results": r.artifacts, "write": False})),
    "build_likelihood": (tlik.build_likelihood,
                         lambda r: ((r.temu, r.artifacts, r.exp, r.lo, r.hi), {"observables": r.observables})),
    "SteerAnalysis": (tsteer.SteerAnalysis, lambda r: ((), {"config_file": str(r.path), "write": False})),
    "fit_emulator_group": (temulator.fit_emulator_group,
                           lambda r: ((next(iter(r.temu.emulation_groups_config.values())),), {})),
    "predict_emulation_group": (temulator.predict_emulation_group,
                                lambda r: ((r.lo[None], r.artifacts[next(iter(r.artifacts))]), {})),
    "predict": (temulator.predict, lambda r: ((r.lo[None], r.temu), {"emulation_group_results": r.artifacts})),
    "plots.emulation.plot": (tplot_emulation.plot, lambda r: ((r.temu,), {})),
    "plots.mcmc.plot": (tplot_mcmc.plot, lambda r: ((r.tmcmc,), {})),
    "plots.qhat.plot": (tplot_qhat.plot, lambda r: ((r.tmcmc,), {})),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    """Every entry point of the port runs on the card unless the caller asks
    for the CPU."""
    fn = ENTRY_POINTS[name][0]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_default_raises_without_a_card(fixture_run, monkeypatch, name):
    """Called with the default device where torch finds no card, an entry
    point raises before any work; it never falls back to the CPU."""
    fn, call = ENTRY_POINTS[name]
    args, kwargs = call(fixture_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args, **kwargs)


def test_port_never_imports_jax():
    """Importing every module of the port, the steer entry point, the
    modules it runs and the plots among them, pulls in no JAX (the card's
    machine has none) and no module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bayesian_inference_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert len(names) > 20, names\n"
        "for n in ('pipeline.steer', 'models.cv', 'preprocess', 'preprocess.outliers', 'utils.profiling',\n"
        "          'utils.helpers', 'plots', 'plots.utils', 'plots.input_data', 'plots.emulation', 'plots.mcmc',\n"
        "          'plots.qhat', 'plots.closure', 'plots.analyses', 'physics', 'physics.qhat', 'physics.priors'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'bayesian_inference_tpu'))\n"
        "assert not bad, bad\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-c", code], cwd=src, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("runner_name", ["run_mcmc", "run_closure_batch"])
def test_runner_dtype_matches_the_jax_dtype(fixture_run, runner_name):
    """``dtype=torch.float32`` on both runners (the CPU default is float64):
    the chain and log-probs come back in float32, the checkpoint header would
    pin it, and the log-probs the run carries equal the JAX package's
    likelihood built with ``dtype=float32`` evaluated at the run's last
    positions (rtol 2e-4 and atol 2e-3 on values of a few hundred: float32
    through the GP predict and the block Cholesky); prewarm_sampler_programs
    takes the same ``dtype`` and its handle serves the run."""
    from bayesian_inference_tpu_torch.mcmc import programs as tprograms

    r = fixture_run
    kw = dict(device="cpu", emulation_results=r.artifacts, observables=r.observables, write=False, seed=4,
              dtype=torch.float32)
    jlike = jlik.build_likelihood(r.jemu, r.artifacts, r.exp, theta_min=r.lo, theta_max=r.hi,
                                  dtype=jnp.dtype("float32"))
    assert jlike.theta_min.dtype == jnp.float32
    if runner_name == "run_mcmc":
        programs = tprograms.prewarm_sampler_programs(r.tmcmc, device="cpu", observables=r.observables,
                                                      dtype=torch.float32)
        assert programs._like.theta_min.dtype == torch.float32
        out = trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
        assert out["chain"].dtype == out["log_prob"].dtype == np.float32
        ref = np.asarray(jlike.log_posterior(jnp.asarray(out["chain"][-1])))
        np.testing.assert_allclose(out["log_prob"][-1], ref, rtol=2e-4, atol=2e-3)
        wide = trunner.run_mcmc(r.tmcmc, **{**kw, "dtype": None})
        assert wide["chain"].dtype == np.float64
    else:
        out = trunner.run_closure_batch(r.tmcmc, [0, 1], **kw)
        ys = np.stack([out[i]["experimental_pseudodata"]["y"] for i in (0, 1)])
        jd0 = jlik.pad_residual_offsets(r.jemu, r.artifacts, ys)
        for p, i in enumerate((0, 1)):
            assert out[i]["chain"].dtype == out[i]["log_prob"].dtype == np.float32
            d0 = tuple(jnp.asarray(d[p], jnp.float32) for d in jd0)
            ref = np.asarray(jlike.log_posterior_with_d0(d0, jnp.asarray(out[i]["chain"][-1])))
            np.testing.assert_allclose(out[i]["log_prob"][-1], ref, rtol=2e-4, atol=2e-3)
