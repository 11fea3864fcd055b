"""Port parity of the sampling half of the main path: block-mode likelihood,
stretch move, chain statistics and run_mcmc, fed the JAX package's fitted
emulator artifacts on the bundled fixture; plus the port's own
fit-then-sample run and its import hygiene."""

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
from bayesian_inference_tpu_torch.models import emulator as temulator
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

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
    jlike = jlik.build_likelihood(jemu, artifacts, exp, theta_min=lo, theta_max=hi)
    tlike = tlik.build_likelihood(temu, artifacts, exp, theta_min=lo, theta_max=hi, observables=observables)
    return SimpleNamespace(path=path, tmp=tmp, jmcmc=jmcmc, temu=temu, tmcmc=tmcmc, artifacts=artifacts,
                           observables=observables, exp=exp, lo=lo, hi=hi, jlike=jlike, tlike=tlike)


def test_block_log_posterior_matches_jax(fixture_run):
    """log_posterior on JAX-fitted artifacts, inside and outside the prior box:
    rtol 1e-8 where finite and the same -inf pattern."""
    r = fixture_run
    rng = np.random.default_rng(0)
    theta = r.lo + (r.hi - r.lo) * rng.uniform(0.02, 0.98, (12, r.lo.size))
    theta[[2, 5, 9], [0, 3, 5]] = [r.lo[0] - 0.1, r.hi[3] + 1.0, r.hi[5] * 2]
    theta[7] = r.lo  # on the boundary: outside (the box is open)
    ref = np.asarray(r.jlike.log_posterior(jnp.asarray(theta)))
    ours = to_np(r.tlike.log_posterior(t64(theta)))
    outside = np.isneginf(ref)
    assert outside.sum() == 4
    np.testing.assert_array_equal(np.isneginf(ours), outside)
    np.testing.assert_allclose(ours[~outside], ref[~outside], rtol=1e-8)
    assert len(r.tlike.U) == len(r.jlike.U)  # same bucket layout
    for ours_b, ref_b in zip(r.tlike.U, r.jlike.U):
        np.testing.assert_array_equal(to_np(ours_b), np.asarray(ref_b))


def test_stretch_move_with_injected_jax_draws(fixture_run):
    """20 ensemble steps of 16 walkers on the fixture likelihood, the port fed
    the JAX sampler's own pregenerated draws: chains and log-probs agree at
    rtol 1e-10 and every accept decision is the same."""
    r = fixture_run
    key = jax.random.key(3)
    x0 = r.lo + (r.hi - r.lo) * np.random.default_rng(1).uniform(0.1, 0.9, (N_WALKERS, r.lo.size))
    fn = r.jlike.log_posterior
    _, (jchain, jlogp, jacc) = jstretch.run_chunk(jstretch.init_state(key, fn, jnp.asarray(x0)), fn, 20)
    rands, _ = jstretch._pregen_rands(key, 20, N_WALKERS, jnp.float64, True)
    rands = {k: torch.tensor(np.asarray(v)) for k, v in rands.items()}
    state = tstretch.init_state(r.tlike.log_posterior, t64(x0))
    final, (chain, logp, acc) = tstretch.run_chunk(state, r.tlike.log_posterior, 20, rands=rands)
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


def test_run_mcmc_matches_jax_under_injected_draws(fixture_run):
    """The slice's sampling half as a whole: JAX artifacts in, the port's
    run_mcmc out. With JAX's draws injected, the burn-in log-probs equal
    JAX's (rtol 1e-8), and the production chain equals the chain JAX's own
    run_mcmc writes to mcmc.h5."""
    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

    r = fixture_run
    draws, jburn = _jax_run_mcmc_draws(r.jlike, r.jmcmc, r.lo, r.hi)
    out = trunner.run_mcmc(r.tmcmc, emulation_results=r.artifacts, observables=r.observables, write=False,
                           draws=draws)
    np.testing.assert_allclose(out["burn_log_prob"], jburn, rtol=1e-8)

    jrunner.run_mcmc(r.jmcmc, seed=0)
    jout = read_dict_from_h5(r.jmcmc.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_allclose(out["log_prob"], jout["log_prob"], rtol=1e-8)
    np.testing.assert_allclose(out["chain"], jout["chain"], rtol=1e-10)
    np.testing.assert_allclose(out["acceptance_fraction"], jout["acceptance_fraction"], rtol=1e-12)
    np.testing.assert_allclose(out["split_rhat"], jout["split_rhat"], rtol=1e-10)


def test_port_fit_then_sample_on_fixture(fixture_run, tmp_path):
    """The port's own main path on the fixture through files, as a user runs
    it: fit_emulators writes the emulator pickles, run_mcmc reads them and
    writes mcmc.h5 and mcmc_sampler.pkl."""
    path, _, _ = make_analysis_yaml(tmp_path, n_walkers=N_WALKERS, n_burn_steps=N_BURN,
                                    n_sampling_steps=N_STEPS, n_restarts=4)
    temu, tmcmc, _ = _configs(path, tconfigs)
    artifacts = temulator.fit_emulators(temu, seed=0, n_opt_iters=20)
    assert sorted(artifacts) == ["group_ch", "group_pi"]
    for name, art in artifacts.items():
        assert Path(temu.emulation_groups_config[name].emulation_outputfile).exists()
        assert np.isfinite(art["emulators"]["lml"]).all()
    out = trunner.run_mcmc(tmcmc, seed=1)
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


def test_chain_statistics_match_jax():
    """integrated_time and split_rhat on one random-walk chain, rtol 1e-10."""
    rng = np.random.default_rng(8)
    chain = np.cumsum(rng.normal(size=(600, 8, 3)), axis=0) * 0.05 + rng.normal(size=(600, 8, 3))
    np.testing.assert_allclose(tstats.split_rhat(chain), jstats.split_rhat(chain), rtol=1e-10)
    np.testing.assert_allclose(tstats.integrated_time(chain, quiet=True),
                               jstats.integrated_time(chain, quiet=True), rtol=1e-10)
    with pytest.raises(tstats.AutocorrError):
        tstats.integrated_time(chain)


def test_lowrank_mode_is_not_ported_yet(fixture_run):
    r = fixture_run
    with pytest.raises(NotImplementedError, match="lowrank"):
        tlik.build_likelihood(r.temu, r.artifacts, r.exp, r.lo, r.hi, mode="lowrank", observables=r.observables)


def test_port_never_imports_jax():
    """Importing every module of the port pulls in no JAX (the card's machine
    has none)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bayesian_inference_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert len(names) > 20, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-c", code], cwd=src, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
