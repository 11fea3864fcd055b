"""Port parity of the closure-test path: run_mcmc on one validation point's
pseudodata (against the JAX package's pseudodata and design point), and the
batched closure runner against the port's sequential runner, point by point,
in both likelihood modes, on the bundled fixture."""

import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from config_factory import make_analysis_yaml

from bayesian_inference_tpu.io import observables as jobs
from bayesian_inference_tpu_torch.io import hdf5
from bayesian_inference_tpu_torch.mcmc import runner as trunner
from bayesian_inference_tpu_torch.models import emulator as temulator
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

N_WALKERS, N_BURN, N_STEPS = 12, 16, 40
INDICES = (0, 2)


@pytest.fixture(scope="module")
def closure_fixture(tmp_path_factory):
    """The fixture analysis (2 + 2 PCs) fitted by the port, written to disk
    the way a user's run leaves it."""
    tmp = tmp_path_factory.mktemp("torch_closure")
    path, name, param = make_analysis_yaml(tmp, n_walkers=N_WALKERS, n_burn_steps=N_BURN,
                                           n_sampling_steps=N_STEPS, n_restarts=1)
    ac = tconfigs.load_yaml(path)["analyses"][name]
    kw = dict(analysis_name=name, parameterization=param, analysis_config=ac, config_file=str(path))
    emu = tconfigs.EmulationConfig.from_config_file(**kw)
    temulator.fit_emulators(emu, seed=0, n_opt_iters=20, device="cpu")

    def config(closure_index=-1):
        return tconfigs.MCMCConfig(**kw, closure_index=closure_index)

    return SimpleNamespace(emu=emu, config=config)


def test_closure_run_mcmc_uses_the_jax_pseudodata(closure_fixture):
    """run_mcmc(closure_index=i, seed=s): the data vector is JAX's
    data_array_from_h5(pseudodata_index=i, rng=default_rng(s + 12345)), and
    the output (and closure/results/<i>/mcmc.h5) carries the validation
    design point and the pseudodata."""
    r = closure_fixture
    cfg = r.config(closure_index=1)
    out = trunner.run_mcmc(cfg, seed=3, device="cpu", closure_index=1)
    ref = jobs.data_array_from_h5(cfg.output_dir, "observables.h5", pseudodata_index=1,
                                  observable_filter=r.emu.observable_filter, rng=np.random.default_rng(3 + 12345))
    for key in ("y", "y_err"):
        np.testing.assert_array_equal(out["experimental_pseudodata"][key], ref[key])
    design = jobs.design_array_from_h5(cfg.output_dir, "observables.h5", validation_set=True)
    np.testing.assert_array_equal(out["design_point"], design[1])
    assert cfg.mcmc_output_dir.endswith("closure/results/1")
    stored = hdf5.read_dict_from_h5(cfg.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_array_equal(stored["design_point"], design[1])
    np.testing.assert_array_equal(stored["experimental_pseudodata"]["y"], ref["y"])
    np.testing.assert_array_equal(stored["chain"], out["chain"])
    assert Path(cfg.sampler_outputfile).exists()


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_batched_closure_matches_sequential(closure_fixture, mode):
    """run_closure_batch over two validation points equals the port's
    sequential run_mcmc(closure_index=i, seed=i) point by point: the same
    pseudodata, chains and acceptance, log-probs within float64 rounding of
    the larger batch (rtol 1e-12), the same diagnostics, and
    closure/results/<i>/mcmc.h5 written in the sequential format."""
    r = closure_fixture
    seq = {}
    for i in INDICES:
        cfg = r.config(closure_index=i)
        seq[i] = trunner.run_mcmc(cfg, seed=i, device="cpu", closure_index=i, mode=mode)
        shutil.rmtree(cfg.mcmc_output_dir)

    batched = trunner.run_closure_batch(r.config(), INDICES, seed=0, device="cpu", mode=mode)
    assert sorted(batched) == list(INDICES)
    for i in INDICES:
        b, s = batched[i], seq[i]
        assert b["chain"].shape == (N_STEPS, N_WALKERS, 6)
        for key in ("y", "y_err"):
            np.testing.assert_array_equal(b["experimental_pseudodata"][key], s["experimental_pseudodata"][key])
        np.testing.assert_array_equal(b["design_point"], s["design_point"])
        np.testing.assert_array_equal(b["chain"], s["chain"])
        np.testing.assert_allclose(b["log_prob"], s["log_prob"], rtol=1e-12)
        np.testing.assert_array_equal(b["acceptance_fraction"], s["acceptance_fraction"])
        np.testing.assert_allclose(b["split_rhat"], s["split_rhat"], rtol=1e-10)
        assert (b["autocorrelation_time"] is None) == (s["autocorrelation_time"] is None)
        stored = hdf5.read_dict_from_h5(r.config(closure_index=i).mcmc_output_dir, "mcmc.h5", verbose=False)
        np.testing.assert_array_equal(stored["chain"], b["chain"])
        np.testing.assert_array_equal(stored["log_prob"], b["log_prob"])
        assert stored["design_point"].shape == (6,)
        assert set(stored["experimental_pseudodata"]) == {"y", "y_err"}


def _batch_draws(n_points, seed=7):
    """Every draw of a closure batch (start, both burn-in phases, production)
    as numpy arrays in the pregen_rands_batched layout."""
    import torch

    from bayesian_inference_tpu_torch.mcmc import stretch

    gens = [torch.Generator().manual_seed(seed + p) for p in range(n_points)]

    def draws(n):
        return {k: v.numpy() for k, v in stretch.pregen_rands_batched(n, N_WALKERS, gens, torch.float64).items()}

    x0 = np.random.default_rng(seed).uniform(0.2, 0.8, (n_points, N_WALKERS, 6))
    return {"x0": x0, "burn": [draws(N_BURN // 2), draws(N_BURN - N_BURN // 2)], "production": draws(N_STEPS)}


def _scaled_start(r, draws):
    """The unit-cube start of ``_batch_draws`` mapped into the prior box."""
    box = r.config().parameterization_spec()
    lo, hi = np.asarray(box["min"], float), np.asarray(box["max"], float)
    return {**draws, "x0": lo + (hi - lo) * draws["x0"]}


def _point_file(r, i):
    return hdf5.read_dict_from_h5(r.config(closure_index=i).mcmc_output_dir, "mcmc.h5", verbose=False)


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_dispatch_chunk_gives_the_one_chunk_chains(closure_fixture, mode):
    """Under the same injected draws the batch run in chunks of 15 steps
    (15 + 15 + 10) gives the one-chunk run's chains, log-probs and acceptance
    bit for bit, and the same diagnostics; from generators, dispatch_chunk=15
    gives the chains of checkpoint_every=15 (the same chunk lengths). The
    mcmc.h5 files streamed slab by slab hold what the one-chunk run's hold
    and what write_dict_to_h5 writes whole."""
    r = closure_fixture
    draws = _scaled_start(r, _batch_draws(len(INDICES)))
    kw = dict(seed=0, device="cpu", mode=mode)
    whole = trunner.run_closure_batch(r.config(), INDICES, draws=draws, **kw)
    whole_files = {i: _point_file(r, i) for i in INDICES}
    slabs = trunner.run_closure_batch(r.config(), INDICES, draws=draws, dispatch_chunk=15, **kw)
    for i in INDICES:
        for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat"):
            np.testing.assert_array_equal(slabs[i][key], whole[i][key], err_msg=f"{i}/{key}")
        assert (slabs[i]["autocorrelation_time"] is None) == (whole[i]["autocorrelation_time"] is None)
        streamed = _point_file(r, i)
        assert sorted(streamed) == sorted(whole_files[i])
        for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat", "design_point"):
            np.testing.assert_array_equal(streamed[key], whole_files[i][key], err_msg=f"{i}/{key}")
        np.testing.assert_array_equal(streamed["chain"], slabs[i]["chain"])
        np.testing.assert_array_equal(slabs[i]["final_coords"], whole[i]["final_coords"])
        assert "final_coords" not in streamed and slabs[i]["final_log_prob"].shape == (N_WALKERS,)
        rewritten = {k: v for k, v in slabs[i].items() if k not in ("timings", "final_coords", "final_log_prob")}
        hdf5.write_dict_to_h5(rewritten, r.config(closure_index=i).mcmc_output_dir, "whole.h5", verbose=False)
        at_once = hdf5.read_dict_from_h5(r.config(closure_index=i).mcmc_output_dir, "whole.h5", verbose=False)
        assert sorted(at_once) == sorted(streamed)
        np.testing.assert_array_equal(at_once["chain"], streamed["chain"])
        np.testing.assert_array_equal(at_once["log_prob"], streamed["log_prob"])
    by_cadence = trunner.run_closure_batch(r.config(), INDICES, checkpoint_every=15, write=False, **kw)
    by_chunk = trunner.run_closure_batch(r.config(), INDICES, dispatch_chunk=15, write=False, **kw)
    for i in INDICES:
        np.testing.assert_array_equal(by_chunk[i]["chain"], by_cadence[i]["chain"])


def test_closure_dispatch_chunk_rule(monkeypatch):
    """The chunk length: the argument, else the checkpoint cadence, else the
    longest chunk whose (chain, log-prob) slab stays under the slab bound
    (the JAX package's rule), else one chunk."""
    rule = trunner._closure_dispatch_chunk
    assert rule(50_000, 30, 100, 6, 4, 700, 500) == 700
    assert rule(50_000, 30, 100, 6, 4, None, 500) == 500
    assert rule(50_000, 30, 100, 6, 4, None, None) == (256 << 20) // (30 * 100 * 7 * 4) == 3195
    assert rule(2_000, 30, 100, 6, 4, None, None) is None
    assert rule(400, 2, 12, 6, 8, 400, None) is None
    monkeypatch.setattr(trunner, "CLOSURE_SLAB_BYTES", 2 * 12 * 7 * 8 * 10)
    assert rule(40, 2, 12, 6, 8, None, None) == 10


def test_prewarmed_closure_handle_is_sized_for_the_dispatch_chunks(closure_fixture):
    """prewarm_sampler_programs(n_points=, dispatch_chunk=) sizes the handle's
    buffers for the chunks the batch dispatches (the longer of the first
    burn-in phase and a production chunk), not for the whole production; the
    handle serves the run and gives the chains of the run that builds its
    programs inline."""
    from bayesian_inference_tpu_torch.mcmc.programs import prewarm_sampler_programs

    r = closure_fixture
    assert prewarm_sampler_programs(r.config(), device="cpu", n_points=2).capacity == N_STEPS
    programs = prewarm_sampler_programs(r.config(), device="cpu", n_points=2, dispatch_chunk=10)
    assert programs.capacity == 10 and programs._rands["perm"].shape[0] == 10
    kw = dict(seed=1, device="cpu", write=False, dispatch_chunk=10)
    cold = trunner.run_closure_batch(r.config(), INDICES, **kw)
    warm = trunner.run_closure_batch(r.config(), INDICES, programs=programs, **kw)
    for i in INDICES:
        np.testing.assert_array_equal(warm[i]["chain"], cold[i]["chain"])


def test_return_chains_false_streams_and_returns_no_chain(closure_fixture, monkeypatch):
    """return_chains=False with write: the outputs hold no chain, the files
    hold the chain of the run that returns it; the host statistics read the
    files back one point at a time (the host budget set to one point) and
    equal the all-at-once ones; appended slabs are dropped as they go: no
    more than one slab is alive between appends."""
    r = closure_fixture
    kw = dict(seed=3, device="cpu", dispatch_chunk=10)
    full = trunner.run_closure_batch(r.config(), INDICES, write=False, **kw)
    appended = []
    inner = hdf5.append_time_series
    monkeypatch.setattr(hdf5, "append_time_series",
                        lambda d, f, slabs, **k: appended.append(slabs["chain"].shape[0]) or inner(d, f, slabs, **k))
    monkeypatch.setattr(trunner, "CLOSURE_STATS_HOST_BYTES", 1)
    lean = trunner.run_closure_batch(r.config(), INDICES, return_chains=False, **kw)
    assert appended == [10] * (len(INDICES) * N_STEPS // 10)
    for i in INDICES:
        assert "chain" not in lean[i] and "log_prob" not in lean[i]
        stored = _point_file(r, i)
        np.testing.assert_array_equal(stored["chain"], full[i]["chain"])
        np.testing.assert_array_equal(stored["log_prob"], full[i]["log_prob"])
        np.testing.assert_array_equal(lean[i]["split_rhat"], full[i]["split_rhat"])
        np.testing.assert_array_equal(stored["split_rhat"], full[i]["split_rhat"])
        np.testing.assert_array_equal(lean[i]["acceptance_fraction"], full[i]["acceptance_fraction"])


@pytest.mark.parametrize("file_is", ["longer", "shorter"])
def test_streamed_resume_trims_a_longer_file_and_refuses_a_shorter(closure_fixture, monkeypatch, file_is):
    """A written batch cut during its third chunk leaves a checkpoint without
    chains and files of two slabs. With a third slab appended after the last
    record (a crash between append and record) the resumed run trims the
    files and equals the uninterrupted run; with a file cut short it refuses
    to resume."""
    import os

    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms

    r = closure_fixture
    kw = dict(seed=5, device="cpu", checkpoint_every=10)
    whole = trunner.run_closure_batch(r.config(), INDICES, **kw)
    path = trunner._closure_checkpoint_path(r.config())
    assert not os.path.exists(path)

    inner, calls = SamplerPrograms.chunk, []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) > 2 + 2:
            raise KeyboardInterrupt("interrupted")
        return inner(*args, **kwargs)

    monkeypatch.setattr(SamplerPrograms, "chunk", interrupted)
    with pytest.raises(KeyboardInterrupt):
        trunner.run_closure_batch(r.config(), INDICES, **kw)
    monkeypatch.undo()
    import pickle

    with open(path, "rb") as f:
        header, record = pickle.load(f), pickle.load(f)
    assert header["n_pad"] == 0 and "chain" not in record and record["steps_done"] == 10
    out_dir = r.config(closure_index=INDICES[0]).mcmc_output_dir
    assert hdf5.time_series_length(out_dir, "mcmc.h5", "chain") == 20
    if file_is == "longer":
        junk = {"chain": np.full((10, N_WALKERS, 6), 7.0), "log_prob": np.full((10, N_WALKERS), 7.0)}
        hdf5.append_time_series(out_dir, "mcmc.h5", junk)
        resumed = trunner.run_closure_batch(r.config(), INDICES, **kw)
        assert not os.path.exists(path)
        for i in INDICES:
            for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat"):
                np.testing.assert_array_equal(resumed[i][key], whole[i][key], err_msg=f"{i}/{key}")
            np.testing.assert_array_equal(_point_file(r, i)["chain"], whole[i]["chain"])
    else:
        empty = {"chain": np.empty((0, N_WALKERS, 6)), "log_prob": np.empty((0, N_WALKERS))}
        hdf5.append_time_series(out_dir, "mcmc.h5", empty, truncate_to=12)
        with pytest.raises(RuntimeError, match="has only 12 steps"):
            trunner.run_closure_batch(r.config(), INDICES, **kw)
        os.remove(path)


def test_device_statistics_take_the_list_of_slabs():
    """device_mean_power, device_split_rhat and device_closure_stats over the
    list of a chain's time-axis slabs (CPU tensors, uneven cuts, one of them
    a host array) equal the whole chain's bit for bit, and the JAX package's
    on the same list (spectra rtol 1e-10, R-hat 1e-10)."""
    import jax.numpy as jnp
    import torch

    from bayesian_inference_tpu.mcmc import stats as jstats
    from bayesian_inference_tpu_torch.mcmc import stats as tstats

    rng = np.random.default_rng(12)
    chain = np.cumsum(rng.normal(size=(301, 3, 8, 2)), axis=0) * 0.05 + rng.normal(size=(301, 3, 8, 2))
    cuts = [(0, 100), (100, 137), (137, 301)]
    one = [torch.tensor(chain[a:b, 1]) for a, b in cuts]
    one[1] = chain[100:137, 1]
    power, nfft = tstats.device_mean_power(one)
    whole_power, whole_nfft = tstats.device_mean_power(torch.tensor(chain[:, 1]))
    assert nfft == whole_nfft == 1024
    np.testing.assert_array_equal(power, whole_power)
    np.testing.assert_array_equal(tstats.device_split_rhat(one), tstats.device_split_rhat(torch.tensor(chain[:, 1])))
    jpower, jnfft = jstats.device_mean_power([jnp.asarray(chain[a:b, 1]) for a, b in cuts])
    assert jnfft == nfft
    np.testing.assert_allclose(power, np.asarray(jpower), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(tstats.device_split_rhat(one),
                               jstats.device_split_rhat([jnp.asarray(chain[a:b, 1]) for a, b in cuts]), rtol=1e-10)

    batch = [torch.tensor(chain[a:b]) for a, b in cuts]
    powers, nfft_b, rhats = tstats.device_closure_stats(batch)
    whole = tstats.device_closure_stats(torch.tensor(chain))
    np.testing.assert_array_equal(powers, whole[0])
    np.testing.assert_array_equal(rhats, whole[2])
    jpowers, _, jrhats = jstats.device_closure_stats([jnp.asarray(chain[a:b]) for a, b in cuts])
    np.testing.assert_allclose(powers, jpowers, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(rhats, jrhats, rtol=1e-10)
    np.testing.assert_array_equal(powers[1], power)
