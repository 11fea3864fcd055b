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
