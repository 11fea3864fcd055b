"""Posterior parity of the port, counterparts of tests/test_posterior_parity.py:
the port's sampler with its own ``torch.Generator`` draws against the
independent numpy stretch move (tests/reference_stretch.py) on an analytic
banana target and on the fixture's emulated posterior, and against the JAX
package's ``run_mcmc`` on the same JAX-fitted artifacts; the parts of
``scripts/parity_check_torch.py`` (its carried numpy sampler, its report and
gates, a gate that fails on a shifted target); both packages' production
tables; and that the card's parity path (the script, ``chip_smoke.py``)
imports no JAX."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from reference_stretch import run_stretch_numpy
from test_posterior_parity import _ks_marginals
from test_torch_mcmc import fixture_run  # noqa: F401  (fixture reuse)

from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5
from bayesian_inference_tpu.io.synthetic import make_production_tables as jax_production_tables
from bayesian_inference_tpu.mcmc import runner as jrunner
from bayesian_inference_tpu.pipeline import configs as jconfigs
from bayesian_inference_tpu_torch.io.synthetic import make_production_tables as torch_production_tables
from bayesian_inference_tpu_torch.mcmc import stretch as tstretch
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

REPO = Path(__file__).resolve().parents[1]


def _load_script():
    spec = importlib.util.spec_from_file_location("parity_check_torch", REPO / "scripts" / "parity_check_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


parity = _load_script()


def test_parity_on_banana_target():
    """A correlated non-Gaussian (mild banana) target, the bars of the JAX
    package's banana test: acceptance within 0.05, means within 0.15, stds
    within 10 %, KS p > 1e-3 on every step-thinned marginal. The port runs
    in float64 from its own generator."""

    def log_prob(x):
        a, b = x[:, 0], x[:, 1]
        return -0.5 * (a**2 / 4.0 + (b - 0.25 * a**2) ** 2)

    W, n_steps, burn = 64, 8000, 2000
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(W, 2)) * 0.5
    chain_np, _, acc_np = run_stretch_numpy(rng, log_prob, x0, n_steps)
    out = tstretch.run_ensemble(log_prob, torch.as_tensor(x0), n_steps, generator=torch.Generator().manual_seed(1))
    chain = out["chain"].numpy()
    acc = out["acceptance_fraction"].numpy()

    assert abs(acc_np.mean() - acc.mean()) < 0.05, (acc_np.mean(), acc.mean())
    s1 = chain_np[burn:].reshape(-1, 2)
    s2 = chain[burn:].reshape(-1, 2)
    np.testing.assert_allclose(s1.mean(axis=0), s2.mean(axis=0), atol=0.15)
    np.testing.assert_allclose(s1.std(axis=0), s2.std(axis=0), rtol=0.1)
    for p in _ks_marginals(chain_np[burn:], chain[burn:]):
        assert p > 1e-3, p


def _inputs(r):
    """The script's inputs over the fixture analysis of ``fixture_run``."""
    config = tconfigs.load_yaml(r.path)
    name = next(iter(config["analyses"]))
    return {"config": config, "analysis_name": name, "parameterization": "exponential", "emu": r.temu,
            "observables": r.observables}


def _emulated_gates(report):
    """The bars of the JAX package's emulated-posterior test: acceptance
    within 0.06, every quantile within 0.08 of the prior width, KS p > 1e-3
    on at least 5 of the 6 tau-thinned marginals."""
    passed, reasons = parity.parity_gates(report, max_acceptance_diff=0.06, max_quantile_diff=0.08,
                                          min_ks_pvalue=0.0)
    pvals = [p["ks_pvalue"] for p in report["per_parameter"]]
    assert passed, reasons
    assert sum(p > 1e-3 for p in pvals) >= 5, (pvals, report["tau_max"])


@pytest.mark.slow
def test_parity_on_emulated_posterior(fixture_run):
    """The port's run_mcmc on the CPU (float64, its own generator) on the
    fixture's emulated posterior (JAX-fitted artifacts), against the numpy
    stretch move on the port's float64 likelihood without the kernels, and
    against the JAX package's run_mcmc with another seed. The numpy sampler
    runs a shorter chain than the two ensembles, as in the JAX test. tau is
    ~160-240 steps on this broad posterior, and run_mcmc's second burn-in
    phase starts from the best positions of the first, so every run burns
    in for ~8 tau: 4-5 minutes of CPU, marked slow as its JAX counterpart
    is."""
    r = fixture_run
    inputs = _inputs(r)
    W, burn, steps = 32, 4000, 4400
    ours, _ = parity.sample_ours(inputs, r.artifacts, "block", "cpu", seed=3, n_walkers=W, n_burn=burn,
                                 n_steps=steps)
    like = parity.reference_likelihoods(inputs, r.artifacts, "block", ["cpu"])["cpu"]
    chain_np, acc_np, _ = parity.sample_reference(parity.numpy_log_prob(like), r.lo, r.hi, W, 2000, 3000, seed=2)

    config = jconfigs.load_yaml(r.path)
    analysis = config["analyses"][inputs["analysis_name"]]
    analysis["parameters"]["mcmc"].update(n_walkers=W, n_burn_steps=burn, n_sampling_steps=steps)
    jmcmc = jconfigs.MCMCConfig(analysis_name=inputs["analysis_name"], parameterization="exponential",
                                analysis_config=analysis, config_file=str(r.path))
    jrunner.run_mcmc(jmcmc, seed=4)
    jout = read_dict_from_h5(jmcmc.mcmc_output_dir, "mcmc.h5", verbose=False)

    for chain_ref, acc_ref, name in ((chain_np, acc_np, "numpy_ref"),
                                     (jout["chain"], jout["acceptance_fraction"], "jax")):
        report = parity.parity_report(ours["chain"], ours["acceptance_fraction"], chain_ref, acc_ref, r.lo, r.hi,
                                      reference=name)
        _emulated_gates(report)


def test_carried_numpy_sampler_is_the_reference():
    """The script's carried stretch move draws and moves exactly as
    tests/reference_stretch.py's for the same numpy generator."""

    def log_prob(x):
        return -0.5 * np.sum(x**2 * np.arange(1, x.shape[1] + 1), axis=1)

    x0 = np.random.default_rng(0).normal(size=(20, 3))
    ours = parity.run_stretch_numpy(np.random.default_rng(5), log_prob, x0, 60)
    ref = run_stretch_numpy(np.random.default_rng(5), log_prob, x0, 60)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_report_and_gates_on_a_short_run(fixture_run):
    """run_parity on the CPU at a short length: the report has the JAX
    script's keys per parameter, the reference's likelihood (library
    Cholesky) equals the kernels' plain version to float64 rounding, and the
    gates give a verdict with a reason for each failure."""
    r = fixture_run
    report = parity.run_parity(_inputs(r), r.artifacts, mode="block", device="cpu", seed=1, n_walkers=16,
                               n_burn=20, n_steps=60, ref_burn=20, ref_steps=40)
    assert report["steps"] == 60 and report["ref_steps"] == 40 and report["ref_device"] == "cpu"
    assert report["dtype"] == "float64" and report["reference"] == "numpy_ref"
    assert 0 < report["acceptance_ours"] < 1 and 0 < report["acceptance_numpy_ref"] < 1
    assert report["ref_vs_unrolled_rel"] < 1e-12
    assert [p["dim"] for p in report["per_parameter"]] == list(range(6))
    for p in report["per_parameter"]:
        assert set(p) >= {"ks_stat", "ks_pvalue", "n_eff", "median_diff_over_prior_width",
                          "q16_diff_over_prior_width", "q84_diff_over_prior_width"}
        assert p["n_eff"] == 16 * len(range(0, 60, report["thin"]))
    passed, reasons = parity.parity_gates(report)
    assert passed == (not reasons)
    strict, strict_reasons = parity.parity_gates(report, max_quantile_diff=0.0)
    assert not strict and len(strict_reasons) >= 6


def test_gate_fails_on_a_shifted_target():
    """Two numpy runs on one Gaussian target pass the gates; the same runs
    with one target's mean moved by 0.2 of the prior width fail them, on the
    quantile and the KS gates of that parameter only."""
    lo, hi = np.zeros(3), np.full(3, 10.0)
    centre = np.array([5.0, 4.0, 6.0])

    def target(shift):
        return lambda x: -0.5 * np.sum(((x - centre - shift) / 0.6) ** 2, axis=1)

    runs = [parity.sample_reference(target(np.zeros(3)), lo, hi, 32, 300, 2000, seed) for seed in (0, 1)]
    shifted = parity.sample_reference(target(np.array([2.0, 0.0, 0.0])), lo, hi, 32, 300, 2000, 1)
    (c1, a1, _), (c2, a2, _) = runs
    same = parity.parity_report(c1, a1, c2, a2, lo, hi)
    assert parity.parity_gates(same) == (True, [])
    moved = parity.parity_report(c1, a1, shifted[0], shifted[1], lo, hi)
    passed, reasons = parity.parity_gates(moved)
    assert not passed
    assert all(reason.startswith("dim 0:") for reason in reasons), reasons
    assert any("KS" in reason for reason in reasons) and any("median" in reason for reason in reasons)


def test_production_tables_are_the_jax_packages(tmp_path):
    """Both packages' make_production_tables write the same files, byte for byte."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert jax_production_tables(jdir) == torch_production_tables(tdir)
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    assert len(files) > 400
    for f in files:
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f


def test_card_parity_path_never_imports_jax():
    """scripts/parity_check_torch.py and chip_smoke.py, with the port's
    modules the parity run calls, pull in no JAX and no module of the JAX
    package: the card's machine has none."""
    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "spec = importlib.util.spec_from_file_location('parity_check_torch', "
        f"{str(REPO / 'scripts' / 'parity_check_torch.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "import chip_smoke\n"
        "p = chip_smoke.parity_module()\n"
        "import scipy.stats\n"
        "import bayesian_inference_tpu_torch.mcmc.runner, bayesian_inference_tpu_torch.mcmc.likelihood\n"
        "import bayesian_inference_tpu_torch.io.synthetic, bayesian_inference_tpu_torch.io.tables\n"
        "assert callable(m.run_parity) and callable(p.parity_gates)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'bayesian_inference_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_reference_likelihood_is_the_ports(fixture_run, mode):
    """The reference's float64 likelihood without the kernels (library
    Cholesky), also with its width buckets merged into one, equals the
    port's log_posterior on the CPU (rtol 1e-10) inside and outside the
    prior box, and with the kernels' plain terms bit for bit."""
    from bayesian_inference_tpu_torch.ops.tiny_mvn import mvn_terms_plain

    r = fixture_run
    like = r.tlike[mode]
    rng = np.random.default_rng(3)
    theta = torch.as_tensor(r.lo + (r.hi - r.lo) * rng.uniform(-0.1, 1.1, (40, r.lo.size)))
    ref = like.log_posterior(theta)
    outside = torch.isneginf(ref)
    assert 0 < int(outside.sum()) < 40
    for reference in (like, parity.one_bucket(like)):
        ours = parity.reference_log_posterior(reference, theta)
        assert torch.equal(torch.isneginf(ours), outside)
        torch.testing.assert_close(ours[~outside], ref[~outside], rtol=1e-10, atol=0)
    assert len(parity.one_bucket(like).U) == (1 if mode == "block" else len(like.U))
    assert torch.equal(parity.reference_log_posterior(like, theta, terms=mvn_terms_plain), ref)
