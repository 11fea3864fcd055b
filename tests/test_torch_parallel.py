"""The port's device mesh (parallel/mesh.py), counterpart of
tests/test_parallel.py, on a mesh of eight ``"cpu"`` entries (what the JAX
tests' virtual 8-device CPU mesh is to them): the split, the replicas and the
gather; the walker-sharded sampler, the instance-sharded GP fit, run_mcmc
with a mesh and a prewarmed mesh handle, and the point-sharded, padded
closure batch, each against the unsharded run and, where the two packages
can be fed the same numbers, against the JAX package under its own mesh."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fit import _specs, fixture_pcs  # noqa: F401  (fixture reuse)
from test_torch_mcmc import fixture_run  # noqa: F401  (fixture reuse)
from torch_parity import t64, to_np

from bayesian_inference_tpu.mcmc import stretch as jstretch
from bayesian_inference_tpu.models import gp_fit as jfit
from bayesian_inference_tpu.parallel import mesh as jmesh
from bayesian_inference_tpu_torch.mcmc import programs as tprograms
from bayesian_inference_tpu_torch.mcmc import runner as trunner
from bayesian_inference_tpu_torch.mcmc import stretch as tstretch
from bayesian_inference_tpu_torch.models import gp_fit as tfit
from bayesian_inference_tpu_torch.parallel import mesh as tmesh


def _mesh(n=8):
    return tmesh.get_mesh(devices=["cpu"] * n)


def test_mesh_names_its_devices_and_compares():
    """get_mesh(devices=...) keeps the devices in order; n_devices takes the
    first few; meshes are hashable and equal when they name the same devices
    under the same axis name; with no devices named it takes every CUDA card
    and raises where there is none."""
    mesh = _mesh()
    assert mesh.size == 8 == jmesh.get_mesh().devices.size and mesh.distinct == 1 and mesh.axis_name == "data"
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh == _mesh() and hash(mesh) == hash(_mesh()) and len({mesh, _mesh(), _mesh(4)}) == 2
    assert mesh != tmesh.get_mesh(devices=["cpu"] * 8, axis_name="walkers")
    assert tmesh.get_mesh(3, devices=["cpu"] * 8) == _mesh(3)
    with pytest.raises(ValueError, match="n_devices 9"):
        tmesh.get_mesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.get_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.get_mesh(devices=["cuda:0"] * 4)


def test_shard_leading_axis_none_mesh_is_noop():
    x = torch.ones((4, 3))
    assert tmesh.shard_leading_axis(x, None) is x
    tree = {"a": x}
    assert tmesh.replicate(tree, None) is tree

    def log_prob(theta):
        return theta.sum(-1)

    assert tmesh.make_sharded_log_prob(log_prob, None) is log_prob


def test_uneven_shards_replicas_and_gather():
    """50 walkers over 8 devices: shards of 7, 7, 6, ..., in order; more
    devices than rows leaves empty shards, which the sharded log-probability
    skips; replicate gives one copy per device, the first sharing the
    tensors, the others their own; the gathered log-probabilities equal the
    unsharded call."""
    mesh = _mesh()
    x = torch.arange(50 * 3, dtype=torch.float64).reshape(50, 3)
    shards = tmesh.shard_leading_axis(x, mesh)
    assert [s.shape[0] for s in shards] == [7, 7, 6, 6, 6, 6, 6, 6] == tmesh.shard_sizes(50, mesh)
    assert torch.equal(torch.cat(shards), x)
    assert [s.shape[0] for s in tmesh.shard_leading_axis(x[:5], mesh)] == [1, 1, 1, 1, 1, 0, 0, 0]

    @dataclasses.dataclass
    class Shifted:
        shift: torch.Tensor
        pair: tuple

        def log_posterior(self, theta):
            return -0.5 * ((theta - self.shift) ** 2).sum(-1) + self.pair[0]

    like = Shifted(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), (torch.tensor(0.5, dtype=torch.float64), "kept"))
    copies = tmesh.replicate(like, mesh)
    assert len(copies) == 8 and copies[0].shift is like.shift and copies[3].pair[1] == "kept"
    assert copies[1].shift is not like.shift and torch.equal(copies[1].shift, like.shift)
    for fn in (tmesh.make_sharded_log_prob(like, mesh), tmesh.make_sharded_log_prob(copies, mesh),
               tmesh.make_sharded_log_prob([c.log_posterior for c in copies], mesh)):
        assert torch.equal(fn(x), like.log_posterior(x))
        assert torch.equal(fn(x[:5]), like.log_posterior(x[:5]))
    with pytest.raises(ValueError, match="3 log-probabilities for 8"):
        tmesh.make_sharded_log_prob(copies[:3], mesh)
    assert torch.equal(tmesh.make_sharded_log_prob(like, mesh, axis_name="data")(x), like.log_posterior(x))
    with pytest.raises(ValueError, match="the mesh's axis is 'data'"):
        tmesh.shard_leading_axis(x, mesh, axis_name="model")


def test_walker_sharded_mcmc_matches_unsharded():
    """run_ensemble with the walker batch sharded over the 8-entry mesh
    against the unsharded run (rtol 1e-12, as the JAX package's test), and,
    under the JAX sampler's injected draws, against the JAX package's run
    sharded over its own 8-device mesh (rtol 1e-10)."""
    def log_prob(x):
        return -0.5 * (x**2).sum(-1)

    mesh = _mesh()
    sharded_lp = tmesh.make_sharded_log_prob(log_prob, mesh)
    x0 = np.random.default_rng(0).normal(size=(32, 3))
    plain = tstretch.run_ensemble(log_prob, t64(x0), 50, generator=torch.Generator().manual_seed(1))
    shard = tstretch.run_ensemble(sharded_lp, t64(x0), 50, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(to_np(shard["chain"]), to_np(plain["chain"]), rtol=1e-12)
    np.testing.assert_allclose(to_np(shard["acceptance_fraction"]), to_np(plain["acceptance_fraction"]))

    key = jax.random.key(1)
    jlp = jmesh.make_sharded_log_prob(lambda x: -0.5 * jnp.sum(x**2, axis=-1), jmesh.get_mesh())
    ref = jstretch.run_ensemble(key, jlp, jnp.asarray(x0), 50)
    rands = {k: torch.tensor(np.asarray(v)) for k, v in jstretch._pregen_rands(key, 50, 32, jnp.float64, True)[0].items()}
    ours = tstretch.run_ensemble(sharded_lp, t64(x0), 50, rands=rands)
    np.testing.assert_allclose(to_np(ours["chain"]), np.asarray(ref["chain"]), rtol=1e-10)
    np.testing.assert_allclose(to_np(ours["acceptance_fraction"]), np.asarray(ref["acceptance_fraction"]), rtol=1e-12)


@pytest.mark.parametrize("eager", [False, True], ids=["programs", "eager"])
def test_sharded_gp_fit_matches_unsharded(eager):
    """fit_gps with the (PC, restart) instances split over the mesh (2 PCs x
    8 starts = 16 instances over 8 devices, then 6 survivors unevenly)
    against the unsharded fit: LML rtol 1e-10, length scales rtol 1e-8 (the
    JAX package's tolerances); a one-device mesh is the unsharded fit bit for
    bit; a mesh that does not start where X lies raises."""
    from bayesian_inference_tpu_torch.ops.gram import KernelConfig

    rng = np.random.default_rng(0)
    N, d, k = 24, 3, 2
    X, Y = t64(rng.uniform(0, 1, (N, d))), t64(rng.normal(size=(N, k)))
    spec = tfit.spec_from_reference_config(KernelConfig(nu=1.5, with_noise=True), np.zeros(d), np.ones(d),
                                           n_restarts=7, n_iters=10, alpha_jitter=1e-8)
    spec = dataclasses.replace(spec, halving_iters=4, halving_keep=3)
    rand_logs = t64(rng.uniform(spec.log_lo, spec.log_hi, (k, 7, spec.theta0.shape[0])))
    single = tfit.fit_gps(spec, X, Y, rand_logs=rand_logs, eager=eager)
    meshed = tfit.fit_gps(spec, X, Y, rand_logs=rand_logs, eager=eager, mesh=_mesh())
    np.testing.assert_allclose(to_np(meshed.lml), to_np(single.lml), rtol=1e-10)
    np.testing.assert_allclose(to_np(meshed.params.log_length_scale), to_np(single.params.log_length_scale), rtol=1e-8)
    one = tfit.fit_gps(spec, X, Y, rand_logs=rand_logs, eager=eager, mesh=_mesh(1))
    assert torch.equal(one.lml, single.lml) and torch.equal(one.Kinv, single.Kinv)
    with pytest.raises(ValueError, match="the mesh starts on"):
        tfit.fit_gps(spec, X.to("meta"), Y, rand_logs=rand_logs, mesh=_mesh())


def test_sharded_gp_fit_matches_the_jax_mesh_fit(fixture_pcs, monkeypatch):  # noqa: F811
    """The mesh fit against the JAX package's fit under its 8-device mesh,
    from the same restart points: each PC's final LML within 0.1 nat, the bar
    of the unsharded fit parity tests."""
    X, Z = fixture_pcs
    monkeypatch.setenv("BIQ_FIT_LML", "matmul")
    jspec, tspec = _specs(X)
    key = jax.random.key(0)
    jpost = jfit.fit_gps(jspec, jnp.asarray(X), jnp.asarray(Z), key, mesh=jmesh.get_mesh())
    rand_logs = jax.random.uniform(key, (Z.shape[1], jspec.n_restarts, jspec.theta0.shape[0]),
                                   dtype=jspec.theta0.dtype, minval=jspec.log_lo, maxval=jspec.log_hi)
    tpost = tfit.fit_gps(tspec, t64(X), t64(Z), rand_logs=t64(rand_logs), mesh=_mesh())
    np.testing.assert_allclose(to_np(tpost.lml), np.asarray(jpost.lml), rtol=0, atol=0.1)


def _run_kw(r, **kw):
    return dict(device="cpu", emulation_results=r.artifacts, observables=r.observables, write=False, **kw)


@pytest.mark.parametrize("mode,n_devices", [("block", 4), ("lowrank", 8)])
def test_run_mcmc_with_mesh(fixture_run, caplog, mode, n_devices):  # noqa: F811
    """run_mcmc with the walker batch sharded over the mesh (16 walkers over
    8 entries: shards of one walker per half-step) against mesh=None: chain
    rtol 1e-10 (the JAX package's tolerance); a one-device mesh equals
    mesh=None bit for bit; a handle prewarmed for the mesh reproduces the
    inline-built mesh run exactly, and one prewarmed without it is dropped
    with the warning."""
    r = fixture_run
    mesh = _mesh(n_devices)
    kw = _run_kw(r, seed=0, mode=mode)
    single = trunner.run_mcmc(r.tmcmc, **kw)
    meshed = trunner.run_mcmc(r.tmcmc, mesh=mesh, **kw)
    np.testing.assert_allclose(meshed["chain"], single["chain"], rtol=1e-10)
    np.testing.assert_allclose(meshed["acceptance_fraction"], single["acceptance_fraction"])
    assert meshed["programs_captured"] is False and single["programs_captured"] is False  # the CPU captures nothing
    one = trunner.run_mcmc(r.tmcmc, mesh=_mesh(1), **kw)
    np.testing.assert_array_equal(one["chain"], single["chain"])
    np.testing.assert_array_equal(one["log_prob"], single["log_prob"])

    programs = tprograms.prewarm_sampler_programs(r.tmcmc, mode=mode, device="cpu", observables=r.observables, mesh=mesh)
    assert programs.mesh == mesh and len(programs._replicas) == n_devices
    warm = trunner.run_mcmc(r.tmcmc, mesh=mesh, programs=programs, **kw)
    np.testing.assert_array_equal(warm["chain"], meshed["chain"])
    with caplog.at_level("WARNING", logger=trunner.__name__):
        dropped = trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
    assert caplog.text.count("prewarmed sampler programs do not match") == 1
    np.testing.assert_array_equal(dropped["chain"], single["chain"])
    with pytest.raises(ValueError, match="not the first device of the mesh"):
        trunner.run_mcmc(r.tmcmc, mesh=tmesh.Mesh((torch.device("meta"),)), **kw)


@pytest.mark.parametrize("mode,n_devices", [("block", 2), ("lowrank", 8)])
def test_batched_closure_sharded_over_mesh(fixture_run, mode, n_devices):  # noqa: F811
    """The closure batch of 3 points over the mesh: padded to 8 over 8
    entries (to 4 over 2) with copies of the last point, one program per
    device for its share, the pad points' outputs absent; chains against the unsharded batch (rtol
    1e-10, as the JAX package's test) and the same acceptance; with a
    prewarmed point-sharded handle the same chains bit for bit; a point count
    the mesh does not divide is refused by the programs."""
    r = fixture_run
    mesh = _mesh(n_devices)
    kw = _run_kw(r, seed=0, mode=mode)
    plain = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], **kw)
    sharded = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], mesh=mesh, **kw)
    assert sorted(sharded) == [0, 1, 2]
    for i in (0, 1, 2):
        assert sharded[i]["chain"].shape == plain[i]["chain"].shape
        np.testing.assert_allclose(sharded[i]["chain"], plain[i]["chain"], rtol=1e-10)
        np.testing.assert_allclose(sharded[i]["acceptance_fraction"], plain[i]["acceptance_fraction"])
        np.testing.assert_allclose(sharded[i]["split_rhat"], plain[i]["split_rhat"], rtol=1e-8)
    programs = tprograms.prewarm_sampler_programs(r.tmcmc, mode=mode, device="cpu", observables=r.observables,
                                                  n_points=3, mesh=mesh)
    padded = {2: 4, 8: 8}[n_devices]
    assert programs.n_points == padded and len(programs._parts) == n_devices
    assert programs._parts[0].n_points == padded // n_devices
    warm = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], mesh=mesh, programs=programs, **kw)
    for i in (0, 1, 2):
        np.testing.assert_array_equal(warm[i]["chain"], sharded[i]["chain"])
    with pytest.raises(ValueError, match="do not split evenly"):
        tprograms.SamplerPrograms(r.tlike[mode], r.tmcmc.n_walkers, r.lo.size, [10], n_points=3, mesh=mesh)


def test_closure_checkpoint_of_another_padding_is_not_resumed(fixture_run, monkeypatch, caplog):  # noqa: F811
    """n_pad is pinned in the closure checkpoint's header and every record
    holds the padded batch's state: a checkpoint left by a mesh run (3 points
    padded to 4) is not resumed by a run without the mesh, which warns,
    starts fresh and equals a run that found no checkpoint; the mesh run
    itself resumes from it bit for bit."""
    r = fixture_run
    mesh = _mesh(4)
    kw = _run_kw(r, seed=2, mode="lowrank", checkpoint_every=40)
    path = trunner._closure_checkpoint_path(r.tmcmc)
    whole = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], mesh=mesh, **kw)
    plain = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], **kw)
    assert not os.path.exists(path)

    inner, calls = tprograms.SamplerPrograms._chunk_parts, []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) > 2 + 1:
            raise KeyboardInterrupt("interrupted")
        return inner(*args, **kwargs)

    monkeypatch.setattr(tprograms.SamplerPrograms, "_chunk_parts", interrupted)
    with pytest.raises(KeyboardInterrupt):
        trunner.run_closure_batch(r.tmcmc, [0, 1, 2], mesh=mesh, **kw)
    monkeypatch.undo()
    with open(path, "rb") as f:
        header, record = pickle.load(f), pickle.load(f)
    assert header["n_pad"] == 1 and header["indices"] == [0, 1, 2]
    assert record["coords"].shape[0] == 4 and len(record["generator_states"]) == 4
    with open(path, "rb") as f:
        saved = f.read()

    with caplog.at_level("WARNING", logger=trunner.__name__):
        fresh = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], **kw)
    assert "n_pad: 1 != 0" in caplog.text and "restarting fresh" in caplog.text
    for i in (0, 1, 2):
        np.testing.assert_array_equal(fresh[i]["chain"], plain[i]["chain"])

    with open(path, "wb") as f:
        f.write(saved)
    resumed = trunner.run_closure_batch(r.tmcmc, [0, 1, 2], mesh=mesh, **kw)
    assert not os.path.exists(path)
    for i in (0, 1, 2):
        np.testing.assert_array_equal(resumed[i]["chain"], whole[i]["chain"])
        np.testing.assert_array_equal(resumed[i]["log_prob"], whole[i]["log_prob"])
