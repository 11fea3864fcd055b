"""The port's sampler programs (mcmc/programs.py), counterparts of
tests/test_programs.py: the placeholder likelihood's shapes, the program's
chunk against the eager loop bit for bit (on the CPU the program runs the
same step code on its own static buffers, fed through the operand-style
copy), prewarmed runs against unwarmed ones, also across a checkpoint resume,
the runner's handling of a handle that does not fit, the replay-aware launch
counts, the analytic FLOP counts, and run_mcmc through a prewarmed program
against the JAX package's run_mcmc under injected draws."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from test_torch_mcmc import _jax_run_mcmc_draws, fixture_run  # noqa: F401  (fixture reuse)

from bayesian_inference_tpu.mcmc import programs as jprograms
from bayesian_inference_tpu.mcmc import runner as jrunner
from bayesian_inference_tpu.utils import flops as jflops
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.mcmc import likelihood as tlik
from bayesian_inference_tpu_torch.mcmc import programs as tprograms
from bayesian_inference_tpu_torch.mcmc import runner as trunner
from bayesian_inference_tpu_torch.mcmc import stretch as tstretch
from bayesian_inference_tpu_torch.ops import _native
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs
from bayesian_inference_tpu_torch.utils import flops as tflops

MODES = ["block", "lowrank"]
W = 8


def _named_shapes(like, woodbury_names=("b", "G", "c0", "half_logdet_D", "U", "d0", "L_D", "W")):
    """{name: shape} of a likelihood's tensors, either package's (JAX's may be
    ShapeDtypeStructs). The JAX package stacks the shared design on the PC
    axis, (k, N, d); the port keeps it once, (N, d): compared without k."""
    out = {"theta_min": like.theta_min.shape, "theta_max": like.theta_max.shape}
    for name in ("U", "D", "d0"):
        for i, t in enumerate(getattr(like, name)):
            out[f"{name}[{i}]"] = t.shape
    for i, g in enumerate(like.groups):
        posts = g[1] if isinstance(g, tuple) else g.posts
        out[f"groups[{i}].X"] = tuple(posts.X.shape)[-2:]
        for name in ("alpha", "Kinv", "prior_var", "lml"):
            out[f"groups[{i}].{name}"] = getattr(posts, name).shape
        for name in ("log_length_scale", "log_noise", "log_constant"):
            out[f"groups[{i}].{name}"] = getattr(posts.params, name).shape
    if like.wb is not None:
        for name in woodbury_names:
            out[f"wb.{name}"] = getattr(like.wb, name).shape
    return {k: tuple(v) for k, v in out.items()}


def _spec(r, mode):
    return tprograms.likelihood_shape_spec(r.temu, r.lo, r.hi, mode=mode, device="cpu", observables=r.observables)


def _start(like, lead=(), seed=3):
    gen = torch.Generator().manual_seed(seed)
    ndim = like.theta_min.shape[0]
    return like.theta_min + (like.theta_max - like.theta_min) * torch.rand((*lead, W, ndim), generator=gen,
                                                                           dtype=like.theta_min.dtype)


def _assert_same_chunk(ours, ref):
    (state, out), (ref_state, ref_out) = ours, ref
    for a, b in zip((*state, *out), (*ref_state, *ref_out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_placeholder_likelihood_has_the_fitted_shapes(fixture_run, mode):
    """The zero-valued placeholder, built from the config and the observables
    alone, has the fitted likelihood's tensors: the same count, shapes and
    dtypes (what lets a program built on it take the fitted one), and by name
    the leaf shapes of JAX's likelihood_shape_spec for the same config."""
    r = fixture_run
    spec, like = _spec(r, mode), r.tlike[mode]
    assert tprograms._signature(spec) == tprograms._signature(like)
    assert spec.mode == mode and len(tprograms._leaves(spec)) > 10
    assert all(float(t.abs().max()) in (0.0, 1.0) for t in tprograms._leaves(spec.groups))
    jspec = jprograms.likelihood_shape_spec(r.jemu, theta_min=r.lo, theta_max=r.hi, mode=mode)
    assert _named_shapes(spec) == _named_shapes(jspec)
    assert all(np.dtype(s.dtype) == np.float64 for s in jax.tree.leaves(jspec))
    assert all(t.dtype == torch.float64 for t in tprograms._leaves(spec))


def test_placeholder_artifact_and_operand_logp_match_jax(fixture_run):
    """_placeholder_group_artifact gives JAX's placeholder for every group
    (the same nested keys, equal arrays), from the file and from the pre-read
    observables; logp_operand is the likelihood's log-posterior, equal to
    JAX's logp_operand at the same positions (rtol 1e-8)."""
    import jax.numpy as jnp
    from test_torch_mcmc import _thetas

    r = fixture_run
    for name, jgroup in r.jemu.emulation_groups_config.items():
        ref = jprograms._placeholder_group_artifact(jgroup)
        tgroup = r.temu.emulation_groups_config[name]
        for ours in (tprograms._placeholder_group_artifact(tgroup),
                     tprograms._placeholder_group_artifact(tgroup, r.observables)):
            assert ours["n_pc"] == ref["n_pc"] and ours["emulators"]["kernel"] == ref["emulators"]["kernel"]
            assert sorted(ours["PCA"]) == sorted(ref["PCA"]) and sorted(ours["emulators"]) == sorted(ref["emulators"])
            for key, value in ref["PCA"].items():
                np.testing.assert_array_equal(ours["PCA"][key], value)
            for key in ("X", "alpha", "Kinv", "prior_var", "lml", "alpha_jitter"):
                np.testing.assert_array_equal(ours["emulators"][key], ref["emulators"][key])
            for key, value in ref["emulators"]["params"].items():
                np.testing.assert_array_equal(ours["emulators"]["params"][key], value)
    theta = _thetas(r)
    ours = tprograms.logp_operand(r.tlike["block"], torch.tensor(theta)).numpy()
    ref = np.asarray(jprograms.logp_operand(r.jlike["block"], jnp.asarray(theta)))
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(ref))
    np.testing.assert_allclose(ours[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-8)


@pytest.mark.parametrize("mode", MODES)
def test_program_chunk_equals_run_chunk(fixture_run, mode):
    """A program built on the placeholder and fed the fitted likelihood gives
    run_chunk's final state, chain, log-probs and acceptance bit for bit, from
    injected draws and from a generator; so does a second chunk, longer than
    the program's buffers (run in pieces); and the results are new tensors,
    not views of the program's buffers."""
    r = fixture_run
    like = r.tlike[mode]
    fn = like.log_posterior
    programs = tprograms.SamplerPrograms(_spec(r, mode), W, r.lo.size, chunk_sizes=[12])
    assert not programs.ok()
    with pytest.raises(RuntimeError, match="compile"):
        programs.init(like, _start(like))
    programs.compile()
    assert programs.ok() and programs.capacity == 12

    x0 = _start(like)
    state0 = tstretch.init_state(fn, x0)
    state_p = programs.init(like, x0)
    assert torch.equal(state_p.log_prob, state0.log_prob)
    rands = tstretch.pregen_rands(12, W, torch.Generator().manual_seed(1), x0.dtype)
    ref = tstretch.run_chunk(state0, fn, 12, rands=rands)
    ours = programs.chunk(state_p, like, 12, rands=rands)
    _assert_same_chunk(ours, ref)
    assert 0 < int(ours[0].n_accepted.sum()) < 12 * W

    first_chain = ours[1][0].clone()
    ref2 = tstretch.run_chunk(ref[0], fn, 29, generator=torch.Generator().manual_seed(2))
    ours2 = programs.chunk(ours[0], like, 29, generator=torch.Generator().manual_seed(2))
    _assert_same_chunk(ours2, ref2)
    assert ours2[1][0].shape == (29, W, r.lo.size)
    assert torch.equal(ours[1][0], first_chain)
    with pytest.raises(ValueError, match="generator or injected draws"):
        programs.chunk(ours[0], like, 5)


@pytest.mark.parametrize("mode", MODES)
def test_batched_program_equals_run_chunk_batched(fixture_run, mode):
    """n_points=P: a program built on the single-offset placeholder and fed
    ``like.with_d0`` of P offsets gives run_chunk_batched's results bit for
    bit, each point drawing from its own generator."""
    r = fixture_run
    ys = np.stack([tobs.data_array_from_h5("", "", pseudodata_index=i, observable_filter=r.temu.observable_filter,
                                           rng=np.random.default_rng(i), observables=r.observables)["y"]
                   for i in (0, 1, 2)])
    if mode == "block":
        d0 = tuple(torch.tensor(d) for d in tlik.pad_residual_offsets(r.temu, r.artifacts, ys, r.observables))
    else:
        d0 = torch.tensor(tlik.residual_offsets_flat(r.temu, r.artifacts, ys, r.observables))
    like = r.tlike[mode].with_d0(d0)
    fn = like.log_posterior
    programs = tprograms.SamplerPrograms(_spec(r, mode), W, r.lo.size, chunk_sizes=[10], n_points=3)
    programs.compile()
    x0 = _start(like, lead=(3,))
    state0 = tstretch.init_state_batched(fn, x0)

    def gens():
        return [torch.Generator().manual_seed(20 + p) for p in range(3)]

    ref = tstretch.run_chunk_batched(state0, fn, 14, generators=gens())
    ours = programs.chunk(programs.init(like, x0), like, 14, generator=gens())
    _assert_same_chunk(ours, ref)
    assert ours[1][0].shape == (14, 3, W, r.lo.size) and ours[1][2].shape == (14, 3)
    with pytest.raises(ValueError, match="one generator per point"):
        programs.chunk(ours[0], like, 5, generator=gens()[:2])
    with pytest.raises(ValueError, match="offsets for 3 points"):
        tprograms.SamplerPrograms(like, W, r.lo.size, chunk_sizes=[10], n_points=2)


def test_program_refuses_what_it_was_not_built_for(fixture_run):
    """A likelihood of another mode or of other tensor shapes, a state of
    another walker count, and an odd walker count raise."""
    r = fixture_run
    programs = tprograms.SamplerPrograms(_spec(r, "block"), W, r.lo.size, chunk_sizes=[4])
    programs.compile()
    like = r.tlike["block"]
    with pytest.raises(ValueError, match="differ from those the program was built for"):
        programs.init(r.tlike["lowrank"], _start(like))
    wider = tlik.EmulatorLikelihood(**{**vars(like), "U": tuple(torch.cat([u, u], dim=-1) for u in like.U)})
    assert not programs.serves(wider, W, r.lo.size)
    with pytest.raises(ValueError, match="differ from those the program was built for"):
        programs.init(wider, _start(like))
    with pytest.raises(ValueError, match="built for"):
        programs.init(like, _start(like)[:-2])
    with pytest.raises(ValueError, match="even"):
        tprograms.SamplerPrograms(like, 7, r.lo.size, chunk_sizes=[4])
    with pytest.raises(ValueError, match="positive chunk size"):
        tprograms.SamplerPrograms(like, W, r.lo.size, chunk_sizes=[0])


def test_chunk_sizes_for_config_are_what_run_mcmc_dispatches(fixture_run, monkeypatch):
    """chunk_sizes_for_config names the chunk lengths run_mcmc asks its
    programs for, with and without a checkpoint cadence."""
    r = fixture_run
    cfg = r.tmcmc  # 40 burn-in steps, 100 production steps
    assert tprograms.chunk_sizes_for_config(cfg) == [20, 100] == jprograms.chunk_sizes_for_config(r.jmcmc)
    assert tprograms.chunk_sizes_for_config(cfg, 30) == [10, 20, 30]
    asked = []
    inner = tprograms.SamplerPrograms.chunk
    monkeypatch.setattr(tprograms.SamplerPrograms, "chunk",
                        lambda self, s, like, n, **k: asked.append(n) or inner(self, s, like, n, **k))
    trunner.run_mcmc(cfg, device="cpu", emulation_results=r.artifacts, observables=r.observables, write=False,
                     checkpoint_every=30)
    assert asked == [20, 20, 30, 30, 30, 10]
    assert sorted(set(asked)) == tprograms.chunk_sizes_for_config(cfg, 30)


def _run_kw(r, **kw):
    return dict(device="cpu", emulation_results=r.artifacts, observables=r.observables, write=False, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_prewarmed_run_mcmc_equals_unwarmed(fixture_run, monkeypatch, mode):
    """run_mcmc with programs prewarmed from the config alone equals run_mcmc
    building them inline, bit for bit; the handle serves a second run; and a
    prewarmed run cut during its third production chunk and resumed (with a
    handle prewarmed anew) equals them too."""
    r = fixture_run
    programs = tprograms.prewarm_sampler_programs(r.tmcmc, mode=mode, checkpoint_every=30, device="cpu",
                                                  observables=r.observables)
    assert programs is not None and programs.ok() and programs.mode == mode and programs.capacity == 30
    kw = _run_kw(r, seed=11, mode=mode, checkpoint_every=30)
    cold = trunner.run_mcmc(r.tmcmc, **kw)
    warm = trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
    again = trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
    keys = ("chain", "log_prob", "acceptance_fraction", "burn_log_prob", "split_rhat")
    for key in keys:
        np.testing.assert_array_equal(warm[key], cold[key], err_msg=key)
        np.testing.assert_array_equal(again[key], cold[key], err_msg=key)

    inner, calls = tprograms.SamplerPrograms.chunk, []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) > 2 + 2:
            raise KeyboardInterrupt("interrupted")
        return inner(*args, **kwargs)

    monkeypatch.setattr(tprograms.SamplerPrograms, "chunk", interrupted)
    with pytest.raises(KeyboardInterrupt):
        trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
    monkeypatch.undo()
    path = trunner._checkpoint_path(r.tmcmc)
    with open(path, "rb") as f:
        pickle.load(f)
        assert [pickle.load(f)["steps_done"] for _ in range(2)] == [30, 60]
    fresh = tprograms.prewarm_sampler_programs(r.tmcmc, mode=mode, checkpoint_every=30, device="cpu",
                                               observables=r.observables)
    resumed = trunner.run_mcmc(r.tmcmc, programs=fresh, **kw)
    assert not os.path.exists(path)
    for key in keys:
        np.testing.assert_array_equal(resumed[key], cold[key], err_msg=key)


@pytest.mark.parametrize("mode", MODES)
def test_prewarmed_closure_batch_equals_unwarmed(fixture_run, mode):
    """run_closure_batch with programs prewarmed for its point count equals
    the batch that builds them inline, point by point, bit for bit."""
    r = fixture_run
    programs = tprograms.prewarm_sampler_programs(r.tmcmc, mode=mode, device="cpu", observables=r.observables,
                                                  n_points=2)
    assert programs.n_points == 2
    kw = _run_kw(r, seed=4, mode=mode)
    cold = trunner.run_closure_batch(r.tmcmc, (0, 2), **kw)
    warm = trunner.run_closure_batch(r.tmcmc, (0, 2), programs=programs, **kw)
    for i in (0, 2):
        for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat"):
            np.testing.assert_array_equal(warm[i][key], cold[i][key], err_msg=f"{i}/{key}")


@pytest.mark.parametrize("what", ["walkers", "mode", "points"])
def test_mismatched_handle_is_rebuilt_with_a_warning(fixture_run, caplog, what):
    """A prewarmed handle built for another walker count, likelihood mode or
    point count is dropped with one warning and the run builds its own
    programs: the chain is that of an unwarmed run."""
    r = fixture_run
    if what == "walkers":
        programs = tprograms.SamplerPrograms(_spec(r, "block"), 6, r.lo.size, chunk_sizes=[20, 100])
    elif what == "mode":
        programs = tprograms.SamplerPrograms(_spec(r, "lowrank"), r.tmcmc.n_walkers, r.lo.size, chunk_sizes=[20, 100])
    else:
        programs = tprograms.SamplerPrograms(_spec(r, "block"), r.tmcmc.n_walkers, r.lo.size, chunk_sizes=[20, 100],
                                             n_points=2)
    programs.compile()
    kw = _run_kw(r, seed=2, mode="block")
    with caplog.at_level("WARNING", logger=trunner.__name__):
        out = trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
    assert caplog.text.count("prewarmed sampler programs do not match") == 1
    np.testing.assert_array_equal(out["chain"], trunner.run_mcmc(r.tmcmc, **kw)["chain"])


def test_prewarm_returns_none_for_unknown_mode(fixture_run):
    r = fixture_run
    assert tprograms.prewarm_sampler_programs(r.tmcmc, mode="dense", device="cpu", observables=r.observables) is None


def test_prewarm_reads_the_observables_file(fixture_run):
    """Without an observables dict the shapes come from the configured h5
    file in the run directory, as the JAX package reads them."""
    r = fixture_run
    programs = tprograms.prewarm_sampler_programs(r.tmcmc, device="cpu")
    assert programs.serves(r.tlike["block"], r.tmcmc.n_walkers, r.lo.size)


def test_run_mcmc_through_prewarmed_programs_matches_jax_under_injected_draws(fixture_run):
    """The slice as a whole: JAX artifacts in, the port's run_mcmc through
    programs prewarmed from the config, JAX's draws injected; the burn-in
    log-probs equal JAX's (rtol 1e-8) and the production chain equals the
    chain JAX's own run_mcmc writes (chain rtol 1e-10, log-probs rtol 1e-8:
    the tolerances of the parity test without programs)."""
    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

    r = fixture_run
    draws, jburn = _jax_run_mcmc_draws(r.jlike["block"], r.jmcmc, r.lo, r.hi)
    programs = tprograms.prewarm_sampler_programs(r.tmcmc, device="cpu", observables=r.observables)
    out = trunner.run_mcmc(r.tmcmc, programs=programs, draws=draws, **_run_kw(r, mode="block"))
    np.testing.assert_allclose(out["burn_log_prob"], jburn, rtol=1e-8)
    jrunner.run_mcmc(r.jmcmc, seed=0, mode="block")
    jout = read_dict_from_h5(r.jmcmc.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_allclose(out["log_prob"], jout["log_prob"], rtol=1e-8)
    np.testing.assert_allclose(out["chain"], jout["chain"], rtol=1e-10)
    np.testing.assert_allclose(out["acceptance_fraction"], jout["acceptance_fraction"], rtol=1e-12)


def test_launch_counts_follow_replays():
    """captured_launches takes what a capture recorded out of the kernels'
    counts (a capture runs nothing) and count_replays adds it per replay."""
    a = _native.NativeKernel("tiny_mvn.cu", {})
    b = _native.NativeKernel("fused_block_mvn.cu", {})
    try:
        a.launches, b.launches = 5, 7
        with _native.captured_launches() as record:
            a.launches += 2  # what two launch() calls under capture would add
        assert record == {a: 2} and (a.launches, b.launches) == (5, 7)
        _native.count_replays(record, 100)
        assert (a.launches, b.launches) == (205, 7)
        _native.count_replays({}, 3)
        assert (a.launches, b.launches) == (205, 7)
    finally:
        _native.KERNELS.remove(a)
        _native.KERNELS.remove(b)


@pytest.mark.parametrize("mode", MODES)
def test_mcmc_step_flops_equal_jax(fixture_run, mode):
    """The analytic FLOPs of a sampler step equal the JAX package's for the
    likelihood of the same config, from the fitted likelihood and from the
    placeholder alike."""
    r = fixture_run
    ref = jflops.mcmc_step_flops(r.jlike[mode], 100)
    assert tflops.mcmc_step_flops(r.tlike[mode], 100) == ref > 0
    assert tflops.mcmc_step_flops(_spec(r, mode), 100) == ref
    assert tflops.mcmc_step_flops(r.tlike[mode], 50) == jflops.mcmc_step_flops(r.jlike[mode], 50)


@pytest.mark.parametrize("N,d,k,restarts,iters", [(195, 6, 41, 50, 60), (32, 6, 4, 4, 20), (60, 3, 2, 2, 10)])
def test_fit_flops_equal_jax(N, d, k, restarts, iters):
    """fit_iteration_flops and fit_total_flops equal the JAX package's, at
    the production fit, the fixture's and one with no halving stage."""
    assert tflops.fit_iteration_flops(N, d) == jflops.fit_iteration_flops(N, d)
    assert tflops.fit_total_flops(N, d, k, restarts, iters) == jflops.fit_total_flops(N, d, k, restarts, iters)
    assert tflops.fit_total_flops(N, d, k, restarts, iters, 15, 3) == jflops.fit_total_flops(N, d, k, restarts,
                                                                                             iters, 15, 3)


def test_device_peak_is_the_cards_fp32_rate(monkeypatch):
    """The peak is the H100's FP32 rate outside the tensor cores, by the
    card's name; no TPU figure is in the table."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tflops.device_peak_tflops() == 67.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "some other card")
    assert tflops.device_peak_tflops(0) == 67.0
    assert not [k for k in tflops._PEAK_FP32_TFLOPS_BY_NAME if "TPU" in k]


def test_chain_transfer_is_named_in_one_warning(fixture_run, caplog):
    """``mcmc.chain_transfer`` parses, for configs written for the JAX
    package, but the port downloads every chain losslessly: a run with it set
    says so once, and gives the chain of a run without it."""
    r = fixture_run
    ac = {**r.tmcmc.analysis_config}
    ac["parameters"] = {**ac["parameters"], "mcmc": {**ac["parameters"]["mcmc"], "chain_transfer": "uint16"}}
    cfg = tconfigs.MCMCConfig(analysis_name=r.tmcmc.analysis_name, parameterization="exponential", analysis_config=ac,
                              config_file=str(r.path))
    assert cfg.chain_transfer == "uint16"
    with caplog.at_level("WARNING", logger=trunner.__name__):
        out = trunner.run_mcmc(cfg, **_run_kw(r, seed=3))
    assert caplog.text.count("chain_transfer = 'uint16' has no effect") == 1
    caplog.clear()
    with caplog.at_level("WARNING", logger=trunner.__name__):
        plain = trunner.run_mcmc(r.tmcmc, **_run_kw(r, seed=3))
    assert "chain_transfer" not in caplog.text
    np.testing.assert_array_equal(out["chain"], plain["chain"])


# The stretch move's options, one at a time and all together.
OPTION_CASES = {
    "a": {"a": 1.5},
    "fixed_split": {"randomize_split": False},
    "thin": {"thin": 4},
    "no_chain": {"store_chain": False},
    "all": {"a": 1.5, "randomize_split": False, "thin": 4, "store_chain": False},
}


def _assert_same_result(ours, ref, store_chain):
    (state, out), (ref_state, ref_out) = ours, ref
    if not store_chain:
        assert isinstance(out, torch.Tensor) and isinstance(ref_out, torch.Tensor)
        out, ref_out = (out,), (ref_out,)
    assert len(out) == len(ref_out) == (3 if store_chain else 1)
    for a, b in zip((*state, *out), (*ref_state, *ref_out)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_program_with_options_equals_the_eager_loop(fixture_run, case, batched):
    """A program built with ``a``, ``randomize_split``, ``thin`` or
    ``store_chain`` (and all four) gives the eager loop's final state and
    outputs bit for bit, for one ensemble and for a batch of points, from a
    generator; so does a second chunk longer than the program's buffers
    (capacity 12, rounded to a multiple of ``thin``; 28 steps run in pieces).
    Without ``store_chain`` the program holds no chain buffer."""
    r = fixture_run
    options = OPTION_CASES[case]
    store = options.get("store_chain", True)
    like = r.tlike["block"]
    lead = ()
    if batched:
        ys = np.stack([tobs.data_array_from_h5("", "", pseudodata_index=i, observable_filter=r.temu.observable_filter,
                                               rng=np.random.default_rng(i), observables=r.observables)["y"]
                       for i in (0, 1)])
        like = like.with_d0(tuple(torch.tensor(d) for d in tlik.pad_residual_offsets(r.temu, r.artifacts, ys,
                                                                                      r.observables)))
        lead = (2,)
    fn = like.log_posterior
    programs = tprograms.SamplerPrograms(_spec(r, "block"), W, r.lo.size, chunk_sizes=[13],
                                         n_points=2 if batched else None, **options)
    programs.compile()
    assert programs.capacity == (12 if options.get("thin", 1) == 4 else 13)
    assert len(programs._outputs) == (3 if store else 1)
    assert programs._outputs[-1].shape[0] == programs.capacity // options.get("thin", 1)

    def gens(seed):
        if batched:
            return [torch.Generator().manual_seed(seed + p) for p in range(2)]
        return torch.Generator().manual_seed(seed)

    eager = tstretch.run_chunk_batched if batched else tstretch.run_chunk
    gen_kw = "generators" if batched else "generator"
    x0 = _start(like, lead=lead)
    ref = eager(tstretch.init_state(fn, x0), fn, 12, **{gen_kw: gens(1)}, **options)
    ours = programs.chunk(programs.init(like, x0), like, 12, generator=gens(1))
    _assert_same_result(ours, ref, store)
    ref2 = eager(ref[0], fn, 28, **{gen_kw: gens(5)}, **options)
    ours2 = programs.chunk(ours[0], like, 28, generator=gens(5))
    _assert_same_result(ours2, ref2, store)
    acc = ours2[1][2] if store else ours2[1]
    assert acc.shape == (28 // options.get("thin", 1), *lead)
    assert 0 < int(ours2[0].n_accepted.sum()) < 40 * W * (2 if batched else 1)
    if options.get("thin", 1) > 1:
        with pytest.raises(ValueError, match="thin 4 must divide"):
            programs.chunk(ours2[0], like, 10, generator=gens(6))


@pytest.mark.parametrize("other", ["a", "randomize_split", "store_chain", "thin", "mesh"])
def test_serves_refuses_a_handle_of_other_options(fixture_run, caplog, other):
    """serves() compares the move's options and the mesh: a handle built with
    another ``a``, split, ``store_chain``, ``thin`` or mesh does not serve a
    default run, and run_mcmc drops it with its warning and gives the chain
    of an unwarmed run."""
    from bayesian_inference_tpu_torch.parallel.mesh import get_mesh

    r = fixture_run
    like = r.tlike["block"]
    built = {"a": {"a": 1.5}, "randomize_split": {"randomize_split": False}, "store_chain": {"store_chain": False},
             "thin": {"thin": 2}, "mesh": {"mesh": get_mesh(devices=["cpu"])}}[other]
    programs = tprograms.SamplerPrograms(_spec(r, "block"), r.tmcmc.n_walkers, r.lo.size, chunk_sizes=[20, 100],
                                         **built)
    programs.compile()
    assert programs.serves(like, r.tmcmc.n_walkers, r.lo.size, **built)
    assert not programs.serves(like, r.tmcmc.n_walkers, r.lo.size)
    assert programs.options == (built.get("a", 2.0), built.get("randomize_split", True),
                                built.get("store_chain", True), built.get("thin", 1))
    kw = _run_kw(r, seed=2, mode="block")
    with caplog.at_level("WARNING", logger=trunner.__name__):
        out = trunner.run_mcmc(r.tmcmc, programs=programs, **kw)
    assert caplog.text.count("prewarmed sampler programs do not match") == 1
    np.testing.assert_array_equal(out["chain"], trunner.run_mcmc(r.tmcmc, **kw)["chain"])


def test_compile_async_returns_the_handle_and_its_methods_wait(fixture_run):
    """compile_async starts the build and returns the handle itself, as the
    JAX package's does; ok() and chunk wait for it, and the result is the
    synchronously built program's. A build that fails raises from ok()."""
    r = fixture_run
    like = r.tlike["block"]
    programs = tprograms.SamplerPrograms(_spec(r, "block"), W, r.lo.size, chunk_sizes=[8])
    assert programs.compile_async() is programs
    assert programs.ok() and programs.compile_seconds is not None
    sync = tprograms.SamplerPrograms(_spec(r, "block"), W, r.lo.size, chunk_sizes=[8])
    sync.compile()
    x0 = _start(like)
    _assert_same_chunk(programs.chunk(programs.init(like, x0), like, 8, generator=torch.Generator().manual_seed(1)),
                       sync.chunk(sync.init(like, x0), like, 8, generator=torch.Generator().manual_seed(1)))

    broken = tprograms.SamplerPrograms(_spec(r, "block"), W, r.lo.size, chunk_sizes=[8])
    broken.compile = lambda: (_ for _ in ()).throw(ValueError("no build"))
    broken.compile_async()
    with pytest.raises(RuntimeError, match="the build failed"):
        broken.ok()
