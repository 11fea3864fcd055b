"""The port's GP fit as device programs, on the CPU: the LML's direct
value-and-gradient, the fit schedule's knobs (``trial_steps``,
``halving_schedule``, ``halving_keep=0``) against the JAX fit from the same
restart points, the program's body against the eager loop, the program cache,
and the launch counts by batch through graph replays. All float64, inputs from
a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t64, to_np

from bayesian_inference_tpu.io import observables as jobs
from bayesian_inference_tpu.models import gp as jgp
from bayesian_inference_tpu.models import gp_fit as jfit
from bayesian_inference_tpu.models import pca as jpca
from bayesian_inference_tpu.ops import gram as jgram
from bayesian_inference_tpu_torch.models import emulator as temu
from bayesian_inference_tpu_torch.models import gp as tgp
from bayesian_inference_tpu_torch.models import gp_fit as tfit
from bayesian_inference_tpu_torch.ops import _native
from bayesian_inference_tpu_torch.ops import gram as tgram

KERNEL_CONFIGS = [(0.5, False), (0.5, True), (1.5, False), (1.5, True), (2.5, False), (2.5, True), (None, False),
                  (None, True)]


def _stack(nu, with_constant, B=3, N=32, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (N, d))
    Y = rng.normal(size=(B, N))
    raw = (np.log(rng.uniform(0.3, 1.5, (B, d))), np.log(rng.uniform(0.01, 0.2, B)),
           np.log(rng.uniform(0.5, 2.0, B)))
    jcfg = jgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    tcfg = tgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    return jcfg, tcfg, raw, X, Y


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS)
def test_lml_value_and_grad_equals_autograd_and_jax(nu, with_constant):
    """The direct (LML, dLML/d log theta) equals torch.autograd through
    ``log_marginal_likelihood_matmul`` (rtol 1e-12; they share the two
    closed-form functions) and the JAX matmul LML with ``jax.grad`` (value
    rtol 1e-10, gradients rtol 1e-8 atol 1e-10, the tolerances of
    test_lml_matmul_value_and_grad_match_jax)."""
    jcfg, tcfg, raw, X, Y = _stack(nu, with_constant)
    jitter = 1e-8
    D2 = jgram.pairwise_sqdiff(jnp.asarray(X))
    jp = jgram.KernelParams(*map(jnp.asarray, raw))
    j_val, j_grad = jax.vmap(jax.value_and_grad(
        lambda p, y: jgp.log_marginal_likelihood_matmul(jcfg, p, D2, y, jitter)))(jp, jnp.asarray(Y))

    tD2 = t64(np.asarray(D2))
    lml, grads = tgp.lml_value_and_grad(tcfg, tgram.KernelParams(*map(t64, raw)), tD2, t64(Y), jitter)
    assert not lml.requires_grad

    leaves = [t64(x).requires_grad_(True) for x in raw]
    auto = tgp.log_marginal_likelihood_matmul(tcfg, tgram.KernelParams(*leaves), tD2, t64(Y), jitter)
    auto_grads = torch.autograd.grad(auto.sum(), leaves)
    torch.testing.assert_close(lml, auto.detach(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(to_np(lml), np.asarray(j_val), rtol=1e-10)
    for name, ours, ref in zip(("log_length_scale", "log_noise", "log_constant"), dataclasses.astuple(grads),
                               auto_grads):
        torch.testing.assert_close(ours, ref, rtol=1e-12, atol=0)
        np.testing.assert_allclose(to_np(ours), np.asarray(getattr(j_grad, name)), rtol=1e-8, atol=1e-10)
    if not with_constant:
        assert not grads.log_constant.any()


@pytest.mark.parametrize("nu,with_constant", [(1.5, False), (2.5, True)])
def test_objective_gradient_equals_autograd_through_the_box(nu, with_constant):
    """The fit's objective chains the box reparameterisation by hand: its
    gradient in u equals torch.autograd's through sigmoid and the LML (rtol
    1e-11), and a non-finite LML gives +inf with a zero gradient."""
    _, tcfg, _, X, Y = _stack(nu, with_constant, B=4)
    P = X.shape[1] + 1 + int(with_constant)
    rng = np.random.default_rng(1)
    lo, hi = t64(np.full(P, -4.0)), t64(rng.uniform(1.0, 3.0, P))
    D2 = tgram.pairwise_sqdiff(t64(X))
    u = t64(rng.normal(size=(4, P)))
    v, g = tfit._Objective(tcfg, 1e-8, D2, lo, hi)(u, t64(Y))

    ua = u.clone().requires_grad_(True)
    params = tfit.unpack_params(tcfg, lo + (hi - lo) * torch.sigmoid(ua), X.shape[1])
    neg = -tgp.log_marginal_likelihood_matmul(tcfg, params, D2, t64(Y), 1e-8)
    (ga,) = torch.autograd.grad(neg.sum(), ua)
    torch.testing.assert_close(v, neg.detach(), rtol=1e-12, atol=0)
    torch.testing.assert_close(g, ga, rtol=1e-11, atol=1e-14)

    Ybad = t64(Y).clone()
    Ybad[1, 0] = torch.nan
    v, g = tfit._Objective(tcfg, 1e-8, D2, lo, hi)(u, Ybad)
    assert torch.isposinf(v[1]) and not g[1].any() and torch.isfinite(v[[0, 2, 3]]).all() and g[0].any()


def test_lbfgs_reset_starts_the_memory_again():
    """After ``reset`` the directions are those of a new BatchedLBFGS, bit for
    bit, over 11 calls (the 8-slot memory wraps)."""
    rng = np.random.default_rng(2)
    seq = [(t64(rng.normal(size=(3, 5))), t64(rng.normal(size=(3, 5)))) for _ in range(11)]
    used = tfit.BatchedLBFGS(seq[0][1])
    for g, u in seq[:4]:
        used.update(g, u)
    used.reset()
    fresh = tfit.BatchedLBFGS(seq[0][1])
    for g, u in seq:
        assert torch.equal(used.update(g, u), fresh.update(g, u))


@pytest.fixture(scope="module")
def fixture_pcs(test_data_dir):
    """Design (N, 6) and the first 2 PC scores of the fixture's charged-hadron
    observables, prepared with the JAX package's own host code."""
    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

    obs = read_dict_from_h5(str(test_data_dir), "observables.h5", verbose=False)
    Y = jobs.predictions_matrix_from_h5(
        str(test_data_dir), "observables.h5", observable_filter=jobs.ObservableFilter(["pt_ch_"]), observables=obs,
    )
    _, Z = jpca.fit_pca(Y, max_n_components=30)
    return np.asarray(obs["Design"])[:60], np.asarray(Z[:60, :2])


def _specs(X, **fields):
    box_min, box_max = X.min(axis=0), X.max(axis=0)
    kw = dict(n_restarts=6, n_iters=24, alpha_jitter=1e-10)
    jspec = jfit.spec_from_reference_config(jgram.KernelConfig(nu=1.5), box_min, box_max, **kw)
    tspec = tfit.spec_from_reference_config(tgram.KernelConfig(nu=1.5), box_min, box_max, **kw)
    return jspec.replace(**fields), dataclasses.replace(tspec, **fields)


SCHEDULES = {
    "two_trial_steps": dict(trial_steps=(1.0, 0.3)),
    "two_rungs": dict(halving_schedule=((4, 4), (4, 2))),
    "no_halving": dict(halving_keep=0),
    "degenerate_rung": dict(halving_schedule=((5, 99), (6, 3))),
    "single_rung_fields": dict(halving_iters=8, halving_keep=2),
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_fit_schedule_knobs_match_jax(fixture_pcs, monkeypatch, name):
    """``fit_gps`` with each schedule knob against the JAX ``fit_gps`` with
    the same spec fields from the same restart points (6 + 1 restarts, 24
    iterations): each PC's final LML within 0.1 nat, the bar of
    test_fit_gps_matches_jax_on_fixture."""
    X, Z = fixture_pcs
    monkeypatch.setenv("BIQ_FIT_LML", "matmul")
    jspec, tspec = _specs(X, **SCHEDULES[name])
    key = jax.random.key(0)
    jpost = jfit.fit_gps(jspec, jnp.asarray(X), jnp.asarray(Z), key)
    rand_logs = jax.random.uniform(key, (Z.shape[1], jspec.n_restarts, jspec.theta0.shape[0]),
                                   dtype=jspec.theta0.dtype, minval=jspec.log_lo, maxval=jspec.log_hi)
    tpost = tfit.fit_gps(tspec, t64(X), t64(Z), rand_logs=t64(rand_logs))
    np.testing.assert_allclose(to_np(tpost.lml), np.asarray(jpost.lml), rtol=0, atol=0.1)


@pytest.mark.parametrize("fields,n_restarts,n_iters,rungs", [
    ({}, 50, 60, ((15, 3),)),
    ({}, 2, 60, ()),                                              # keep 3 >= pool 3
    ({}, 50, 15, ()),                                             # n_iters does not exceed halving_iters
    ({"halving_keep": 0}, 50, 60, ()),
    ({"halving_schedule": ((4, 4), (4, 2))}, 6, 24, ((4, 4), (4, 2))),
    ({"halving_schedule": ((5, 99), (6, 3))}, 6, 24, ((6, 3),)),
    ({"halving_schedule": ((5, 3), (6, 3))}, 6, 24, ((5, 3),)),   # the second rung would not prune
    ({"halving_schedule": ((5, 99),)}, 6, 24, ()),
    ({"halving_schedule": [[4, 4]], "halving_keep": 0}, 6, 24, ((4, 4),)),
])
def test_halving_rungs_follow_the_jax_rule(fields, n_restarts, n_iters, rungs):
    """The rung list is built as the JAX ``_fit_gps_impl`` builds it: explicit
    schedule, else one rung from halving_iters / halving_keep, else none, and
    rungs that do not prune dropped."""
    spec = tfit.GPFitSpec(cfg=tgram.KernelConfig(), theta0=np.zeros(7), log_lo=-np.ones(7), log_hi=np.ones(7),
                          n_restarts=n_restarts, n_iters=n_iters, **fields)
    assert tfit.halving_rungs(spec) == rungs


@pytest.mark.parametrize("schedule", [((20, 4), (10, 2)), ((24, 3),)])
def test_over_long_halving_schedule_raises(fixture_pcs, schedule):
    """Rungs that spend n_iters or more leave nothing to polish with: a
    ValueError, as in the JAX package."""
    X, Z = fixture_pcs
    jspec, tspec = _specs(X, halving_schedule=schedule)
    with pytest.raises(ValueError, match="halving schedule spends"):
        jfit.fit_gps(jspec, jnp.asarray(X), jnp.asarray(Z), jax.random.key(0))
    with pytest.raises(ValueError, match="halving schedule spends"):
        tfit.fit_gps(tspec, t64(X), t64(Z), generator=torch.Generator().manual_seed(0))


def test_degenerate_rung_equals_no_halving(fixture_pcs):
    """keep >= pool never prunes: bit-identical to the fit with halving off."""
    X, Z = fixture_pcs
    _, off = _specs(X, halving_keep=0, n_iters=8)
    _, degenerate = _specs(X, halving_schedule=((5, 99),), n_iters=8)
    a, b = (tfit.fit_gps(s, t64(X), t64(Z), generator=torch.Generator().manual_seed(3)) for s in (off, degenerate))
    assert torch.equal(a.lml, b.lml) and torch.equal(a.Kinv, b.Kinv)


def _same_posterior(a, b) -> dict:
    return {"log_length_scale": torch.equal(a.params.log_length_scale, b.params.log_length_scale),
            "log_noise": torch.equal(a.params.log_noise, b.params.log_noise),
            "lml": torch.equal(a.lml, b.lml), "alpha": torch.equal(a.alpha, b.alpha),
            "Kinv": torch.equal(a.Kinv, b.Kinv)}


@pytest.mark.parametrize("fields", [
    dict(halving_keep=0, n_iters=14),
    dict(halving_keep=0, n_iters=14, trial_steps=(1.0, 0.3)),
    dict(halving_schedule=((3, 4), (12, 2)), n_iters=28),
    dict(n_iters=30, trial_steps=(1.0, 0.5, 0.1)),
], ids=["one_stage", "two_trial_steps", "two_rungs", "default_rung_three_trials"])
def test_program_body_equals_the_eager_loop(fixture_pcs, fields):
    """The program's body, run eagerly on its static buffers (the CPU), gives
    the eager loop's hyperparameters, LML, alpha and K^-1 bit for bit; every
    case has a stage of 12 iterations or more, so the 8-slot L-BFGS memory
    wraps."""
    X, Z = fixture_pcs
    _, spec = _specs(X, **fields)
    rand_logs = t64(np.random.default_rng(5).uniform(spec.log_lo, spec.log_hi, (Z.shape[1], spec.n_restarts, 7)))
    program = tfit.fit_gps(spec, t64(X), t64(Z), rand_logs=rand_logs)
    eager = tfit.fit_gps(spec, t64(X), t64(Z), rand_logs=rand_logs, eager=True)
    same = _same_posterior(program, eager)
    assert all(same.values()), same
    assert torch.isfinite(program.lml).all()


def test_program_cache_serves_same_shape_fits(fixture_pcs):
    """Five fits of different data of one shape (as the five folds of a CV
    group) share two programs (exploration and polish batch), each fit equal
    to its eager fit (the static buffers are reloaded); the cache never holds
    more than ``MAX_FIT_PROGRAMS``, and a dropped program is built again."""
    X, Z = fixture_pcs
    _, spec = _specs(X, n_restarts=4, n_iters=6, halving_iters=2, halving_keep=2)
    tfit.clear_fit_programs()
    built = tfit.fit_program_stats()["built"]
    rng = np.random.default_rng(6)
    for fold in range(5):
        rows = rng.permutation(60)[:48]
        gens = [torch.Generator().manual_seed(fold) for _ in range(2)]
        a = tfit.fit_gps(spec, t64(X[rows]), t64(Z[rows]), generator=gens[0])
        b = tfit.fit_gps(spec, t64(X[rows]), t64(Z[rows]), generator=gens[1], eager=True)
        assert all(_same_posterior(a, b).values()), fold
    assert tfit.fit_program_stats() == {"cached": 2, "built": built + 2}
    for n in range(40, 40 + tfit.MAX_FIT_PROGRAMS):  # other shapes push the first two out
        tfit.fit_gps(spec, t64(X[:n]), t64(Z[:n]), generator=torch.Generator().manual_seed(0))
    assert tfit.fit_program_stats()["cached"] == tfit.MAX_FIT_PROGRAMS
    tfit.fit_gps(spec, t64(X[rows]), t64(Z[rows]), generator=torch.Generator().manual_seed(0))
    stats = tfit.fit_program_stats()
    assert stats == {"cached": tfit.MAX_FIT_PROGRAMS, "built": built + 2 + 2 * tfit.MAX_FIT_PROGRAMS + 2}
    tfit.clear_fit_programs()
    assert tfit.fit_program_stats()["cached"] == 0


def test_program_refuses_other_shapes(fixture_pcs):
    X, Z = fixture_pcs
    program = tfit.FitProgram(tgram.KernelConfig(nu=1.5), 1e-10, (1.0,), 4, 60, 6, 7, torch.float64,
                              torch.device("cpu"))
    args = (t64(np.zeros((4, 7))), t64(np.zeros((4, 60))), tgram.pairwise_sqdiff(t64(X)), t64(-np.ones(7)),
            t64(np.ones(7)), 2)
    with pytest.raises(RuntimeError, match="compile"):
        program.run(*args)
    program.compile()
    assert not program.captured
    with pytest.raises(ValueError, match="built for"):
        program.run(t64(np.zeros((5, 7))), *args[1:])


def test_launch_counts_by_batch_follow_replays():
    """A launch that names its batch is counted by batch as well; a capture's
    recordings are taken back out of both counts and ``count_replays`` adds
    them per replay, so K3's launches by batch size stay what ran on the
    card when the fit's iterations are graph replays."""
    k3 = _native.NativeKernel("diag_chol_inv.cu", {})
    other = _native.NativeKernel("tiny_mvn.cu", {})
    try:
        k3.launches, k3.launches_by_batch[123] = 4, 4  # an eager evaluation: 4 diagonal blocks
        with _native.captured_launches() as record:
            # what four launch(..., batch=2091) calls under capture would add
            k3.launches += 4
            k3.launches_by_batch[2091] += 4
            other.launches += 1  # a launch that names no batch
        assert record == {k3: 4, other: 1} and record.by_batch == {(k3, 2091): 4}
        assert k3.launches == 4 and dict(k3.launches_by_batch) == {123: 4} and other.launches == 0
        _native.count_replays(record, 15)
        assert k3.launches == 64 and dict(k3.launches_by_batch) == {123: 4, 2091: 60}
        assert other.launches == 15 and not other.launches_by_batch
        _native.count_replays({k3: 1}, 2)  # a plain dict records no batches
        assert k3.launches == 66 and sum(k3.launches_by_batch.values()) == 64
    finally:
        _native.KERNELS.remove(k3)
        _native.KERNELS.remove(other)


def test_specs_compatible_compares_the_schedule_fields():
    """Groups are fused into one fit only when their specs agree, the
    schedule fields included."""
    base = tfit.spec_from_reference_config(tgram.KernelConfig(nu=1.5), np.zeros(3), np.ones(3))
    assert temu._specs_compatible(base, dataclasses.replace(base))
    assert temu._specs_compatible(base, dataclasses.replace(base, halving_schedule=[]))
    for fields in (dict(halving_iters=10), dict(halving_keep=0), dict(halving_schedule=((4, 4),)),
                   dict(trial_steps=(1.0, 0.3)), dict(n_iters=7)):
        assert not temu._specs_compatible(base, dataclasses.replace(base, **fields)), fields
