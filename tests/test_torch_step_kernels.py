"""The sampler step's two kernels, K5 (fused GP predict, ops/gp_predict.py)
and K6 (the stretch move, ops/stretch_move.py), on the CPU: their plain
versions against the JAX package on the same float64 inputs, made with numpy
from a seed, and their wrappers' routing and checks. The kernels themselves
are held against these plain versions on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t64, to_np

from bayesian_inference_tpu.mcmc import stretch as jstretch
from bayesian_inference_tpu.models import gp as jgp
from bayesian_inference_tpu.ops import gram as jgram
from bayesian_inference_tpu_torch.mcmc import stretch as tstretch
from bayesian_inference_tpu_torch.models import gp as tgp
from bayesian_inference_tpu_torch.ops import gp_predict as k5
from bayesian_inference_tpu_torch.ops import gram as tgram
from bayesian_inference_tpu_torch.ops import stretch_move as k6

NUS = [0.5, 1.5, 2.5, None]


def _posteriors(nu, with_constant, k=4, N=30, d=6, seed=0):
    """k stacked GPs on one design, fitted by both packages from the same
    hyperparameters and targets: (JAX config, posterior), (port config, posterior)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (N, d))
    Y = rng.normal(size=(k, N))
    raw = (np.log(rng.uniform(0.3, 1.5, (k, d))), np.log(rng.uniform(0.01, 0.2, k)), np.log(rng.uniform(0.5, 2.0, k)))
    jcfg = jgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    tcfg = tgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    jp = jgram.KernelParams(*map(jnp.asarray, raw))
    jpost = jax.vmap(lambda p, y: jgp.posterior_from_params_matmul(jcfg, p, jnp.asarray(X), y, 1e-8))(jp, jnp.asarray(Y))
    tpost = tgp.posterior_from_params_matmul(tcfg, tgram.KernelParams(*map(t64, raw)), t64(X), t64(Y), 1e-8)
    return (jcfg, jpost), (tcfg, tpost)


@pytest.mark.parametrize("with_constant", [False, True], ids=["no-constant", "constant"])
@pytest.mark.parametrize("nu", NUS, ids=["nu0.5", "nu1.5", "nu2.5", "rbf"])
def test_gp_predict_plain_matches_jax(nu, with_constant):
    """K5's plain version against JAX's ``predict_all_shared`` for every
    kernel, float64, rtol 1e-10 (atol 1e-12 for variances that clamp near
    0); ``predict_all_shared`` on CPU tensors is the plain version, bit for
    bit, and launches nothing."""
    (jcfg, jpost), (tcfg, tpost) = _posteriors(nu, with_constant, seed=len(str(nu)) + with_constant)
    theta = np.random.default_rng(7).uniform(-0.1, 1.1, (11, 6))
    j_mean, j_var = jgp.predict_all_shared(jcfg, jpost, jnp.asarray(theta))
    mean, var = k5.gp_predict_plain(tcfg, tpost, t64(theta))
    np.testing.assert_allclose(to_np(mean), np.asarray(j_mean), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(to_np(var), np.asarray(j_var), rtol=1e-10, atol=1e-12)
    before = k5.KERNEL.launches
    routed = tgp.predict_all_shared(tcfg, tpost, t64(theta))
    assert torch.equal(routed[0], mean) and torch.equal(routed[1], var)
    assert k5.KERNEL.launches == before


def _gaussian(mu, prec):
    def jfn(x):
        r = x - jnp.asarray(mu)
        return -0.5 * jnp.einsum("...i,ij,...j->...", r, jnp.asarray(prec), r)

    def tfn(x):
        r = x - t64(mu)
        return -0.5 * torch.einsum("...i,ij,...j->...", r, t64(prec), r)

    return jfn, tfn


def _target(d=5, W=12, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    return rng.normal(size=d), A @ A.T + np.eye(d), rng.normal(size=(W, d))


def _jax_draws(key, n, W):
    rands, _ = jstretch._pregen_rands(key, n, W, jnp.float64, True)
    return {k: np.asarray(v) for k, v in rands.items()}


def _phases(state, rands, t, fn, a, outputs=None):
    """One step composed of the move's three plain phases."""
    move = k6.propose_plain(state.coords, state.log_prob, rands, t, 1, 0, a)
    move = k6.accept_propose_plain(move, fn(move.y), rands, t, 1, 0, a)
    return tstretch.EnsembleState(*k6.accept_assemble_plain(move, fn(move.y), rands, t, 1, 0, a, state.n_accepted,
                                                            state.n_accepted, outputs))


def test_move_phases_compose_to_the_jax_step():
    """The three plain phases, composed around the two log-prob calls, give
    JAX's ``_step_with_rands`` under its own draws (positions and log-probs
    rtol 1e-10, the same accept decisions), at every row of a 6-step draw
    table read through the step counter; the batched layout (P = 3 points)
    gives each point's single-ensemble step (positions and accept counts bit
    for bit), and its output row."""
    mu, prec, x0 = _target()
    jfn, tfn = _gaussian(mu, prec)
    n, W = 6, x0.shape[0]
    draws = _jax_draws(jax.random.key(21), n, W)
    rands = {k: torch.tensor(v) for k, v in draws.items()}
    jstate = jstretch.init_state(jax.random.key(0), jfn, jnp.asarray(x0))
    state = tstretch.init_state(tfn, t64(x0))
    accepted = 0
    for row in range(n):
        jstate = jstretch._step_with_rands(jstate, {k: jnp.asarray(v[row]) for k, v in draws.items()}, jfn, a=2.0)
        state = _phases(state, rands, torch.tensor([row]), tfn, 2.0)
        np.testing.assert_allclose(to_np(state.coords), np.asarray(jstate.coords), rtol=1e-10)
        np.testing.assert_allclose(to_np(state.log_prob), np.asarray(jstate.log_prob), rtol=1e-10)
        np.testing.assert_array_equal(to_np(state.n_accepted), np.asarray(jstate.n_accepted))
        accepted = int(state.n_accepted.sum())
    assert 0 < accepted < n * W

    # P = 3 ensembles in one batched step against three single ones.
    P = 3
    xb = np.stack([x0 + 0.1 * p for p in range(P)])
    keys = [jax.random.key(30 + p) for p in range(P)]
    per_point = [{k: torch.tensor(v) for k, v in _jax_draws(key, 1, W).items()} for key in keys]
    batched = {k: torch.stack([r[k] for r in per_point], dim=1) for k in per_point[0]}
    states = tstretch.init_state_batched(tfn, t64(xb))
    outputs = tstretch.chunk_outputs(1, states)
    new = _phases(states, batched, torch.tensor([0]), tfn, 1.7, outputs)
    for p in range(P):
        single = tstretch.init_state(tfn, t64(xb[p]))
        one = _phases(single, per_point[p], torch.tensor([0]), tfn, 1.7)
        assert torch.equal(new.coords[p], one.coords) and torch.equal(new.n_accepted[p], one.n_accepted)
        # The target's einsum rounds differently over (P, W) than over (W,).
        np.testing.assert_allclose(to_np(new.log_prob[p]), to_np(one.log_prob), rtol=1e-13)
    chain, log_prob, acc = outputs
    assert torch.equal(chain[0], new.coords) and torch.equal(log_prob[0], new.log_prob)
    assert torch.equal(acc[0], new.n_accepted.to(acc.dtype).mean(-1))


def test_chunk_with_a_and_thin_matches_the_jax_chunk():
    """``run_chunk`` with ``a`` = 1.7 and ``thin`` = 2 (the phases at draw rows
    t * 2 + j) against JAX's chunk with the same options and draws: chain,
    log-probs and the final state within 1e-10, the acceptance trace equal;
    int32 injected indices give the same chunk."""
    mu, prec, x0 = _target(seed=9)
    jfn, tfn = _gaussian(mu, prec)
    n, W = 16, x0.shape[0]
    key = jax.random.key(5)
    jfinal, (jchain, jlogp, jacc) = jstretch.run_chunk(jstretch.init_state(key, jfn, jnp.asarray(x0)), jfn, n,
                                                       a=1.7, thin=2)
    rands = {k: torch.tensor(v) for k, v in _jax_draws(key, n, W).items()}
    state = tstretch.init_state(tfn, t64(x0))
    final, (chain, logp, acc) = tstretch.run_chunk(state, tfn, n, rands=rands, a=1.7, thin=2)
    assert chain.shape == (n // 2, W, x0.shape[1])
    np.testing.assert_allclose(to_np(chain), np.asarray(jchain), rtol=1e-10)
    np.testing.assert_allclose(to_np(logp), np.asarray(jlogp), rtol=1e-10)
    np.testing.assert_allclose(to_np(acc), np.asarray(jacc), rtol=1e-12)
    np.testing.assert_allclose(to_np(final.coords), np.asarray(jfinal.coords), rtol=1e-10)
    np.testing.assert_array_equal(to_np(final.n_accepted), np.asarray(jfinal.n_accepted))
    as_int32 = {k: v.to(torch.int32) if k in k6.INDEX_KEYS else v for k, v in rands.items()}
    again = tstretch.run_chunk(state, tfn, n, rands=as_int32, a=1.7, thin=2)
    assert all(torch.equal(a, b) for a, b in zip((*again[0], *again[1]), (*final, chain, logp, acc)))


def test_a_walker_proposed_outside_the_box_is_rejected():
    """A box log-posterior (-inf outside [0, 1]^d, as the likelihood's): a
    proposal pushed outside the box by the stretch is rejected even under an
    accept draw that takes any finite ratio; the walkers whose proposals stay
    inside are accepted. The same holds on the second half."""
    d, W = 3, 4
    half = W // 2

    def fn(x):
        inside = torch.all((x > 0.0) & (x < 1.0), dim=-1)
        return torch.where(inside, -0.5 * (x * x).sum(-1), -torch.inf)

    coords = t64([[0.9, 0.9, 0.9], [0.5, 0.5, 0.5], [0.1, 0.1, 0.1], [0.45, 0.45, 0.45]])
    state = tstretch.init_state(fn, coords)
    ident = torch.arange(W)[None]
    # z = a = 2 for every walker: walker 0 (0.9) against partner 2 (0.1) goes
    # to 1.7, walker 1 (0.5) against 3 (0.45) to 0.55; then walker 2 against
    # the updated walker 1 (0.55) goes to -0.35 and walker 3 to 0.35.
    rands = {"perm": ident, "inv": ident.clone(), "u_z": torch.ones((1, 2, half), dtype=torch.float64),
             "partners": torch.tensor([[[0, 1], [1, 1]]]), "u_acc": torch.full((1, 2, half), 1e-300, dtype=torch.float64)}
    new = _phases(state, rands, torch.tensor([0]), fn, 2.0)
    assert new.n_accepted.tolist() == [0, 1, 0, 1]
    assert torch.equal(new.coords[0], coords[0]) and torch.equal(new.coords[2], coords[2])
    np.testing.assert_allclose(to_np(new.coords[1]), [0.55] * 3, rtol=1e-12)
    np.testing.assert_allclose(to_np(new.coords[3]), [0.35] * 3, rtol=1e-12)
    assert bool(torch.isfinite(new.log_prob).all())


def test_wrappers_take_the_plain_path_on_the_cpu_and_check_their_operands():
    """On CPU tensors both wrappers run their plain versions and launch
    nothing; the CUDA paths' checks refuse what the kernels do not take
    (float64, int32 indices, mismatched shapes), before any launch."""
    (_, _), (tcfg, tpost) = _posteriors(1.5, False, seed=4)
    theta = t64(np.random.default_rng(1).uniform(0, 1, (5, 6)))
    launches = (k5.KERNEL.launches, k6.KERNEL.launches)
    assert all(torch.equal(a, b) for a, b in zip(k5.gp_predict(tcfg, tpost, theta),
                                                 k5.gp_predict_plain(tcfg, tpost, theta)))
    mu, prec, x0 = _target(W=6)
    _, tfn = _gaussian(mu, prec)
    rands = {k: torch.tensor(v) for k, v in _jax_draws(jax.random.key(2), 2, 6).items()}
    t = torch.zeros(1, dtype=torch.long)
    state = tstretch.init_state(tfn, t64(x0))
    move = k6.propose(state.coords, state.log_prob, rands, t, 1, 0, 2.0)
    plain = k6.propose_plain(state.coords, state.log_prob, rands, t, 1, 0, 2.0)
    assert all(torch.equal(a, b) for a, b in zip((move.xp, move.lpp, move.y), (plain.xp, plain.lpp, plain.y)))
    assert (k5.KERNEL.launches, k6.KERNEL.launches) == launches

    with pytest.raises(TypeError, match="float32"):
        k5._gp_predict_cuda(tcfg, tpost, theta)
    wrong = tgp.GPPosterior(tpost.params, tpost.X, tpost.alpha, tpost.Kinv[:, :-1], tpost.prior_var, tpost.lml)
    with pytest.raises(ValueError, match="Kinv"):
        k5._gp_predict_cuda(tcfg, wrong, theta.float())
    with pytest.raises(ValueError, match="Matern"):
        k5._gp_predict_cuda(tgram.KernelConfig(nu=3.5), tpost, theta.float())

    f32 = {k: v.float() if v.is_floating_point() else v for k, v in rands.items()}
    x, lp = state.coords.float(), state.log_prob.float()
    assert k6._check_operands(x, lp, f32, t) == (1, 6, x0.shape[1])
    with pytest.raises(ValueError, match="float32"):
        k6._check_operands(state.coords, state.log_prob, f32, t)
    with pytest.raises(ValueError, match="'perm'"):
        k6._check_operands(x, lp, {**f32, "perm": f32["perm"].int()}, t)
    with pytest.raises(ValueError, match="'u_z'"):
        k6._check_operands(x, lp, {**f32, "u_z": f32["u_z"][:, :1]}, t)
    with pytest.raises(ValueError, match="W even"):
        k6._check_operands(x[:5], lp[:5], f32, t)
