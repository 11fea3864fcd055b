"""Port parity of the GP emulator stack: LML with its closed-form gradient,
posterior build and predict, PCA, the batched L-BFGS and the whole fit, each
against the JAX package on the same float64 inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import t64, to_np

from bayesian_inference_tpu.io import observables as jobs
from bayesian_inference_tpu.models import gp as jgp
from bayesian_inference_tpu.models import gp_fit as jfit
from bayesian_inference_tpu.models import pca as jpca
from bayesian_inference_tpu.ops import gram as jgram
from bayesian_inference_tpu_torch.models import gp as tgp
from bayesian_inference_tpu_torch.models import gp_fit as tfit
from bayesian_inference_tpu_torch.models import pca as tpca
from bayesian_inference_tpu_torch.ops import gram as tgram

KERNEL_CONFIGS = [(0.5, False), (1.5, False), (2.5, True), (None, False)]


def _stack(nu, with_constant, B=3, N=32, d=6, seed=0):
    """B stacked GPs on one design: JAX and port configs, params, X, Y."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (N, d))
    Y = rng.normal(size=(B, N))
    log_ls = np.log(rng.uniform(0.3, 1.5, (B, d)))
    log_noise = np.log(rng.uniform(0.01, 0.2, B))
    log_const = np.log(rng.uniform(0.5, 2.0, B))
    jcfg = jgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    tcfg = tgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    jp = jgram.KernelParams(jnp.asarray(log_ls), jnp.asarray(log_noise), jnp.asarray(log_const))
    return jcfg, tcfg, jp, (log_ls, log_noise, log_const), X, Y


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS)
def test_lml_matmul_value_and_grad_match_jax(nu, with_constant):
    """Forward value and the closed-form backward (dLML/dK = (aa^T - K^-1)/2)
    against JAX's matmul LML (value rtol 1e-10, grads rtol 1e-8 atol 1e-10)
    and its autodiff LML through the library Cholesky."""
    jcfg, tcfg, jp, raw, X, Y = _stack(nu, with_constant)
    D2 = jgram.pairwise_sqdiff(jnp.asarray(X))
    jitter = 1e-8
    j_val, j_grad = jax.vmap(jax.value_and_grad(
        lambda p, y: jgp.log_marginal_likelihood_matmul(jcfg, p, D2, y, jitter)))(jp, jnp.asarray(Y))
    a_val, a_grad = jax.vmap(jax.value_and_grad(
        lambda p, y: jgp.log_marginal_likelihood_sqdiff(jcfg, p, D2, y, jitter)))(jp, jnp.asarray(Y))

    leaves = [t64(x).requires_grad_(True) for x in raw]
    y = t64(Y).requires_grad_(True)
    lml = tgp.log_marginal_likelihood_matmul(tcfg, tgram.KernelParams(*leaves), t64(np.asarray(D2)), y, jitter)
    lml.sum().backward()

    np.testing.assert_allclose(to_np(lml), np.asarray(j_val), rtol=1e-10)
    np.testing.assert_allclose(to_np(lml), np.asarray(a_val), rtol=1e-10)
    names = ("log_length_scale", "log_noise", "log_constant")
    for leaf, name in zip(leaves, names):
        for ref in (j_grad, a_grad):
            np.testing.assert_allclose(to_np(leaf.grad), np.asarray(getattr(ref, name)), rtol=1e-8, atol=1e-10)
    j_dy = jax.vmap(jax.grad(lambda y, p: jgp.log_marginal_likelihood_matmul(jcfg, p, D2, y, jitter)))(
        jnp.asarray(Y), jp)
    np.testing.assert_allclose(to_np(y.grad), np.asarray(j_dy), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS[1:3])
def test_posterior_and_predict_match_jax(nu, with_constant):
    """posterior_from_params_matmul (alpha rtol 1e-9, K^-1 rtol 1e-8) and
    predict_all_shared on the stacked posterior (rtol 1e-10)."""
    jcfg, tcfg, jp, raw, X, Y = _stack(nu, with_constant, N=40, seed=1)
    jitter = 1e-8
    jpost = jax.vmap(lambda p, y: jgp.posterior_from_params_matmul(jcfg, p, jnp.asarray(X), y, jitter))(
        jp, jnp.asarray(Y))
    tpost = tgp.posterior_from_params_matmul(tcfg, tgram.KernelParams(*map(t64, raw)), t64(X), t64(Y), jitter)
    np.testing.assert_allclose(to_np(tpost.alpha), np.asarray(jpost.alpha), rtol=1e-9)
    np.testing.assert_allclose(to_np(tpost.Kinv), np.asarray(jpost.Kinv), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(to_np(tpost.lml), np.asarray(jpost.lml), rtol=1e-10)
    np.testing.assert_allclose(to_np(tpost.prior_var), np.asarray(jpost.prior_var), rtol=1e-12)

    theta = np.random.default_rng(2).uniform(0.0, 1.0, (9, X.shape[1]))
    j_mean, j_var = jgp.predict_all_shared(jcfg, jpost, jnp.asarray(theta))
    mean, var = tgp.predict_all_shared(tcfg, tpost, t64(theta))
    np.testing.assert_allclose(to_np(mean), np.asarray(j_mean), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(to_np(var), np.asarray(j_var), rtol=1e-10, atol=1e-12)


def test_pca_matches_jax():
    """fit_pca (sklearn sign convention) and the truncation covariance, rtol 1e-10."""
    rng = np.random.default_rng(3)
    Y = rng.normal(size=(30, 12)) @ rng.normal(size=(12, 20)) + rng.normal(size=20)
    j_state, j_Z = jpca.fit_pca(Y, max_n_components=8)
    t_state, t_Z = tpca.fit_pca(Y, max_n_components=8)
    np.testing.assert_allclose(t_Z, np.asarray(j_Z), rtol=1e-10, atol=1e-12)
    for name in ("mean", "scale", "components", "explained_variance", "explained_variance_ratio",
                 "singular_values"):
        np.testing.assert_allclose(getattr(t_state, name), np.asarray(getattr(j_state, name)),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tpca.truncation_covariance(t_state, 3),
                               np.asarray(jpca.truncation_covariance(j_state, 3)), rtol=1e-10, atol=1e-12)


def test_lbfgs_directions_match_optax():
    """The batched L-BFGS direction reproduces optax.scale_by_lbfgs(memory 8)
    row by row (rtol 1e-8), fed the same (params, gradient) sequence; 11
    iterations, so the memory ring wraps."""
    rng = np.random.default_rng(4)
    B, P = 3, 7
    a, b, c = rng.uniform(0.5, 2.0, (B, P)), rng.uniform(0.0, 0.3, (B, P)), rng.normal(size=(B, P))

    def grad(u):
        return 2 * a * u + 4 * b * u**3 - c

    precond = optax.scale_by_lbfgs(memory_size=8)
    update = jax.jit(precond.update)
    u = rng.normal(size=(B, P))
    states = [precond.init(jnp.asarray(u[i])) for i in range(B)]
    lbfgs = tfit.BatchedLBFGS(t64(u))
    for _ in range(11):
        g = grad(u)
        ref = []
        for i in range(B):
            d, states[i] = update(jnp.asarray(g[i]), states[i], jnp.asarray(u[i]))
            ref.append(np.asarray(d))
        ours = to_np(lbfgs.update(t64(g), t64(u)))
        np.testing.assert_allclose(ours, np.stack(ref), rtol=1e-8, atol=1e-14)
        u = u - 0.5 * ours


@pytest.fixture(scope="module")
def fixture_pcs(test_data_dir):
    """Design (N, 6) and the first 3 PC scores of the fixture's charged-hadron
    observables, prepared once with the JAX package's own host code."""
    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

    obs = read_dict_from_h5(str(test_data_dir), "observables.h5", verbose=False)
    Y = jobs.predictions_matrix_from_h5(
        str(test_data_dir), "observables.h5", observable_filter=jobs.ObservableFilter(["pt_ch_"]),
        observables=obs,
    )
    _, Z = jpca.fit_pca(Y, max_n_components=30)
    return np.asarray(obs["Design"]), np.asarray(Z[:, :3])


def test_fit_gps_matches_jax_on_fixture(fixture_pcs, monkeypatch):
    """The whole fit (4 + 1 restarts, halving at 15 iterations keeping 3, 20
    iterations) from the same restart points: each PC's final LML within
    0.1 nat of the JAX fit (the bar of docs/fit_schedule_study.json)."""
    X, Z = fixture_pcs
    box_min, box_max = X.min(axis=0), X.max(axis=0)
    monkeypatch.setenv("BIQ_FIT_LML", "matmul")  # the JAX fit's TPU path, as the port always runs
    jspec = jfit.spec_from_reference_config(jgram.KernelConfig(nu=1.5), box_min, box_max, n_restarts=4,
                                            n_iters=20, alpha_jitter=1e-10)
    tspec = tfit.spec_from_reference_config(tgram.KernelConfig(nu=1.5), box_min, box_max, n_restarts=4,
                                            n_iters=20, alpha_jitter=1e-10)
    assert jspec.lml_impl == "matmul"
    key = jax.random.key(0)
    jpost = jfit.fit_gps(jspec, jnp.asarray(X), jnp.asarray(Z), key)
    # the restart points exactly as gp_fit._fit_gps_impl draws them from key
    rand_logs = jax.random.uniform(key, (Z.shape[1], jspec.n_restarts, jspec.theta0.shape[0]),
                                   dtype=jspec.theta0.dtype, minval=jspec.log_lo, maxval=jspec.log_hi)
    tpost = tfit.fit_gps(tspec, t64(X), t64(Z), rand_logs=t64(rand_logs))
    np.testing.assert_allclose(to_np(tpost.lml), np.asarray(jpost.lml), rtol=0, atol=0.1)
    # the fitted posterior is self-consistent with its hyperparameters
    check = tgp.posterior_from_params_matmul(tspec.cfg, tpost.params, t64(X), t64(Z.T), 1e-10)
    torch.testing.assert_close(check.lml, tpost.lml, rtol=1e-12, atol=0)


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS)
def test_posteriors_from_params_stacked_match_jax(nu, with_constant):
    """posteriors_from_params_stacked (the JAX package's vmap of
    posterior_from_params over stacked params and target rows) on the same
    float64 inputs, the port's taking the design and targets as numpy
    arrays: alpha, K^-1, prior variance and LML within 1e-10 relative to
    each array's largest magnitude (an element of K^-1 near zero carries the
    rounding of its row, ~1e-16, and no relative error of its own)."""
    jcfg, tcfg, jp, raw, X, Y = _stack(nu, with_constant, N=40, seed=3)
    jitter = 1e-6
    jpost = jgp.posteriors_from_params_stacked(jcfg, jp, jnp.asarray(X), jnp.asarray(Y), jitter)
    tpost = tgp.posteriors_from_params_stacked(tcfg, tgram.KernelParams(*map(t64, raw)), X, Y, jitter)
    assert tpost.X.dtype == torch.float64 and tpost.alpha.shape == Y.shape
    for name in ("alpha", "Kinv", "prior_var", "lml"):
        ours, ref = to_np(getattr(tpost, name)), np.asarray(getattr(jpost, name))
        assert ours.shape == ref.shape, name
        assert np.abs(ours - ref).max() <= 1e-10 * np.abs(ref).max(), name
