"""Port parity of the device ops: GP kernels, kernel K3's blocked Cholesky
inverse and kernel K1's fused block-MVN log-likelihood (plain versions), each
against the JAX package on the same float64 inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t64, to_np

from bayesian_inference_tpu.ops import blocked_cholesky as jbc
from bayesian_inference_tpu.ops import gram as jgram
from bayesian_inference_tpu.ops import pallas_mvn as jmvn
from bayesian_inference_tpu_torch.ops import blocked_cholesky as tbc
from bayesian_inference_tpu_torch.ops import fused_mvn as tmvn
from bayesian_inference_tpu_torch.ops import gram as tgram
from bayesian_inference_tpu_torch.ops.cholesky import tiny_mvn_loglike
from bayesian_inference_tpu_torch.ops.mvn import mvn_loglike_dense

KERNEL_CONFIGS = [(0.5, False), (1.5, False), (2.5, True), (None, True)]


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS)
def test_gram_matches_jax(nu, with_constant):
    """Every gram function over a stack of 3 GPs, against the JAX functions
    vmapped over the same stack (rtol 1e-12: identical float64 formulas)."""
    rng = np.random.default_rng(11)
    n1, n2, d, B = 9, 7, 4, 3
    X1, X2 = rng.uniform(0, 2, (n1, d)), rng.uniform(0, 2, (n2, d))
    log_ls, log_noise, log_const = rng.normal(size=(B, d)) * 0.5, rng.normal(size=B) - 3, rng.normal(size=B)
    jcfg = jgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    tcfg = tgram.KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    jp = jgram.KernelParams(jnp.asarray(log_ls), jnp.asarray(log_noise), jnp.asarray(log_const))
    tp = tgram.KernelParams(t64(log_ls), t64(log_noise), t64(log_const))

    def jv(fn):
        return np.asarray(jax.vmap(fn)(jp))

    def close(actual, desired):
        np.testing.assert_allclose(to_np(actual), desired, rtol=1e-12, atol=1e-300)

    D2 = tgram.pairwise_sqdiff(t64(X1))
    close(D2, np.asarray(jgram.pairwise_sqdiff(jnp.asarray(X1))))
    sq = rng.uniform(0, 4, (5, 5))
    close(tgram.matern_from_sqdist(t64(sq), nu), np.asarray(jgram.matern_from_sqdist(jnp.asarray(sq), nu)))
    close(tgram.train_gram(tcfg, tp, t64(X1), 1e-6),
          jv(lambda p: jgram.train_gram(jcfg, p, jnp.asarray(X1), 1e-6)))
    close(tgram.train_gram_from_sqdiff(tcfg, tp, D2, 1e-6),
          jv(lambda p: jgram.train_gram_from_sqdiff(jcfg, p, jnp.asarray(to_np(D2)), 1e-6)))
    close(tgram.cross_covariance(tcfg, tp, t64(X1), t64(X2)),
          jv(lambda p: jgram.cross_covariance(jcfg, p, jnp.asarray(X1), jnp.asarray(X2))))
    close(tgram.prior_variance(tcfg, tp), jv(lambda p: jgram.prior_variance(jcfg, p)))


def _spd(rng, B, N):
    A = rng.normal(size=(B, N, N))
    return A @ np.swapaxes(A, -1, -2) / N + 2.0 * np.eye(N)


@pytest.mark.parametrize("B,N", [(3, 64), (2, 200)])
def test_blocked_chol_inv_matches_jax_pallas_kernel(B, N):
    """Blocked inverse and half log-det against JAX's blocked_chol_inv running
    its Pallas diagonal kernel in interpret mode (tolerance as
    test_blocked_cholesky.py: both are float64 factorisations of SPD input)."""
    K = _spd(np.random.default_rng(7), B, N)
    j_invL, j_hld = jbc.blocked_chol_inv(jnp.asarray(K), interpret=True)
    invL, hld = tbc.blocked_chol_inv(t64(K))
    np.testing.assert_allclose(to_np(invL), np.asarray(j_invL), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(to_np(hld), np.asarray(j_hld), rtol=1e-9, atol=1e-10)
    # leading batch dimensions fold into one batch
    invL2, hld2 = tbc.chol_inv_batched(t64(K).reshape(1, B, N, N))
    np.testing.assert_array_equal(to_np(invL2[0]), to_np(invL))
    np.testing.assert_array_equal(to_np(hld2[0]), to_np(hld))


def test_diag_chol_inv_plain_matches_jax_pallas_kernel():
    """The plain version of kernel K3: row-major L and L^-1 of 64 x 64 blocks."""
    A = _spd(np.random.default_rng(3), 5, tbc.NB)
    jL, jinv = jbc._diag_chol_inv(jnp.asarray(A), interpret=True)
    L, inv = tbc.diag_chol_inv(t64(A))
    np.testing.assert_allclose(to_np(L), np.asarray(jL), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(to_np(inv), np.asarray(jinv), rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(to_np(torch.triu(L, 1)), 0.0)
    np.testing.assert_array_equal(to_np(torch.triu(inv, 1)), 0.0)


def test_diag_chol_inv_non_spd_gives_nan():
    """A block that is not positive definite gives NaN (the GP fit's guard
    turns a NaN LML into +inf); its neighbours are untouched."""
    A = _spd(np.random.default_rng(4), 3, 16)
    A[1] = -A[1]
    L, inv = tbc.diag_chol_inv(t64(A))
    assert torch.isnan(L[1]).all() and torch.isnan(inv[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(inv[[0, 2]]).all()


def _mvn_operands(rng, n_obs, nb, k, W):
    U = rng.normal(size=(n_obs, nb, k)) * 0.3
    A = rng.normal(size=(n_obs, nb, nb)) * 0.2
    D = A @ np.swapaxes(A, -1, -2) + np.eye(nb) * 0.5
    d0 = rng.normal(size=(n_obs, nb))
    z = rng.normal(size=(W, k))
    v = rng.uniform(0.01, 0.5, size=(W, k))
    return U, D, d0, z, v


@pytest.mark.parametrize("n_obs,nb,W", [(5, 8, 50), (3, 24, 50), (4, 16, 100)])
def test_fused_block_mvn_plain_matches_jax(n_obs, nb, W):
    """The plain version of kernel K1 against JAX's fused kernel in interpret
    mode (the packed kernel at W <= 64, the lane kernel above) and against
    JAX's composed path, at rtol 1e-8 (float64 throughout)."""
    ops = _mvn_operands(np.random.default_rng(5), n_obs, nb, 6, W)
    ours = to_np(tmvn.fused_block_mvn_loglike(*map(t64, ops)))
    jops = [jnp.asarray(x) for x in ops]
    pallas = np.asarray(jmvn.fused_block_mvn_loglike(*jops, interpret=True, dot_mode="highest"))
    composed = np.asarray(jmvn.fused_block_mvn_loglike(*jops))
    assert ours.shape == (W,)
    np.testing.assert_allclose(ours, pallas, rtol=1e-8)
    np.testing.assert_allclose(ours, composed, rtol=1e-8)


def test_fused_block_mvn_wide_blocks_take_dense_path():
    """Blocks wider than the kernel's 48 rows go to the dense path, as in JAX."""
    ops = _mvn_operands(np.random.default_rng(6), 2, 56, 4, 3)
    ours = to_np(tmvn.fused_block_mvn_loglike(*map(t64, ops)))
    ref = np.asarray(jmvn.fused_block_mvn_loglike(*[jnp.asarray(x) for x in ops]))
    np.testing.assert_allclose(ours, ref, rtol=1e-8)


@pytest.mark.parametrize("n", [8, 40])
def test_mvn_loglike_dense_matches_scipy(n):
    """Both branches of the dense MVN (unrolled <= 32, library above)."""
    from scipy.stats import multivariate_normal

    rng = np.random.default_rng(n)
    A = rng.normal(size=(3, n, n))
    C = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
    dY = rng.normal(size=(3, n))
    const = -0.5 * n * np.log(2 * np.pi)
    ref = [multivariate_normal(np.zeros(n), C[i]).logpdf(dY[i]) - const for i in range(3)]
    np.testing.assert_allclose(to_np(mvn_loglike_dense(t64(dY), t64(C))), ref, rtol=1e-10)
    if n <= 32:
        np.testing.assert_allclose(to_np(tiny_mvn_loglike(t64(dY), t64(C))), ref, rtol=1e-10)


def test_kernel_wrappers_reject_other_devices():
    """A wrapper takes the plain version only for CPU tensors; any other
    device that is not CUDA is refused, never silently computed."""
    A = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbc.diag_chol_inv(A)
    ops = [torch.empty(s, device="meta") for s in ((2, 8, 3), (2, 8, 8), (2, 8), (4, 3), (4, 3))]
    with pytest.raises(ValueError, match="unsupported device"):
        tmvn.fused_block_mvn_loglike(*ops)
