"""Port parity of the device ops: GP kernels, kernel K3's blocked Cholesky
inverse, kernel K1's fused block-MVN log-likelihood, kernel K4's tiny-MVN
log-likelihood (plain versions) and the Woodbury likelihood, each against the
JAX package on the same float64 inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t64, to_np

from bayesian_inference_tpu.ops import blocked_cholesky as jbc
from bayesian_inference_tpu.ops import gram as jgram
from bayesian_inference_tpu.ops import mvn as jwood
from bayesian_inference_tpu.ops import pallas_mvn as jmvn
from bayesian_inference_tpu_torch.ops import blocked_cholesky as tbc
from bayesian_inference_tpu_torch.ops import fused_mvn as tmvn
from bayesian_inference_tpu_torch.ops import gram as tgram
from bayesian_inference_tpu_torch.ops import mvn as twood
from bayesian_inference_tpu_torch.ops import tiny_mvn
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


def test_fused_block_mvn_plain_per_point_offsets_match_per_point_calls():
    """K1's plain version with one d0 table per point (walkers point-major)
    equals one call per point, at rtol 1e-12 (float64)."""
    P, Wh = 3, 5
    U, D, _, z, v = _mvn_operands(np.random.default_rng(12), 4, 8, 6, P * Wh)
    d0 = np.random.default_rng(13).normal(size=(P, 4, 8))
    ours = to_np(tmvn.fused_block_mvn_loglike(*map(t64, (U, D, d0, z, v))))
    per_point = np.concatenate([
        to_np(tmvn.fused_block_mvn_loglike(*map(t64, (U, D, d0[p], z[p * Wh:(p + 1) * Wh], v[p * Wh:(p + 1) * Wh]))))
        for p in range(P)
    ])
    np.testing.assert_allclose(ours, per_point, rtol=1e-12)


def _production_buckets(rng, W, n_points, k=41):
    """Bucketed operands shaped like the production likelihood (block widths
    1-8 / 9-16 / 17-24 over 40 / 96 / 8 observables, padded into nb 8 / 16 /
    24 buckets by the likelihood's own bucketize_blocks), with one d0 table
    per point when ``n_points``."""
    from bayesian_inference_tpu_torch.mcmc.likelihood import bucketize_blocks

    widths = [*rng.integers(1, 9, 40), *rng.integers(9, 17, 96), *rng.integers(17, 25, 8)]
    U = [rng.normal(size=(w, k)) * np.exp(-np.arange(k) / 10.0) * 0.2 for w in widths]
    D = []
    for w in widths:
        A = rng.normal(size=(w, w)) * 0.05
        D.append(A @ A.T + np.diag(rng.uniform(0.005, 0.05, w)))
    d0 = [rng.normal(size=(max(n_points, 1), w)) * 0.2 for w in widths]
    Us, Ds, _ = bucketize_blocks(U, D, [x[0] for x in d0])
    per_point = [bucketize_blocks(U, D, [x[p] for x in d0])[2] for p in range(max(n_points, 1))]
    d0s = [np.stack(b) for b in zip(*per_point)] if n_points else per_point[0]
    return Us, Ds, d0s, rng.normal(size=(W, k)), rng.uniform(1e-3, 0.1, (W, k))


@pytest.mark.parametrize("n_points", [0, 3])
def test_fused_block_mvn_buckets_matches_jax_per_bucket_calls(n_points):
    """The all-bucket call (one launch on the card) against the sum of the JAX
    package's per-bucket fused_block_mvn_loglike on the production bucket mix
    at small W, with one d0 table or one per point (walkers point-major; JAX
    called per point), rtol 1e-10 (float64); and equal to the sum of the
    one-bucket calls, in bucket order."""
    Wh = 4
    W = Wh * max(n_points, 1)
    Us, Ds, d0s, z, v = _production_buckets(np.random.default_rng(14), W, n_points)
    assert [u.shape[:2] for u in Us] == [(40, 8), (96, 16), (8, 24)]
    ours = to_np(tmvn.fused_block_mvn_loglike_buckets(*(tuple(map(t64, x)) for x in (Us, Ds, d0s)), t64(z), t64(v)))
    points = [(d0s, z, v)] if not n_points else [
        ([d[p] for d in d0s], z[p * Wh:(p + 1) * Wh], v[p * Wh:(p + 1) * Wh]) for p in range(n_points)]
    ref = np.concatenate([
        sum(np.asarray(jmvn.fused_block_mvn_loglike(*map(jnp.asarray, (U, D, d0, zp, vp))))
            for U, D, d0 in zip(Us, Ds, d0p))
        for d0p, zp, vp in points
    ])
    assert ours.shape == (W,)
    np.testing.assert_allclose(ours, ref, rtol=1e-10)
    one_by_one = sum(to_np(tmvn.fused_block_mvn_loglike(t64(U), t64(D), t64(d0), t64(z), t64(v)))
                     for U, D, d0 in zip(Us, Ds, d0s))
    np.testing.assert_array_equal(ours, one_by_one)


def _capacitance_operands(rng, lead, nb):
    """Capacitance-shaped (dY, C) of the lowrank likelihood: C = G + diag(1/v)."""
    Wf = rng.normal(size=(3 * nb, nb)) * 0.3
    v = rng.uniform(0.05, 1.0, size=(*lead, nb))
    C = Wf.T @ Wf + np.einsum("...k,kj->...kj", 1.0 / v, np.eye(nb))
    return rng.normal(size=(*lead, nb)), C


@pytest.mark.parametrize("nb", [5, 41, 49, 56, 64])
def test_block_mvn_plain_matches_jax(nb):
    """The plain version of kernel K4 against JAX's block_mvn_loglike running
    its Pallas kernel in interpret mode and against its default route, at
    rtol 1e-10 (float64); above 48 (the widths the CUDA kernel took on in
    its redesign) the default route is the dense path on both sides. Leading
    batch dimensions are kept."""
    dY, C = _capacitance_operands(np.random.default_rng(nb), (2, 3), nb)
    ours = to_np(tiny_mvn.block_mvn_loglike(t64(dY), t64(C)))
    assert ours.shape == (2, 3)
    np.testing.assert_allclose(ours, to_np(tiny_mvn.block_mvn_plain(t64(dY), t64(C))), rtol=0)
    jdY, jC = jnp.asarray(dY), jnp.asarray(C)
    np.testing.assert_allclose(ours, np.asarray(jmvn.block_mvn_loglike(jdY, jC)), rtol=1e-10)
    np.testing.assert_allclose(ours, np.asarray(jmvn.block_mvn_loglike(jdY, jC, interpret=True)), rtol=1e-10)
    quad, half_logdet = tiny_mvn.mvn_terms(t64(dY), t64(C))
    np.testing.assert_allclose(to_np(-0.5 * quad - half_logdet), ours, rtol=1e-14)


def _woodbury_operands(seed, F=40, k=6, B=11):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(F, F))
    D = A @ A.T / F + 0.5 * np.eye(F)
    return D, rng.normal(size=(F, k)), rng.normal(size=F), rng.normal(size=(B, k)), rng.uniform(0.1, 2.0, (B, k))


@pytest.mark.parametrize("k", [6, 56])
def test_woodbury_matches_jax_and_dense(k):
    """build_woodbury's fields against JAX's (rtol 1e-10), woodbury_loglike
    against JAX's and against the dense MVN of C = D + U diag(v) U^T
    (rtol 1e-9, as tests/test_ops.py holds the JAX one); k = 56 PCs is a
    capacitance matrix wider than 48, which the CUDA kernel now takes."""
    D, U, d0, z, v = _woodbury_operands(21, k=k)
    twn = twood.build_woodbury(t64(D), t64(U), t64(d0))
    jwn = jwood.build_woodbury(jnp.asarray(D), jnp.asarray(U), jnp.asarray(d0))
    for name in ("b", "G", "c0", "half_logdet_D", "U", "d0", "L_D", "W"):
        np.testing.assert_allclose(to_np(getattr(twn, name)), np.asarray(getattr(jwn, name)), rtol=1e-10,
                                   atol=1e-13, err_msg=name)
    ours = to_np(twood.woodbury_loglike(twn, t64(z), t64(v)))
    np.testing.assert_allclose(ours, np.asarray(jwood.woodbury_loglike(jwn, jnp.asarray(z), jnp.asarray(v))),
                               rtol=1e-9)
    dY = d0[None, :] + z @ U.T
    covs = np.stack([D + (U * v[i]) @ U.T for i in range(len(z))])
    np.testing.assert_allclose(ours, to_np(twood.mvn_loglike_dense(t64(dY), t64(covs))), rtol=1e-9)


def test_woodbury_with_d0_matches_a_fresh_build():
    """with_d0 rebuilds (b, c0) exactly as a build from scratch does, for one
    offset and for a batch of P; the batched likelihood of (P, Wh, k) walkers
    equals each point's own."""
    D, U, d0, z, v = _woodbury_operands(22, B=8)
    d0s = np.random.default_rng(23).normal(size=(2, d0.size))
    wn = twood.build_woodbury(t64(D), t64(U), t64(d0))
    for row in d0s:
        fresh = twood.build_woodbury(t64(D), t64(U), t64(row))
        swapped = wn.with_d0(t64(row))
        for name in ("b", "c0", "d0", "G", "W", "L_D"):
            np.testing.assert_array_equal(to_np(getattr(swapped, name)), to_np(getattr(fresh, name)), err_msg=name)
    batched = wn.with_d0(t64(d0s))
    assert tuple(batched.b.shape) == (2, U.shape[1]) and tuple(batched.c0.shape) == (2,)
    ll = to_np(twood.woodbury_loglike(batched, t64(z).reshape(2, 4, -1), t64(v).reshape(2, 4, -1)))
    for p in range(2):
        single = twood.woodbury_loglike(wn.with_d0(t64(d0s[p])), t64(z[4 * p:4 * p + 4]), t64(v[4 * p:4 * p + 4]))
        np.testing.assert_allclose(ll[p], to_np(single), rtol=1e-12)


def _woodbury_to(wn, to):
    return twood.WoodburyNormal(**{f.name: getattr(wn, f.name).to(to) for f in dataclasses.fields(wn)})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k,n_points", [(6, None), (41, None), (56, None), (64, None), (41, 2)])
def test_woodbury_loglike_on_the_cpu_is_the_plain_chain(k, n_points, dtype):
    """On the CPU the fused route (up to MAX_NB PCs, no ``terms``) is the
    plain chain, bit for bit, for one offset and for per-point offsets."""
    D, U, d0, z, v = _woodbury_operands(24 + k, k=k, B=8)
    wn = twood.build_woodbury(t64(D), t64(U), t64(d0))
    z, v = t64(z), t64(v)
    if n_points:
        wn = wn.with_d0(t64(np.random.default_rng(k).normal(size=(n_points, d0.size))))
        z, v = z.reshape(n_points, -1, k), v.reshape(n_points, -1, k)
    wn = _woodbury_to(wn, dtype)
    ll = twood.woodbury_loglike(wn, z.to(dtype), v.to(dtype))
    assert ll.shape == z.shape[:-1] and ll.dtype == dtype
    assert torch.equal(ll, twood.woodbury_loglike_plain(wn, z.to(dtype), v.to(dtype)))
    assert torch.equal(ll, tiny_mvn.fused_woodbury_loglike(wn, z.to(dtype), v.to(dtype)))


def _fused_refused(*args, **kwargs):
    raise AssertionError("the fused entry was called")


@pytest.mark.parametrize("case", ["wide", "terms", "wide_meta", "terms_meta"])
def test_woodbury_loglike_routes_wide_and_custom_terms_to_the_plain_chain(monkeypatch, case):
    """Capacitance matrices wider than MAX_NB and a caller's own ``terms``
    take the plain chain whatever the device: with the fused entry patched
    to raise, the CPU result is the plain chain's, and on the meta device
    the chain's own terms function is the one called."""
    k = tiny_mvn.MAX_NB + 1 if case.startswith("wide") else 6
    D, U, d0, z, v = _woodbury_operands(25, k=k)
    wn = twood.build_woodbury(t64(D), t64(U), t64(d0))
    z, v = t64(z), t64(v)
    monkeypatch.setattr(tiny_mvn, "fused_woodbury_loglike", _fused_refused)
    calls = []

    def recorded(r, M):
        calls.append(tuple(M.shape))
        return tiny_mvn.mvn_terms_plain(r, M) if r.device.type == "cpu" else (r.sum(-1), r.sum(-1))

    terms = recorded if case.startswith("terms") else None
    if case.endswith("meta"):
        wn = _woodbury_to(wn, "meta")
        z, v = z.to("meta"), v.to("meta")
        if terms is None:
            monkeypatch.setattr(tiny_mvn, "mvn_terms", recorded)
    ll = twood.woodbury_loglike(wn, z, v, terms=terms)
    assert ll.shape == z.shape[:-1] and ll.device == z.device
    if case.endswith("meta"):
        assert calls == [(z.shape[0], k, k)]
    else:
        assert torch.equal(ll, twood.woodbury_loglike_plain(wn, z, v, terms=terms))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_woodbury_loglike_takes_the_fused_entry_up_to_max_nb(monkeypatch, device):
    """Up to MAX_NB PCs and without ``terms`` the likelihood is one call of
    the fused entry, on every device (which then routes by device)."""
    D, U, d0, z, v = _woodbury_operands(26, k=tiny_mvn.MAX_NB)
    wn = twood.build_woodbury(t64(D), t64(U), t64(d0))
    wn = _woodbury_to(wn, device)
    monkeypatch.setattr(tiny_mvn, "fused_woodbury_loglike", _fused_refused)
    with pytest.raises(AssertionError, match="fused entry"):
        twood.woodbury_loglike(wn, t64(z).to(device), t64(v).to(device))


def test_fused_woodbury_rows_follow_the_per_point_shapes():
    """The fused launch's batch and rows per b row, from the shapes that
    ``with_d0`` makes (as in test_woodbury_with_d0_matches_a_fresh_build):
    a (k,) b serves every walker, a (P, k) b the Wh walkers of its point;
    shapes the kernel does not take are refused."""
    D, U, d0, z, v = _woodbury_operands(22, B=8)
    k = U.shape[1]
    wn = twood.build_woodbury(t64(D), t64(U), t64(d0))
    batched = wn.with_d0(t64(np.random.default_rng(23).normal(size=(2, d0.size))))
    z, v = t64(z), t64(v)
    assert tiny_mvn.woodbury_rows(wn, z, v) == (8, 8)
    assert tiny_mvn.woodbury_rows(wn, z.reshape(2, 4, k), v.reshape(2, 4, k)) == (8, 8)
    assert tiny_mvn.woodbury_rows(batched, z.reshape(2, 4, k), v.reshape(2, 4, k)) == (8, 4)
    for bad_wn, bad_z, bad_v in ((batched, z, v), (batched, z.reshape(4, 2, k), v.reshape(4, 2, k)),
                                 (wn, z, v[:, :-1]), (wn, z[:, :-1], v[:, :-1]),
                                 (dataclasses.replace(batched, c0=batched.c0[:1]), z.reshape(2, 4, k),
                                  v.reshape(2, 4, k))):
        with pytest.raises(ValueError, match="shape mismatch"):
            tiny_mvn.woodbury_rows(bad_wn, bad_z, bad_v)


def test_kernel_wrappers_reject_other_devices():
    """A wrapper takes the plain version only for CPU tensors; any other
    device that is not CUDA is refused, never silently computed."""
    A = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbc.diag_chol_inv(A)
    ops = [torch.empty(s, device="meta") for s in ((2, 8, 3), (2, 8, 8), (2, 8), (4, 3), (4, 3))]
    with pytest.raises(ValueError, match="unsupported device"):
        tmvn.fused_block_mvn_loglike(*ops)
    with pytest.raises(ValueError, match="unsupported device"):
        tiny_mvn.block_mvn_loglike(torch.empty((4, 8), device="meta"), torch.empty((4, 8, 8), device="meta"))
