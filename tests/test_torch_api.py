"""Port parity of the public functions the port took over last: the single-GP
API (LML, posterior, predict), ``pack_params``, the one-step and whole-run
sampler calls, and the table and artifact I/O, each against the JAX package
on the same numpy inputs made from a seed (float64 on the CPU; rtol 1e-10
unless the test says otherwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gp import KERNEL_CONFIGS, _stack
from torch_parity import t64, to_np

from bayesian_inference_tpu.io import hdf5 as jhdf5
from bayesian_inference_tpu.io import observables as jobs
from bayesian_inference_tpu.mcmc import stretch as jstretch
from bayesian_inference_tpu.models import gp as jgp
from bayesian_inference_tpu.models import gp_fit as jfit
from bayesian_inference_tpu_torch.io import hdf5 as thdf5
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.mcmc import stretch as tstretch
from bayesian_inference_tpu_torch.models import gp as tgp
from bayesian_inference_tpu_torch.models import gp_fit as tfit
from bayesian_inference_tpu_torch.ops import gram as tgram

JITTER = 1e-8


def _one(params, i):
    """GP ``i`` of a stacked JAX KernelParams."""
    return jax.tree.map(lambda a: a[i], params)


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS)
def test_log_marginal_likelihood_matches_jax(nu, with_constant):
    """log_marginal_likelihood (from X) and log_marginal_likelihood_sqdiff
    (from pairwise_sqdiff(X)), for one GP and for the stack, against JAX's
    library-Cholesky forms per GP (rtol 1e-10)."""
    jcfg, tcfg, jp, raw, X, Y = _stack(nu, with_constant)
    D2 = tgram.pairwise_sqdiff(t64(X))
    ref = np.array([float(jgp.log_marginal_likelihood(jcfg, _one(jp, i), jnp.asarray(X), jnp.asarray(Y[i]), JITTER))
                    for i in range(Y.shape[0])])
    ref_sq = np.array([float(jgp.log_marginal_likelihood_sqdiff(jcfg, _one(jp, i), jnp.asarray(np.asarray(D2)),
                                                                jnp.asarray(Y[i]), JITTER))
                       for i in range(Y.shape[0])])
    stacked = tgram.KernelParams(*map(t64, raw))
    np.testing.assert_allclose(to_np(tgp.log_marginal_likelihood(tcfg, stacked, t64(X), t64(Y), JITTER)), ref,
                               rtol=1e-10)
    np.testing.assert_allclose(to_np(tgp.log_marginal_likelihood_sqdiff(tcfg, stacked, D2, t64(Y), JITTER)), ref_sq,
                               rtol=1e-10)
    single = tgram.KernelParams(*(t64(x[1]) for x in raw))
    one = tgp.log_marginal_likelihood(tcfg, single, t64(X), t64(Y[1]), JITTER)
    assert one.shape == ()
    np.testing.assert_allclose(float(one), ref[1], rtol=1e-10)


@pytest.mark.parametrize("nu,with_constant", KERNEL_CONFIGS[1:3])
def test_posterior_from_params_and_predict_match_jax(nu, with_constant):
    """posterior_from_params of one GP (alpha rtol 1e-9, K^-1 rtol 1e-8 atol
    1e-10: the blocked factorisation against JAX's library Cholesky), then
    predict of that GP and predict_all of the stack against JAX's predict
    and predict_all on JAX's posteriors (rtol 1e-8 on the mean; the variance
    k** - k*^T K^-1 k* cancels, atol 1e-10)."""
    jcfg, tcfg, jp, raw, X, Y = _stack(nu, with_constant, N=40, seed=2)
    theta = np.random.default_rng(3).uniform(0.0, 1.0, (7, X.shape[1]))
    jposts = jax.vmap(lambda p, y: jgp.posterior_from_params(jcfg, p, jnp.asarray(X), y, JITTER))(jp, jnp.asarray(Y))

    single = tgram.KernelParams(*(t64(x[0]) for x in raw))
    post = tgp.posterior_from_params(tcfg, single, t64(X), t64(Y[0]), JITTER)
    jpost = _one(jposts, 0)
    assert post.alpha.shape == (40,) and post.Kinv.shape == (40, 40) and post.prior_var.shape == ()
    np.testing.assert_allclose(to_np(post.alpha), np.asarray(jpost.alpha), rtol=1e-9)
    np.testing.assert_allclose(to_np(post.Kinv), np.asarray(jpost.Kinv), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(post.lml), float(jpost.lml), rtol=1e-10)
    np.testing.assert_allclose(float(post.prior_var), float(jpost.prior_var), rtol=1e-12)

    mean, var = tgp.predict(tcfg, post, t64(theta))
    jmean, jvar = jgp.predict(jcfg, jpost, jnp.asarray(theta))
    assert mean.shape == var.shape == (7,)
    np.testing.assert_allclose(to_np(mean), np.asarray(jmean), rtol=1e-8)
    np.testing.assert_allclose(to_np(var), np.asarray(jvar), rtol=1e-8, atol=1e-10)

    posts = tgp.posterior_from_params(tcfg, tgram.KernelParams(*map(t64, raw)), t64(X), t64(Y), JITTER)
    mean_all, var_all = tgp.predict_all(tcfg, posts, t64(theta))
    jmean_all, jvar_all = jgp.predict_all(jcfg, jposts, jnp.asarray(theta))
    assert mean_all.shape == var_all.shape == (7, Y.shape[0])
    np.testing.assert_allclose(to_np(mean_all), np.asarray(jmean_all), rtol=1e-8)
    np.testing.assert_allclose(to_np(var_all), np.asarray(jvar_all), rtol=1e-8, atol=1e-10)
    shared = tgp.predict_all_shared(tcfg, posts, t64(theta))
    np.testing.assert_allclose(to_np(mean_all), to_np(shared[0]), rtol=1e-10)
    np.testing.assert_allclose(to_np(var_all), to_np(shared[1]), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("with_noise,with_constant", [(True, False), (True, True), (False, True), (False, False)])
def test_pack_params_matches_jax_and_inverts_unpack(with_noise, with_constant):
    """pack_params in sklearn's theta order equals JAX's per GP, and
    unpack_params undoes it on the active fields."""
    rng = np.random.default_rng(4)
    raw = (rng.normal(size=(3, 5)), rng.normal(size=3), rng.normal(size=3))
    jcfg = jgp.KernelConfig(nu=1.5, with_noise=with_noise, with_constant=with_constant)
    tcfg = tgram.KernelConfig(nu=1.5, with_noise=with_noise, with_constant=with_constant)
    flat = tfit.pack_params(tcfg, tgram.KernelParams(*map(t64, raw)))
    assert flat.shape == (3, 5 + with_noise + with_constant)
    for i in range(3):
        jp = jgp.KernelParams(*(jnp.asarray(x[i]) for x in raw))
        np.testing.assert_array_equal(to_np(flat[i]), np.asarray(jfit.pack_params(jcfg, jp)))
    back = tfit.unpack_params(tcfg, flat, 5)
    np.testing.assert_array_equal(to_np(back.log_length_scale), raw[0])
    if with_noise:
        np.testing.assert_array_equal(to_np(back.log_noise), raw[1])
    if with_constant:
        np.testing.assert_array_equal(to_np(back.log_constant), raw[2])


def _gaussian_logp(mu, prec):
    """The same correlated Gaussian log-density for both packages."""
    def jfn(x):
        r = x - jnp.asarray(mu)
        return -0.5 * jnp.einsum("wi,ij,wj->w", r, jnp.asarray(prec), r)

    def tfn(x):
        r = x - t64(mu)
        return -0.5 * torch.einsum("wi,ij,wj->w", r, t64(prec), r)

    return jfn, tfn


def _target(d=4, W=10, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    return rng.normal(size=d), A @ A.T + np.eye(d), rng.normal(size=(W, d))


def test_step_matches_jax_under_injected_draws():
    """One ensemble step: JAX's ``step`` draws its permutation, stretch
    factors, partners and accept draws from splits of the state's key; the
    same draws, taken from the same splits, injected into the port's
    ``step`` give the same state (rtol 1e-12) and the same accept decisions.
    With a generator the port's step is a valid move: log-probs consistent
    with the positions."""
    mu, prec, x0 = _target()
    jfn, tfn = _gaussian_logp(mu, prec)
    W, half = x0.shape[0], x0.shape[0] // 2
    key = jax.random.key(11)
    jstate = jstretch.init_state(key, jfn, jnp.asarray(x0))
    jnew = jstretch.step(jstate, jfn)

    _, k_perm, k_h0, k_h1 = jax.random.split(key, 4)
    perm = np.asarray(jax.random.permutation(k_perm, W))
    halves = []
    for k_h in (k_h0, k_h1):
        k_z, k_pair, k_acc = jax.random.split(k_h, 3)
        halves.append((np.asarray(jax.random.uniform(k_z, (half,), dtype=jnp.float64)),
                       np.asarray(jax.random.randint(k_pair, (half,), 0, half)),
                       np.asarray(jax.random.uniform(k_acc, (half,), dtype=jnp.float64))))
    rands = {"perm": torch.tensor(perm), "inv": torch.tensor(np.argsort(perm)),
             "u_z": t64(np.stack([h[0] for h in halves])),
             "partners": torch.tensor(np.stack([h[1] for h in halves])),
             "u_acc": t64(np.stack([h[2] for h in halves]))}
    state = tstretch.init_state(tfn, t64(x0))
    new = tstretch.step(state, tfn, rands=rands)
    np.testing.assert_allclose(to_np(new.coords), np.asarray(jnew.coords), rtol=1e-12)
    np.testing.assert_allclose(to_np(new.log_prob), np.asarray(jnew.log_prob), rtol=1e-12)
    np.testing.assert_array_equal(to_np(new.n_accepted), np.asarray(jnew.n_accepted))
    assert 0 < int(new.n_accepted.sum()) <= W

    drawn = tstretch.step(state, tfn, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(to_np(drawn.log_prob), to_np(tfn(drawn.coords)), rtol=1e-12)
    with pytest.raises(ValueError, match="generator or injected draws"):
        tstretch.step(state, tfn)


def test_run_ensemble_matches_jax_under_injected_draws():
    """The whole-run call: JAX's run_ensemble(key, ...) pregenerates the
    draws of its one chunk from the key; the port fed those draws returns
    the same chain, log-probs (rtol 1e-12), acceptance trace and fraction
    (rtol 1e-15), in one chunk and in chunks of 5. With a generator, chunking changes
    nothing but the stream; an odd walker count and a chunk size that does
    not divide the run are refused."""
    mu, prec, x0 = _target(seed=6)
    jfn, tfn = _gaussian_logp(mu, prec)
    n, W = 20, x0.shape[0]
    key = jax.random.key(12)
    ref = jstretch.run_ensemble(key, jfn, jnp.asarray(x0), n)
    rands = {k: torch.tensor(np.asarray(v)) for k, v in jstretch._pregen_rands(key, n, W, jnp.float64, True)[0].items()}
    for chunk_size in (None, 5):
        out = tstretch.run_ensemble(tfn, t64(x0), n, rands=rands, chunk_size=chunk_size)
        assert sorted(out) == sorted(k for k in ref if k != "key")
        for name in ("chain", "log_prob", "coords", "final_log_prob"):
            np.testing.assert_allclose(to_np(out[name]), np.asarray(ref[name]), rtol=1e-12, err_msg=name)
        # counts over W and over n: XLA may multiply by the reciprocal, one ulp apart
        np.testing.assert_allclose(to_np(out["acceptance_trace"]), np.asarray(ref["acceptance_trace"]), rtol=1e-15)
        np.testing.assert_allclose(to_np(out["acceptance_fraction"]), np.asarray(ref["acceptance_fraction"]),
                                   rtol=1e-15)
    drawn = tstretch.run_ensemble(tfn, t64(x0), n, generator=torch.Generator().manual_seed(1), chunk_size=10)
    assert drawn["chain"].shape == (n, W, x0.shape[1]) and 0.0 < float(drawn["acceptance_fraction"].mean()) < 1.0
    with pytest.raises(ValueError, match="must divide"):
        tstretch.run_ensemble(tfn, t64(x0), n, rands=rands, chunk_size=6)
    with pytest.raises(ValueError, match="even"):
        tstretch.run_ensemble(tfn, t64(x0[:-1]), n, rands=rands)


def test_append_time_series_round_trip_matches_jax(tmp_path):
    """append_time_series: the same slabs appended by both packages (three
    appends, then a truncating one) read back as equal arrays, through either
    package's reader; the returned lengths agree."""
    rng = np.random.default_rng(7)
    slabs = [{"chain": rng.normal(size=(n, 4, 3)), "log_prob": rng.normal(size=(n, 4))} for n in (5, 2, 6)]
    lengths = {"t": [], "j": []}
    for s in slabs:
        lengths["t"].append(thdf5.append_time_series(str(tmp_path / "t"), "series.h5", s))
        lengths["j"].append(jhdf5.append_time_series(str(tmp_path / "j"), "series.h5", s))
    tail = {"chain": rng.normal(size=(3, 4, 3)), "log_prob": rng.normal(size=(3, 4))}
    lengths["t"].append(thdf5.append_time_series(str(tmp_path / "t"), "series.h5", tail, truncate_to=7))
    lengths["j"].append(jhdf5.append_time_series(str(tmp_path / "j"), "series.h5", tail, truncate_to=7))
    assert lengths["t"] == lengths["j"] == [5, 7, 13, 10]
    ours = thdf5.read_dict_from_h5(str(tmp_path / "t"), "series.h5", verbose=False)
    ref = jhdf5.read_dict_from_h5(str(tmp_path / "j"), "series.h5", verbose=False)
    cross = jhdf5.read_dict_from_h5(str(tmp_path / "t"), "series.h5", verbose=False)
    expected = np.concatenate([slabs[0]["chain"], slabs[1]["chain"], tail["chain"]])
    for key in ("chain", "log_prob"):
        np.testing.assert_array_equal(ours[key], ref[key])
        np.testing.assert_array_equal(cross[key], ref[key])
    np.testing.assert_array_equal(ours["chain"], expected)


def test_time_series_length_matches_jax(tmp_path):
    """time_series_length: 0 for a missing file or dataset, else the length,
    as JAX's reads it from the port's file."""
    assert thdf5.time_series_length(str(tmp_path), "none.h5", "chain") == 0
    thdf5.append_time_series(str(tmp_path), "series.h5", {"chain": np.zeros((4, 2))})
    thdf5.append_time_series(str(tmp_path), "series.h5", {"chain": np.ones((3, 2))})
    for module in (thdf5, jhdf5):
        assert module.time_series_length(str(tmp_path), "series.h5", "chain") == 7
        assert module.time_series_length(str(tmp_path), "series.h5", "log_prob") == 0


@pytest.fixture(scope="module")
def fixture_observables():
    from pathlib import Path

    data_dir = Path(__file__).resolve().parent / "test_data"
    return str(data_dir), tobs.read_observables(str(data_dir), "observables.h5")


def test_data_dict_from_h5_matches_jax(fixture_observables, tmp_path):
    """data_dict_from_h5 from the file and from the pre-read dict equals
    JAX's; with a table directory it checks the tables (made here from the
    dict), and a table that differs raises."""
    data_dir, observables = fixture_observables
    ref = jobs.data_dict_from_h5(data_dir, "observables.h5")
    for ours in (tobs.data_dict_from_h5(data_dir, "observables.h5"),
                 tobs.data_dict_from_h5("", "", observables=observables)):
        assert sorted(ours) == sorted(ref)
        for label in ref:
            for key in ref[label]:
                np.testing.assert_array_equal(ours[label][key], ref[label][key])
    (tmp_path / "Data").mkdir()
    for label, entry in ref.items():
        table = np.column_stack([np.atleast_1d(entry[k]) for k in ("xmin", "xmax", "y", "y_err")])
        np.savetxt(tmp_path / "Data" / f"Data__{label}.dat", table)
    checked = tobs.data_dict_from_h5(data_dir, "observables.h5", observable_table_dir=str(tmp_path))
    assert sorted(checked) == sorted(jobs.data_dict_from_h5(data_dir, "observables.h5", str(tmp_path)))
    label = next(iter(ref))
    table = np.loadtxt(tmp_path / "Data" / f"Data__{label}.dat", ndmin=2)
    table[0, 2] += 1.0
    np.savetxt(tmp_path / "Data" / f"Data__{label}.dat", table)
    with pytest.raises(ValueError, match="differs from its table"):
        tobs.data_dict_from_h5(data_dir, "observables.h5", observable_table_dir=str(tmp_path))


@pytest.mark.parametrize("filtered", [False, True])
def test_observable_dict_and_matrix_round_trip_match_jax(fixture_observables, filtered):
    """observable_dict_from_matrix on the stacked prediction matrix and a
    random covariance gives JAX's per-observable blocks (equal arrays, same
    label order), observable_matrix_from_dict re-stacks them to the matrix
    and to JAX's, and a matrix of another width is refused."""
    data_dir, observables = fixture_observables
    kw = {}
    if filtered:
        kw = {"observable_filter": tobs.ObservableFilter(include_list=["pt_ch"])}
    jkw = {"observable_filter": jobs.ObservableFilter(include_list=["pt_ch"])} if filtered else {}
    Y = tobs.predictions_matrix_from_h5(data_dir, "observables.h5", observables=observables, **kw)
    rng = np.random.default_rng(8)
    cov = rng.normal(size=(Y.shape[0], Y.shape[1], Y.shape[1]))
    ours = tobs.observable_dict_from_matrix(Y, observables, cov=cov, **kw)
    ref = jobs.observable_dict_from_matrix(Y, observables, cov=cov, **jkw)
    assert list(ours["central_value"]) == list(ref["central_value"]) and list(ours["cov"]) == list(ref["cov"])
    for kind in ("central_value", "cov"):
        for label in ref[kind]:
            np.testing.assert_array_equal(ours[kind][label], ref[kind][label])
    assert "cov" not in tobs.observable_dict_from_matrix(Y, observables, cov=np.zeros(0), **kw)
    np.testing.assert_array_equal(tobs.observable_matrix_from_dict(ours), Y)
    np.testing.assert_array_equal(tobs.observable_matrix_from_dict(ours), jobs.observable_matrix_from_dict(ref))
    diag = {"cov": {k: np.einsum("sii->si", v) for k, v in ours["cov"].items()}}
    np.testing.assert_array_equal(tobs.observable_matrix_from_dict(diag, "cov"),
                                  jobs.observable_matrix_from_dict(diag, "cov"))
    with pytest.raises(ValueError, match="bin count mismatch"):
        tobs.observable_dict_from_matrix(Y[:, :-1], observables, **kw)


# The stretch move's options, one at a time and all together.
OPTION_CASES = {
    "a": {"a": 1.5},
    "fixed_split": {"randomize_split": False},
    "thin": {"thin": 4},
    "no_chain": {"store_chain": False},
    "all": {"a": 1.5, "randomize_split": False, "thin": 4, "store_chain": False},
}


def _jax_draws(key, n, W, randomize_split):
    rands, _ = jstretch._pregen_rands(key, n, W, jnp.float64, randomize_split)
    return {k: np.asarray(v) for k, v in rands.items()}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_run_ensemble_and_run_chunk_options_match_jax(case):
    """run_ensemble and run_chunk with ``a``, ``randomize_split``, ``thin``
    and ``store_chain`` against JAX's, the draws of JAX's default
    (pregenerated) stream injected: chain, log-probs, acceptance trace and
    fraction and the final state to 1e-10; without a chain the result holds
    none; a ``thin`` that does not divide the run is refused."""
    options = OPTION_CASES[case]
    mu, prec, x0 = _target(seed=13)
    jfn, tfn = _gaussian_logp(mu, prec)
    n, W = 24, x0.shape[0]
    key = jax.random.key(14)
    ref = jstretch.run_ensemble(key, jfn, jnp.asarray(x0), n, **options)
    rands = {k: torch.tensor(v) for k, v in _jax_draws(key, n, W, options.get("randomize_split", True)).items()}
    out = tstretch.run_ensemble(tfn, t64(x0), n, rands=rands, **options)
    assert sorted(out) == sorted(k for k in ref if k != "key")
    assert ("chain" in out) == options.get("store_chain", True)
    assert out["acceptance_trace"].shape == (n // options.get("thin", 1),)
    for name in sorted(out):
        np.testing.assert_allclose(to_np(out[name]), np.asarray(ref[name]), rtol=1e-10, err_msg=name)

    state, ys = tstretch.run_chunk(tstretch.init_state(tfn, t64(x0)), tfn, n, rands=rands, **options)
    jstate, jys = jstretch.run_chunk(jstretch.init_state(key, jfn, jnp.asarray(x0)), jfn, n, **options)
    for ours, theirs in zip(state, jstate[:3]):
        np.testing.assert_allclose(to_np(ours), np.asarray(theirs), rtol=1e-10)
    if options.get("store_chain", True):
        for ours, theirs in zip(ys, jys):
            np.testing.assert_allclose(to_np(ours), np.asarray(theirs), rtol=1e-10)
    else:
        np.testing.assert_allclose(to_np(ys), np.asarray(jys), rtol=1e-10)
    with pytest.raises(ValueError, match="thin 5 must divide"):
        tstretch.run_chunk(state, tfn, n, rands=rands, thin=5)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_run_chunk_batched_options_match_jax(case):
    """run_chunk_batched over three points (each its own target mean and its
    own key) with the same option cases against JAX's vmapped chunk under its
    injected draws: final positions, log-probs and acceptance counts, and
    the chain and log-probs where stored, to 1e-10; the port's acceptance
    trace sums to the counts."""
    options = OPTION_CASES[case]
    mu, prec, x0 = _target(seed=15)
    P, (W, d), n = 3, x0.shape, 16
    rng = np.random.default_rng(16)
    mus = mu + rng.normal(size=(P, d))
    x0s = x0 + rng.normal(size=(P, W, d))

    def jfn(mu_p, x):
        r = x - mu_p
        return -0.5 * jnp.einsum("wi,ij,wj->w", r, jnp.asarray(prec), r)

    def tfn(x):  # (P, w, d) -> (P, w)
        r = x - t64(mus)[:, None, :]
        return -0.5 * torch.einsum("pwi,ij,pwj->pw", r, t64(prec), r)

    keys = jax.vmap(jax.random.key)(jnp.arange(20, 20 + P))
    jstates = jstretch.init_state_batched(keys, jfn, jnp.asarray(x0s), jnp.asarray(mus))
    jfinal, jys = jstretch.run_chunk_batched(jstates, jfn, jnp.asarray(mus), n, **options)
    per_point = [_jax_draws(keys[p], n, W, options.get("randomize_split", True)) for p in range(P)]
    rands = {k: torch.tensor(np.stack([r[k] for r in per_point], axis=1)) for k in per_point[0]}

    final, ys = tstretch.run_chunk_batched(tstretch.init_state_batched(tfn, t64(x0s)), tfn, n, rands=rands, **options)
    for ours, theirs in zip(final, jfinal[:3]):
        np.testing.assert_allclose(to_np(ours), np.asarray(theirs), rtol=1e-10)
    if options.get("store_chain", True):
        chain, log_prob, acc = ys
        assert chain.shape == (n // options.get("thin", 1), P, W, d)
        np.testing.assert_allclose(to_np(chain), np.asarray(jys[0]), rtol=1e-10)
        np.testing.assert_allclose(to_np(log_prob), np.asarray(jys[1]), rtol=1e-10)
    else:
        assert jys is None
        acc = ys
    assert acc.shape == (n // options.get("thin", 1), P)
    np.testing.assert_allclose(to_np(acc.sum(dim=0)) * W, to_np(final.n_accepted.sum(dim=-1)), rtol=1e-12)


def test_step_options_match_jax():
    """``step`` with ``a`` under JAX's injected draws (rtol 1e-12), and with
    ``randomize_split=False`` from a generator: the identity split, so the
    first half's proposals come from the second half's walkers in order."""
    mu, prec, x0 = _target(seed=17)
    jfn, tfn = _gaussian_logp(mu, prec)
    W = x0.shape[0]
    key = jax.random.key(18)
    rands = {k: torch.tensor(v[0]) for k, v in _jax_draws(key, 1, W, False).items()}
    jstate = jstretch.init_state(key, jfn, jnp.asarray(x0))
    jnew = jstretch._step_with_rands(jstate, {k: jnp.asarray(v.numpy()) for k, v in rands.items()}, jfn, a=1.3)
    state = tstretch.init_state(tfn, t64(x0))
    new = tstretch.step(state, tfn, rands=rands, a=1.3)
    np.testing.assert_allclose(to_np(new.coords), np.asarray(jnew.coords), rtol=1e-12)
    np.testing.assert_array_equal(to_np(new.n_accepted), np.asarray(jnew.n_accepted))
    drawn = tstretch.pregen_rands(3, W, torch.Generator().manual_seed(0), torch.float64, randomize_split=False)
    assert torch.equal(drawn["perm"], torch.arange(W).expand(3, W)) and torch.equal(drawn["inv"], drawn["perm"])
    fixed = tstretch.step(state, tfn, generator=torch.Generator().manual_seed(0), randomize_split=False)
    np.testing.assert_allclose(to_np(fixed.log_prob), to_np(tfn(fixed.coords)), rtol=1e-12)


def test_pca_state_methods_match_jax():
    """PCAState.n_components, scale_features, transform, inverse_transform,
    reconstruction and the host-dict round trip against the JAX package's on
    the same fit (rtol 1e-12), with numpy leaves and with tensor leaves."""
    from bayesian_inference_tpu.models import pca as jpca
    from bayesian_inference_tpu_torch.models import pca as tpca

    rng = np.random.default_rng(19)
    Y = rng.normal(size=(30, 7)) @ rng.normal(size=(7, 7)) + rng.normal(size=7)
    jstate, jscores = jpca.fit_pca(Y)
    state, scores = tpca.fit_pca(Y)
    assert state.n_components == jstate.n_components == 7
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-12)
    on_tensors = tpca.PCAState.from_host_dict(state.to_host_dict(), device="cpu")
    assert on_tensors.components.dtype == torch.float64 and on_tensors.n_components == 7
    back = tpca.PCAState.from_host_dict(on_tensors.to_host_dict())
    for name, value in state.to_host_dict().items():
        np.testing.assert_array_equal(getattr(back, name), value)
    def host(v):
        return to_np(v) if isinstance(v, torch.Tensor) else v

    for s, arg in ((state, Y), (on_tensors, t64(Y))):
        np.testing.assert_allclose(host(s.scale_features(arg)), np.asarray(jstate.scale_features(Y)), rtol=1e-12)
        np.testing.assert_allclose(host(s.transform(arg)), np.asarray(jstate.transform(Y)), rtol=1e-10, atol=1e-12)
        Z = s.transform(arg, n_pc=3)
        np.testing.assert_allclose(host(Z), np.asarray(jstate.transform(Y, n_pc=3)), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(host(s.inverse_transform(Z)),
                                   np.asarray(jstate.inverse_transform(jstate.transform(Y, n_pc=3))), rtol=1e-10)
        np.testing.assert_allclose(host(s.reconstruction(arg, 3)), np.asarray(jstate.reconstruction(Y, 3)), rtol=1e-10)
        np.testing.assert_allclose(host(s.reconstruction(arg, 7)), Y, rtol=1e-9, atol=1e-10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpca.PCAState.from_host_dict(state.to_host_dict(), device="cuda")


def test_kernel_params_create_and_prior_variance_dtype_match_jax():
    """KernelParams.create takes natural-scale values to JAX's log-space
    parameters (rtol 1e-15), defaults to the card and raises without one;
    prior_variance(dtype=) widens the unit term as JAX's does."""
    from bayesian_inference_tpu.ops import gram as jgram

    ls = np.array([0.5, 2.0, 3.5])
    ours = tgram.KernelParams.create(ls, noise=0.25, constant=1.7, device="cpu")
    ref = jgram.KernelParams.create(ls, noise=0.25, constant=1.7)
    for name in ("log_length_scale", "log_noise", "log_constant"):
        assert getattr(ours, name).dtype == torch.float64
        np.testing.assert_allclose(to_np(getattr(ours, name)), np.asarray(getattr(ref, name)), rtol=1e-15)
    defaults = tgram.KernelParams.create(ls, device="cpu", dtype=torch.float32)
    assert defaults.log_noise.dtype == torch.float32 and float(defaults.log_noise) == float(defaults.log_constant) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgram.KernelParams.create(ls)
    cfg, jcfg = tgram.KernelConfig(1.5, True, True), jgram.KernelConfig(nu=1.5, with_noise=True, with_constant=True)
    np.testing.assert_allclose(float(tgram.prior_variance(cfg, ours)), float(jgram.prior_variance(jcfg, ref)), rtol=1e-15)
    assert tgram.prior_variance(cfg, defaults).dtype == torch.float32
    wide = tgram.prior_variance(cfg, defaults, dtype=torch.float64)
    assert wide.dtype == torch.float64
    np.testing.assert_allclose(float(wide), float(jgram.prior_variance(jcfg, jgram.KernelParams.create(ls), jnp.float64)),
                               rtol=1e-7)


def test_warm_fft_plans_runs_and_changes_no_result():
    """warm_fft_plans at a capped and an uncapped length runs, and the
    estimates before and after it are the same arrays."""
    from bayesian_inference_tpu_torch.mcmc import stats as tstats

    rng = np.random.default_rng(21)
    chain = np.cumsum(rng.normal(size=(400, 6, 2)), axis=0) * 0.05 + rng.normal(size=(400, 6, 2))
    before = tstats.integrated_time(chain, quiet=True)
    power = tstats.device_mean_power(torch.tensor(chain))
    assert tstats.warm_fft_plans(400) is None and tstats.warm_fft_plans(2 * tstats._ACF_MAX_LAG) is None
    np.testing.assert_array_equal(tstats.integrated_time(chain, quiet=True), before)
    np.testing.assert_array_equal(tstats.device_mean_power(torch.tensor(chain))[0], power[0])
