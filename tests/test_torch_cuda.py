"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips without
one. On a machine with a card (and without JAX, which tests/conftest.py
imports), run::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o filterwarnings=error

Tolerances are float32 ones: kernel and plain version are two f32
algorithms, each within a few ulps per operation of the exact result.
"""

import numpy as np
import pytest
import torch

from bayesian_inference_tpu_torch.ops import blocked_cholesky as bc
from bayesian_inference_tpu_torch.ops import fused_mvn, tiny_mvn

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spd(B, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 17), (300, 64), (41, 64), (123, 64), (2091, 64), (5, 60), (41, 62)])
def test_diag_chol_inv_kernel_matches_plain(device, B, n):
    """K3 at the fit's batch sizes (posterior 41, polish 123, exploration
    2,091) and at widths that are not 64, all identity-padded: n = 60 takes
    the 16-byte loads (n % 4 == 0), n = 1, 17 and 62 the scalar ones. Within
    f32 rounding of float64, zeros above the diagonal, bit-equal on repeat."""
    A64 = torch.tensor(_spd(B, n), device=device)
    A = A64.float()
    before = bc.KERNEL.launches
    L, Linv = bc.diag_chol_inv(A)
    torch.cuda.synchronize()
    assert bc.KERNEL.launches == before + 1
    L64, Linv64 = bc.diag_chol_inv_plain(A64)
    torch.testing.assert_close(L.double(), L64, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(Linv.double(), Linv64, rtol=1e-3, atol=1e-4)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Linv, 1), torch.zeros_like(Linv))
    L2, Linv2 = bc.diag_chol_inv(A)
    assert torch.equal(L, L2) and torch.equal(Linv, Linv2)


def test_diag_chol_inv_kernel_is_the_same_at_every_batch_size(device):
    """An instance's L and L^-1 do not depend on the batch it is launched in
    (the fit's polish batch against its exploration batch): the same bits."""
    A = torch.tensor(_spd(1000, 64, seed=3), device=device).float()
    L, Linv = bc.diag_chol_inv(A)
    L_small, Linv_small = bc.diag_chol_inv(A[:41].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(L[:41], L_small) and torch.equal(Linv[:41], Linv_small)


def test_block_mvn_kernel_is_the_same_at_every_batch_size(device):
    """An instance's quad and half-log-det do not depend on the batch it is
    launched in (one analysis against the closure batch), at every tile
    count the kernel is built for: the same bits."""
    for nb in (13, 41, 64):
        dY, C = (torch.tensor(x, device=device).float() for x in _capacitance(1500, nb))
        quad, hld = tiny_mvn.mvn_terms(dY, C)
        quad_s, hld_s = tiny_mvn.mvn_terms(dY[:50].contiguous(), C[:50].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(quad[:50], quad_s) and torch.equal(hld[:50], hld_s)


def test_diag_chol_inv_kernel_nan_for_non_spd(device):
    A = torch.tensor(_spd(3, 32), device=device).float()
    A[1] = -A[1]
    L, Linv = bc.diag_chol_inv(A)
    torch.cuda.synchronize()
    assert torch.isnan(L[1]).any() and torch.isnan(Linv[1]).any()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(Linv[[0, 2]]).all()


def test_blocked_chol_inv_on_card_matches_float64(device):
    """Four diagonal blocks of a 200-point gram: kernel + f32 panel matmuls."""
    K = torch.tensor(_spd(4, 200, seed=1), device=device)
    invL, hld = bc.blocked_chol_inv(K.float())
    invL64, hld64 = bc.blocked_chol_inv(K.cpu())
    torch.testing.assert_close(invL.double().cpu(), invL64, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(hld.double().cpu(), hld64, rtol=1e-5, atol=1e-5)


def _mvn(n_obs, nb, k, W, seed=2):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_obs, nb, k)) * 0.3
    A = rng.normal(size=(n_obs, nb, nb)) * 0.2
    D = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(nb)
    return U, D, rng.normal(size=(n_obs, nb)), rng.normal(size=(W, k)), rng.uniform(0.01, 0.5, (W, k))


@pytest.mark.parametrize("n_obs,nb,k,W", [(1, 1, 1, 1), (40, 8, 41, 50), (8, 24, 41, 50), (5, 48, 7, 100),
                                           (3, 16, 41, 257)])
def test_fused_block_mvn_kernel_matches_plain(device, n_obs, nb, k, W):
    ops64 = [torch.tensor(x, device=device) for x in _mvn(n_obs, nb, k, W)]
    ops = [x.float() for x in ops64]
    before = fused_mvn.KERNEL.launches
    ll = fused_mvn.fused_block_mvn_loglike(*ops)
    torch.cuda.synchronize()
    assert fused_mvn.KERNEL.launches == before + 1
    ref = fused_mvn.fused_block_mvn_plain(*ops64)
    assert ll.shape == (W,) and ll.dtype == torch.float32
    torch.testing.assert_close(ll.double(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(ll, fused_mvn.fused_block_mvn_loglike(*ops))  # deterministic


def test_fused_block_mvn_per_point_offsets_match_single_point_launches(device):
    """K1 with one d0 table per point (walkers point-major, Wh = 50 not a
    multiple of the 4 walkers of a thread block): bit-equal to one launch per
    point, and within f32 rounding of the float64 plain version."""
    P, Wh, n_obs, nb, k = 3, 50, 7, 16, 41
    U, D, _, z, v = _mvn(n_obs, nb, k, P * Wh, seed=5)
    d0 = np.random.default_rng(6).normal(size=(P, n_obs, nb))
    ops64 = [torch.tensor(x, device=device) for x in (U, D, d0, z, v)]
    U32, D32, d032, z32, v32 = (x.float() for x in ops64)
    ll = fused_mvn.fused_block_mvn_loglike(U32, D32, d032, z32, v32)
    single = torch.cat([
        fused_mvn.fused_block_mvn_loglike(U32, D32, d032[p].contiguous(), z32[p * Wh:(p + 1) * Wh].contiguous(),
                                          v32[p * Wh:(p + 1) * Wh].contiguous())
        for p in range(P)
    ])
    torch.cuda.synchronize()
    assert torch.equal(ll, single)
    ref = fused_mvn.fused_block_mvn_plain(*ops64)
    torch.testing.assert_close(ll.double(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def _buckets(widths, k, W, n_points, seed=8):
    """One bucket per width (1-5 blocks each, exactly that wide), shared z and
    v, and d0 (n_obs, nb) or (n_points, n_obs, nb) per bucket."""
    rng = np.random.default_rng(seed)
    Us, Ds, d0s = [], [], []
    for nb in widths:
        n_obs = int(rng.integers(1, 6))
        U, D, _, _, _ = _mvn(n_obs, nb, k, 1, seed=int(rng.integers(1 << 30)))
        Us.append(U)
        Ds.append(D)
        d0s.append(rng.normal(size=(n_points, n_obs, nb) if n_points > 1 else (n_obs, nb)))
    return Us, Ds, d0s, rng.normal(size=(W, k)), rng.uniform(0.01, 0.5, (W, k))


@pytest.mark.parametrize("widths,k,W,n_points", [
    ((1, 7, 8), 1, 1, 1),
    ((16, 24), 7, 31, 1),
    ((8, 16, 24), 41, 50, 1),
    ((33, 48), 7, 100, 2),
    ((7, 16, 33), 41, 1500, 30),
    ((1, 8, 16, 24, 33, 48), 41, 100, 1),
    ((8, 16, 24), 160, 50, 1),
    ((33, 48), 160, 100, 2),
    ((8, 24), 300, 50, 1),
])
def test_fused_block_mvn_buckets_kernel(device, widths, k, W, n_points):
    """K1's all-bucket launch: one launch, within the chip smoke's 1e-5 of
    max |ll| of the float64 plain version, bit-equal on repeat and to one
    launch per point, and NaN only in the walker whose covariances are not
    positive definite; at k = 160 and 300 the PCs are staged in chunks of
    128."""
    Us, Ds, d0s, z, v = _buckets(widths, k, W, n_points)
    t64 = lambda xs: tuple(torch.tensor(x, device=device) for x in xs)  # noqa: E731
    ops64 = (t64(Us), t64(Ds), t64(d0s), *t64((z, v)))
    ops = tuple(tuple(x.float() for x in o) if isinstance(o, tuple) else o.float() for o in ops64)
    before = fused_mvn.KERNEL.launches
    ll = fused_mvn.fused_block_mvn_loglike_buckets(*ops)
    torch.cuda.synchronize()
    assert fused_mvn.KERNEL.launches == before + 1
    ref = fused_mvn.fused_block_mvn_buckets_plain(*ops64)
    assert ll.shape == (W,) and ll.dtype == torch.float32 and bool(torch.isfinite(ll).all())
    assert float((ll.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(ll, fused_mvn.fused_block_mvn_loglike_buckets(*ops))

    Us32, Ds32, d0s32, z32, v32 = ops
    if n_points > 1:
        Wh = W // n_points
        single = torch.cat([
            fused_mvn.fused_block_mvn_loglike_buckets(Us32, Ds32, tuple(d[p].contiguous() for d in d0s32),
                                                      z32[p * Wh:(p + 1) * Wh].contiguous(),
                                                      v32[p * Wh:(p + 1) * Wh].contiguous())
            for p in range(n_points)
        ])
        assert torch.equal(ll, single)

    bad = W // 2
    v_bad = v32.clone()
    v_bad[bad] = -1e3 * v_bad[bad]
    ll_bad = fused_mvn.fused_block_mvn_loglike_buckets(Us32, Ds32, d0s32, z32, v_bad)
    torch.cuda.synchronize()
    others = torch.arange(W, device=device) != bad
    assert bool(torch.isnan(ll_bad[bad]))
    assert torch.equal(ll_bad[others], ll[others])


def _capacitance(B, k, seed=7):
    rng = np.random.default_rng(seed)
    Wf = rng.normal(size=(200, k)) * 0.1
    v = rng.uniform(0.01, 0.5, (B, k))
    M = Wf.T @ Wf + np.einsum("bk,kj->bkj", 1.0 / v, np.eye(k))
    return rng.normal(size=(B, k)), M


@pytest.mark.parametrize("B,nb", [(1, 1), (50, 41), (1500, 41), (7, 48), (1, 56), (50, 56), (1500, 56),
                                  (1, 64), (50, 64), (1500, 64), (9, 13), (9, 30)])
def test_block_mvn_kernel_matches_plain(device, B, nb):
    """K4 at every tile count (nb up to 16, 32, 48, 64) and at the lowrank
    batch sizes: within f32 rounding of the float64 plain version (the dense
    path above 48, as in the JAX package), bit-equal on repeat."""
    dY64, C64 = (torch.tensor(x, device=device) for x in _capacitance(B, nb))
    dY, C = dY64.float(), C64.float()
    before = tiny_mvn.KERNEL.launches
    ll = tiny_mvn.block_mvn_loglike(dY, C)
    torch.cuda.synchronize()
    assert tiny_mvn.KERNEL.launches == before + 1
    ref = tiny_mvn.block_mvn_plain(dY64, C64)
    assert ll.shape == (B,) and ll.dtype == torch.float32
    torch.testing.assert_close(ll.double(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(ll, tiny_mvn.block_mvn_loglike(dY, C))  # deterministic
    # leading batch dimensions fold into one batch
    ll2 = tiny_mvn.block_mvn_loglike(dY.reshape(1, B, nb), C.reshape(1, B, nb, nb))
    assert torch.equal(ll2[0], ll)


@pytest.mark.parametrize("nb", [41, 64])
def test_block_mvn_kernel_nan_only_in_the_non_spd_instance(device, nb):
    dY, C = (torch.tensor(x, device=device).float() for x in _capacitance(6, nb))
    C[2] = -C[2]
    ll = tiny_mvn.block_mvn_loglike(dY, C)
    torch.cuda.synchronize()
    assert torch.isnan(ll[2])
    assert torch.isfinite(ll[[0, 1, 3, 4, 5]]).all()


@pytest.mark.parametrize("k", [41, 56])
def test_woodbury_loglike_on_the_card_matches_float64(device, k):
    """A lowrank likelihood with k PCs evaluates through K4 on the card (one
    launch) and lies within the chip smoke's K4 bar of the float64 plain
    version: per walker, the error over |quad_M| / 2 + |half_logdet_M| of the
    capacitance term."""
    import dataclasses

    from bayesian_inference_tpu_torch.ops import mvn

    rng = np.random.default_rng(k)
    F, B = 300, 50
    A = rng.normal(size=(F, F))
    D = A @ A.T / F + 0.5 * np.eye(F)
    U = rng.normal(size=(F, k)) * np.exp(-np.arange(k) / 10.0) * 0.2
    z, v = rng.normal(size=(B, k)), rng.uniform(1e-3, 0.1, (B, k))
    wn64 = mvn.build_woodbury(*(torch.tensor(x) for x in (D, U, rng.normal(size=F))))
    wn = mvn.WoodburyNormal(**{f.name: getattr(wn64, f.name).float().to(device)
                               for f in dataclasses.fields(wn64)})
    before = tiny_mvn.KERNEL.launches
    ll = mvn.woodbury_loglike(wn, torch.tensor(z, device=device).float(), torch.tensor(v, device=device).float())
    torch.cuda.synchronize()
    assert tiny_mvn.KERNEL.launches == before + 1
    ll64 = mvn.woodbury_loglike(wn64, torch.tensor(z), torch.tensor(v))
    r64 = wn64.b + torch.tensor(z) @ wn64.G
    quad64, hld64 = tiny_mvn.mvn_terms_plain(r64, wn64.G + torch.diag_embed(1.0 / torch.tensor(v)))
    scale = 0.5 * quad64.abs() + hld64.abs()
    assert ll.shape == (B,) and bool(torch.isfinite(ll).all())
    assert float(((ll.double().cpu() - ll64).abs() / scale).max()) <= 1e-4


def _woodbury_case(k, B, n_points=None, seed=0, F=300):
    """A float64 Woodbury likelihood of k PCs on the CPU, with per-point
    offsets for ``n_points`` points, and the z, v of B walkers ((n_points,
    B / n_points, k) with points)."""
    from bayesian_inference_tpu_torch.ops import mvn

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(F, F))
    D = A @ A.T / F + 0.5 * np.eye(F)
    U = rng.normal(size=(F, k)) * np.exp(-np.arange(k) / 10.0) * 0.2
    wn64 = mvn.build_woodbury(*(torch.tensor(x) for x in (D, U, rng.normal(size=F))))
    shape = (B, k)
    if n_points:
        wn64 = wn64.with_d0(torch.tensor(rng.normal(size=(n_points, F))))
        shape = (n_points, B // n_points, k)
    return wn64, torch.tensor(rng.normal(size=shape)), torch.tensor(rng.uniform(1e-3, 0.1, shape))


def _woodbury_on(wn, device, dtype=torch.float32):
    import dataclasses

    from bayesian_inference_tpu_torch.ops import mvn

    return mvn.WoodburyNormal(**{f.name: getattr(wn, f.name).to(device, dtype) for f in dataclasses.fields(wn)})


def _capacitance_scale(wn64, z64, v64):
    """Per walker, |quad_M| / 2 + |half_logdet_M| of the float64 capacitance
    term: the scale the card's K4 errors are measured against."""
    k = z64.shape[-1]
    b = wn64.b if wn64.b.dim() == 1 else wn64.b[:, None, :]
    r64 = (b + z64 @ wn64.G).reshape(-1, k)
    M64 = (wn64.G + torch.diag_embed(1.0 / v64)).reshape(-1, k, k)
    quad64, hld64 = tiny_mvn.mvn_terms_plain(r64, M64)
    return (0.5 * quad64.abs() + hld64.abs()).reshape(z64.shape[:-1])


@pytest.mark.parametrize("k,B,n_points", [(41, 50, None), (41, 100, None), (56, 50, None), (56, 100, None),
                                          (64, 50, None), (64, 100, None), (41, 1500, 30)])
def test_fused_woodbury_kernel_matches_float64(device, k, B, n_points):
    """The whole Woodbury likelihood from the fused entry, one launch counted
    under its batch, against the float64 plain chain: per walker, the error
    over |quad_M| / 2 + |half_logdet_M|, its largest at most twice that of
    the plain f32 chain on the same operands (r and M in plain torch, K4's
    standalone entry for the terms) and within 1e-4; per-point b and c0 for
    30 points of 50 walkers; bit-equal on repeat and in a smaller batch."""
    import dataclasses

    from bayesian_inference_tpu_torch.ops import mvn

    wn64, z64, v64 = _woodbury_case(k, B, n_points, seed=k + B)
    wn, z, v = _woodbury_on(wn64, device), z64.float().to(device), v64.float().to(device)
    before, before_b = tiny_mvn.KERNEL.launches, tiny_mvn.KERNEL.launches_by_batch[B]
    ll = mvn.woodbury_loglike(wn, z, v)
    torch.cuda.synchronize()
    assert tiny_mvn.KERNEL.launches == before + 1 and tiny_mvn.KERNEL.launches_by_batch[B] == before_b + 1
    assert ll.shape == z.shape[:-1] and ll.dtype == torch.float32 and bool(torch.isfinite(ll).all())
    plain = mvn.woodbury_loglike_plain(wn, z, v)
    ll64 = mvn.woodbury_loglike_plain(wn64, z64, v64)
    scale = _capacitance_scale(wn64, z64, v64)
    err = float(((ll.double().cpu() - ll64).abs() / scale).max())
    err_plain = float(((plain.double().cpu() - ll64).abs() / scale).max())
    assert err <= 2 * err_plain and err <= 1e-4, (err, err_plain)
    assert torch.equal(ll, mvn.woodbury_loglike(wn, z, v))  # deterministic
    if n_points:
        part = dataclasses.replace(wn, b=wn.b[:2].contiguous(), c0=wn.c0[:2].contiguous())
        assert torch.equal(mvn.woodbury_loglike(part, z[:2].contiguous(), v[:2].contiguous()), ll[:2])
    else:
        assert torch.equal(mvn.woodbury_loglike(wn, z[:7].contiguous(), v[:7].contiguous()), ll[:7])


@pytest.mark.parametrize("k", [41, 64])
def test_fused_woodbury_kernel_nan_only_in_the_walker_whose_m_is_not_spd(device, k):
    """A walker with negative variances (M = G + diag(1/v) not positive
    definite) reads NaN; every other walker reads what it reads without it."""
    from bayesian_inference_tpu_torch.ops import mvn

    wn64, z64, v64 = _woodbury_case(k, 6, seed=3)
    wn, z, v = _woodbury_on(wn64, device), z64.float().to(device), v64.float().to(device)
    ll = mvn.woodbury_loglike(wn, z, v)
    v[2] = -v[2]
    ll_bad = mvn.woodbury_loglike(wn, z, v)
    torch.cuda.synchronize()
    others = torch.arange(6, device=device) != 2
    assert bool(torch.isnan(ll_bad[2])) and torch.equal(ll_bad[others], ll[others])


def test_lowrank_run_mcmc_takes_one_fused_launch_per_evaluation_on_the_card(card_analysis):
    """A lowrank ``run_mcmc`` on a prewarmed program: the step graph has at
    most 32 nodes (the Woodbury likelihood is one launch), and the fused
    entry counts two launches per step replayed at the half-ensemble batch
    and three at the whole ensemble (the initial states of the two burn-in
    phases and of production); K4's standalone entry never runs."""
    from bayesian_inference_tpu_torch.mcmc import runner
    from bayesian_inference_tpu_torch.mcmc.programs import prewarm_sampler_programs
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    programs = prewarm_sampler_programs(mcmc, mode="lowrank", device=device, observables=observables)
    nodes = sum(programs.graph_nodes.get(kind, 0) for kind in ("kernel", "memcpy", "memset"))
    assert 0 < nodes <= 32, programs.graph_nodes
    runner.run_mcmc(mcmc, seed=3, device=device, emulation_results=artifacts, observables=observables,
                    write=False, programs=programs, mode="lowrank")
    counters = _last_call("run_mcmc")["counters"]
    steps, W = mcmc.n_burn_steps + mcmc.n_sampling_steps, mcmc.n_walkers
    assert counters["replays.sampler"] == steps
    assert counters.get(f"launches.tiny_mvn.B{W // 2}", 0) == 2 * steps, counters
    assert counters.get(f"launches.tiny_mvn.B{W}", 0) == 3, counters
    assert counters["launches.tiny_mvn"] == 2 * steps + 3, counters


def test_lml_backward_on_the_card_raises_no_warning(device):
    """The LML's closed-form backward runs on autograd's device thread; in a
    fresh process with warnings as errors, a backward through
    ``log_marginal_likelihood`` and a fit on the card (which captures its
    iteration programs) must not hit cuBLAS's "no current CUDA context"
    warning, or any other."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import numpy as np, torch\n"
        "from bayesian_inference_tpu_torch.models import gp_fit\n"
        "from bayesian_inference_tpu_torch.ops.gram import KernelConfig\n"
        "rng = np.random.default_rng(0)\n"
        "X = torch.tensor(rng.uniform(0, 1, (40, 3)), device='cuda', dtype=torch.float32)\n"
        "Y = torch.sin(3 * X)\n"
        "spec = gp_fit.GPFitSpec(cfg=KernelConfig(nu=1.5), theta0=np.zeros(4), log_lo=np.full(4, -4.0),\n"
        "                        log_hi=np.full(4, 2.0), n_restarts=2, n_iters=5, alpha_jitter=1e-6)\n"
        "post = gp_fit.fit_gps(spec, X, Y, generator=torch.Generator(device='cuda').manual_seed(0))\n"
        "torch.cuda.synchronize()\n"
        "assert torch.isfinite(post.lml).all(), post.lml\n"
        "from bayesian_inference_tpu_torch.models import gp\n"
        "from bayesian_inference_tpu_torch.ops.gram import KernelParams\n"
        "leaves = [torch.zeros(3, 3, device='cuda', requires_grad=True), torch.zeros(3, device='cuda', "
        "requires_grad=True), torch.zeros(3, device='cuda')]\n"
        "gp.log_marginal_likelihood(KernelConfig(nu=1.5), KernelParams(*leaves), X, Y.T, 1e-6).sum().backward()\n"
        "torch.cuda.synchronize()\n"
        "assert torch.isfinite(leaves[0].grad).all() and leaves[0].grad.any()\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-W", "error", "-c", code], cwd=src, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    A = torch.tensor(_spd(2, 8), device=device)
    with pytest.raises(TypeError, match="float32"):
        bc.diag_chol_inv(A)
    with pytest.raises(ValueError, match="n <= 64"):
        bc.diag_chol_inv(torch.zeros((2, 65, 65), device=device))
    with pytest.raises(ValueError, match="contiguous"):
        bc.diag_chol_inv(A.float().transpose(-1, -2))
    ops = [torch.tensor(x, device=device).float() for x in _mvn(2, 8, 3, 4)]
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_mvn.fused_block_mvn_loglike(ops[0], ops[1], ops[2], ops[3][:, :2], ops[4])
    dY, C = (torch.tensor(x, device=device) for x in _capacitance(4, 41))
    with pytest.raises(TypeError, match="float32"):
        tiny_mvn.block_mvn_loglike(dY, C)
    with pytest.raises(ValueError, match="contiguous"):
        tiny_mvn.block_mvn_loglike(dY.float(), C.float().transpose(-1, -2))
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.ops import gp_predict as k5
    from bayesian_inference_tpu_torch.ops import stretch_move as k6

    cfg, post = _gp_stack(k=3, N=20)
    with pytest.raises(TypeError, match="float32"):
        k5.gp_predict(cfg, _posterior_on(post, device, torch.float64), torch.zeros((4, 6), dtype=torch.float64,
                                                                                   device=device))
    rands = stretch.pregen_rands(2, 8, torch.Generator(device=device).manual_seed(0), torch.float64)
    x, t = torch.zeros((8, 3), dtype=torch.float64, device=device), torch.zeros(1, dtype=torch.long, device=device)
    with pytest.raises(ValueError, match="float32"):
        k6.propose(x, x[:, 0].contiguous(), rands, t, 1, 0, 2.0)


def test_wider_blocks_than_the_kernels_take_go_dense_on_the_card(device):
    """Where the JAX package goes dense, so does the card, chosen by shape
    before any launch: a K1 bucket of width 56 and K4 capacitance matrices
    of 65 and 72 PCs launch no kernel and lie within 1e-5 of max |ll| of the
    float64 plain versions."""
    ops64 = [torch.tensor(x, device=device) for x in _mvn(2, 56, 3, 4)]
    before = fused_mvn.KERNEL.launches
    ll = fused_mvn.fused_block_mvn_loglike(*(x.float() for x in ops64))
    torch.cuda.synchronize()
    assert fused_mvn.KERNEL.launches == before
    ref = fused_mvn.fused_block_mvn_plain(*ops64)
    assert ll.shape == (4,) and bool(torch.isfinite(ll).all())
    assert float((ll.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    for k in (65, 72):
        dY64, C64 = (torch.tensor(x, device=device) for x in _capacitance(50, k))
        before = tiny_mvn.KERNEL.launches
        ll = tiny_mvn.block_mvn_loglike(dY64.float(), C64.float())
        torch.cuda.synchronize()
        assert tiny_mvn.KERNEL.launches == before
        ref = tiny_mvn.block_mvn_plain(dY64, C64)
        assert ll.shape == (50,) and bool(torch.isfinite(ll).all())
        assert float((ll.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("n_points", [1, 3])
def test_fused_block_mvn_buckets_beside_a_dense_bucket(device, n_points):
    """Buckets of width 8, 16, 24 and 56 in one call: the first three take
    one K1 launch, the 56-wide one the dense path, added in bucket order;
    within 1e-5 of max |ll| of the float64 plain version, bit-equal on
    repeat."""
    Us, Ds, d0s, z, v = _buckets((8, 16, 24, 56), 41, 30 * n_points, n_points)
    t64 = lambda xs: tuple(torch.tensor(x, device=device) for x in xs)  # noqa: E731
    ops64 = (t64(Us), t64(Ds), t64(d0s), *t64((z, v)))
    ops = tuple(tuple(x.float() for x in o) if isinstance(o, tuple) else o.float() for o in ops64)
    before = fused_mvn.KERNEL.launches
    ll = fused_mvn.fused_block_mvn_loglike_buckets(*ops)
    torch.cuda.synchronize()
    assert fused_mvn.KERNEL.launches == before + 1
    ref = fused_mvn.fused_block_mvn_buckets_plain(*ops64)
    assert bool(torch.isfinite(ll).all())
    assert float((ll.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(ll, fused_mvn.fused_block_mvn_loglike_buckets(*ops))


@pytest.fixture(scope="module")
def card_analysis(tmp_path_factory):
    """The jet group (5 PCs) of the synthetic production tables, with its
    run-time configs; observables in memory (the card's machine has no h5py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bayesian_inference_tpu_torch.io.synthetic import THETA_MAX, THETA_MIN, make_production_tables
    from bayesian_inference_tpu_torch.io.tables import initialize_observables_dict_from_tables
    from bayesian_inference_tpu_torch.pipeline import configs

    tmp = tmp_path_factory.mktemp("card_analysis")
    make_production_tables(tmp / "tables")
    group = {"force_retrain": True, "n_pc": 5, "max_n_components_to_calculate": 30,
             "kernels": {"active": ["matern", "noise"], "matern": {"nu": 1.5, "length_scale_bounds_factor": [0.01, 100]},
                         "noise": {"type": "white", "args": {"noise_level": 0.25, "noise_level_bounds": [1e-4, 1]}}},
             "GPR": {"n_restarts": 4, "alpha": 1e-6}, "observable_list": ["jet__pt_"], "cross_validation": True,
             "cross_validation_k": 2}
    analysis = {"parameterizations": ["exponential"], "sqrts_list": [200, 2760, 5020], "centrality_range": [0, 10],
                "parameterization": {"exponential": {"names": ["a", "b", "c", "d", "e", "f"],
                                                     "min": THETA_MIN.tolist(), "max": THETA_MAX.tolist()}},
                "validation_indices": [200, 230], "design_points_to_exclude": [17, 43],
                "parameters": {"emulators": {"jet_group": group},
                               "mcmc": {"n_walkers": 20, "n_burn_steps": 10, "n_sampling_steps": 40,
                                        "n_logging_steps": 0}}}
    config = {"output_dir": str(tmp / "output"), "observable_table_dir": str(tmp / "tables"),
              "observable_config_dir": str(tmp / "tables"), "observables_filename": "observables.h5",
              "analyses": {"card": analysis}}
    kw = dict(analysis_name="card", parameterization="exponential", analysis_config=analysis, config=config)
    observables = initialize_observables_dict_from_tables(str(tmp / "tables"), analysis, "exponential")
    return configs.EmulationConfig.from_config_file(**kw), configs.MCMCConfig(**kw), observables


def test_run_mcmc_resume_is_bit_exact_on_the_card(card_analysis, monkeypatch):
    """On the card (f32, kernels K3 in the fit and K1 in the sampler): a run
    interrupted during its third production chunk and run again equals the
    uninterrupted run at the same cadence, bit for bit."""
    from bayesian_inference_tpu_torch.mcmc import runner
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    kw = dict(seed=2, device=device, emulation_results=artifacts, observables=observables, write=False,
              checkpoint_every=10)
    before = fused_mvn.KERNEL.launches
    whole = runner.run_mcmc(mcmc, **kw)
    assert fused_mvn.KERNEL.launches > before
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms

    inner, calls = SamplerPrograms.chunk, []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) > 2 + 2:
            raise KeyboardInterrupt("interrupted")
        return inner(*args, **kwargs)

    monkeypatch.setattr(SamplerPrograms, "chunk", interrupted)
    with pytest.raises(KeyboardInterrupt):
        runner.run_mcmc(mcmc, **kw)
    monkeypatch.undo()
    resumed = runner.run_mcmc(mcmc, **kw)
    for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat"):
        np.testing.assert_array_equal(resumed[key], whole[key], err_msg=key)
    assert np.isfinite(whole["log_prob"]).all()


@pytest.mark.parametrize("mode,n_points", [("block", None), ("lowrank", None), ("block", 3), ("lowrank", 3)])
def test_sampler_program_equals_the_eager_loop_on_the_card(card_analysis, mode, n_points):
    """On the card the captured program (one CUDA graph per step, captured on
    the zero-valued placeholder likelihood and then fed the fitted one) gives
    the chain, log-probs, acceptance and final state of the eager loop bit
    for bit, for one ensemble and for a batch of points with their own
    offsets; a chunk longer than the program's buffers runs in pieces; and
    the kernels' launch counts follow the replays: two per step, none for
    the capture itself."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc import likelihood as lik
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms, likelihood_shape_spec
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    box = mcmc.parameterization_spec()
    kw = dict(observable_filter=emu.observable_filter, observables=observables)
    exp = obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, **kw)
    like = lik.build_likelihood(emu, artifacts, exp, box["min"], box["max"], mode=mode, device=device,
                                observables=observables)
    spec = likelihood_shape_spec(emu, box["min"], box["max"], mode=mode, device=device, observables=observables)
    W, ndim, n, dt = 20, len(box["min"]), 30, like.theta_min.dtype
    lead = ()
    if n_points:
        ys = np.stack([obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, pseudodata_index=i,
                                                 rng=np.random.default_rng(i), **kw)["y"] for i in range(n_points)])
        if mode == "block":
            d0 = tuple(torch.tensor(d, dtype=dt, device=device)
                       for d in lik.pad_residual_offsets(emu, artifacts, ys, observables))
        else:
            d0 = torch.tensor(lik.residual_offsets_flat(emu, artifacts, ys, observables), dtype=dt, device=device)
        like, lead = like.with_d0(d0), (n_points,)
    gens = [torch.Generator(device=device).manual_seed(5 + i) for i in range(n_points or 1)]
    x0 = like.theta_min + (like.theta_max - like.theta_min) * torch.rand((*lead, W, ndim), generator=gens[0],
                                                                         dtype=dt, device=device)
    if n_points:
        rands = stretch.pregen_rands_batched(n, W, gens, dt)
        eager_chunk = stretch.run_chunk_batched
    else:
        rands = stretch.pregen_rands(n, W, gens[0], dt)
        eager_chunk = stretch.run_chunk
    fn = like.log_posterior
    state0 = stretch.init_state(fn, x0)
    ref_state, ref = eager_chunk(state0, fn, n, rands=rands)

    kernel = fused_mvn.KERNEL if mode == "block" else tiny_mvn.KERNEL
    programs = SamplerPrograms(spec, W, ndim, [12], n_points=n_points)  # 30 steps: pieces of 12, 12 and 6
    before = kernel.launches
    programs.compile()
    assert programs.ok() and programs.captured
    assert kernel.launches == before + 2 * 3  # the warm-up steps ran; the capture ran nothing
    state = programs.init(like, x0)
    assert torch.equal(state.log_prob, state0.log_prob)
    before = kernel.launches
    state, out = programs.chunk(state, like, n, rands=rands)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 * n
    for a, b in zip((*state, *out), (*ref_state, *ref)):
        assert torch.equal(a, b)
    assert torch.isfinite(out[1]).any() and 0 < int(state.n_accepted.sum()) < n * W * (n_points or 1)


def _fit_inputs(seed, N=70, d=3, k=4, n_restarts=5):
    """A small fit on the card: design, targets, spec and restart points."""
    from bayesian_inference_tpu_torch.models import gp_fit
    from bayesian_inference_tpu_torch.ops.gram import KernelConfig

    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (N, d))
    Y = np.stack([np.sin((3 + i) * X[:, i % d]) + 0.1 * rng.normal(size=N) for i in range(k)], axis=1)
    spec = gp_fit.spec_from_reference_config(KernelConfig(nu=1.5), np.zeros(d), np.ones(d), n_restarts=n_restarts,
                                             n_iters=30, alpha_jitter=1e-6)
    rand_logs = rng.uniform(spec.log_lo, spec.log_hi, (k, n_restarts, d + 1))
    return spec, *(torch.tensor(a, dtype=torch.float32, device="cuda") for a in (X, Y, rand_logs))


@pytest.mark.parametrize("fields", [{}, {"trial_steps": (1.0, 0.3)}, {"halving_schedule": ((4, 4), (12, 2))},
                                    {"halving_keep": 0}], ids=["default", "two_trial_steps", "two_rungs", "no_halving"])
def test_fit_programs_equal_the_eager_fit_on_the_card(device, fields):
    """On the card ``fit_gps`` runs every stage as replays of one captured
    graph per stage shape: hyperparameters, LML, alpha and K^-1 equal the
    eager loop's bit for bit; a second fit of another dataset of the same
    shape goes through the cached programs (none built) and equals its own
    eager fit, so the static buffers are really reloaded; and K3's launches
    by batch follow the replays."""
    import dataclasses

    from bayesian_inference_tpu_torch.models import gp_fit

    def same(a, b):
        return (torch.equal(a.params.log_length_scale, b.params.log_length_scale)
                and torch.equal(a.params.log_noise, b.params.log_noise) and torch.equal(a.lml, b.lml)
                and torch.equal(a.alpha, b.alpha) and torch.equal(a.Kinv, b.Kinv))

    gp_fit.clear_fit_programs()
    built = gp_fit.fit_program_stats()["built"]
    first, launched = None, []
    for seed in (0, 1):
        spec, X, Y, rand_logs = _fit_inputs(seed)
        spec = dataclasses.replace(spec, **fields)
        before, by_batch = bc.KERNEL.launches, dict(bc.KERNEL.launches_by_batch)
        post = gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs)
        torch.cuda.synchronize()
        launched.append(bc.KERNEL.launches - before)
        assert launched[-1] == sum(bc.KERNEL.launches_by_batch.values()) - sum(by_batch.values())
        eager = gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs, eager=True)
        assert same(post, eager) and bool(torch.isfinite(post.lml).all())
        if first is None:
            first, n_programs = post, gp_fit.fit_program_stats()["built"] - built
            assert n_programs == len(gp_fit.halving_rungs(spec)) + 1
            assert all(p.captured for p in gp_fit._PROGRAMS.values())
            warm = 2 * gp_fit.WARMUP_ITERATIONS * n_programs  # N = 70 pads to two diagonal blocks
        else:
            assert gp_fit.fit_program_stats()["built"] == built + n_programs
            assert not torch.equal(post.lml, first.lml)
            assert launched[1] == launched[0] - warm
    gp_fit.clear_fit_programs()


def test_cross_validation_on_the_card_launches_k3(card_analysis):
    """Two-fold CV of the jet group on the card: every fold's fit goes through
    K3, and the artifact is finite."""
    from bayesian_inference_tpu_torch.models.cv import cross_validate_group

    emu, _, observables = card_analysis
    before = bc.KERNEL.launches
    art = cross_validate_group(emu.emulation_groups_config["jet_group"], n_opt_iters=20, device="cuda",
                               observables=observables)
    assert bc.KERNEL.launches > before
    assert art["predictions"].shape == art["truth"].shape and art["fold_indices"].shape[0] == 2
    for key in ("predictions", "predictive_std", "normalized_residuals", "lml_per_fold"):
        assert np.isfinite(art[key]).all(), key


def test_device_trace_records_the_card_kernels(device, tmp_path):
    """utils.profiling on the card: the trace holds the annotated region and
    the hand-written kernel launched inside it."""
    import json

    from bayesian_inference_tpu_torch.utils import profiling

    A = torch.tensor(_spd(8, 64), device=device).float()
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("biq_card_region"):
            bc.diag_chol_inv(A)
            torch.cuda.synchronize()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "biq_card_region" for e in events)
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    assert any("diag_chol_inv_kernel" in name for name in kernels), kernels[:20]


def _last_call(name):
    from bayesian_inference_tpu_torch.utils import profiling

    return [c for c in profiling.history() if c["name"] == name][-1]


def test_device_trace_puts_the_card_s_idle_gaps_down_to_program_spans(device, tmp_path):
    """idle_by_span.json on the card: a gap the host spends asleep inside a
    span, between two kernels, is put down to that span (the profiler's
    clock mapped onto the recorder's)."""
    import json
    import time

    from bayesian_inference_tpu_torch.utils import profiling

    A = torch.tensor(_spd(8, 64), device=device).float()
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("t_card_root"):
            bc.diag_chol_inv(A)
            torch.cuda.synchronize()
            with profiling.annotate("t_card_sleep"):
                time.sleep(0.05)
            bc.diag_chol_inv(A)
            torch.cuda.synchronize()
    idle = json.loads((tmp_path / profiling.IDLE_FILE).read_text())
    assert idle["busy_s"] > 0
    assert idle["by_span"].get("t_card_root/t_card_sleep", 0.0) >= 0.045, idle["by_span"]


def test_recorder_counts_replays_captures_and_step_graph_nodes_on_the_card(card_analysis):
    """On the card the root calls count what ran: the fit's replayed L-BFGS
    iterations; a prewarmed program's step graph nodes, equal to those of a
    second capture of its step read through libcuda; and in ``run_mcmc`` on
    that program one replay per step run and no capture."""
    from bayesian_inference_tpu_torch.mcmc import runner
    from bayesian_inference_tpu_torch.mcmc.programs import prewarm_sampler_programs
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators
    from bayesian_inference_tpu_torch.ops import _native
    from bayesian_inference_tpu_torch.utils import profiling

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    assert _last_call("fit_emulators")["counters"]["replays.fit"] == 20
    programs = prewarm_sampler_programs(mcmc, device=device, observables=observables)
    counters = _last_call("capture.sampler")["counters"]
    recorded = {k.rsplit(".", 1)[1]: v for k, v in counters.items() if k.startswith("graph_nodes.sampler.")}
    assert recorded == programs.graph_nodes and counters["captures.sampler"] == 1

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with _native.captured_launches():
        with torch.cuda.graph(graph, stream=side):
            programs._step()
    torch.cuda.current_stream(device).wait_stream(side)
    assert profiling.graph_nodes(graph) == recorded
    assert 0 < recorded["kernel"] <= 32
    del graph

    runner.run_mcmc(mcmc, seed=3, device=device, emulation_results=artifacts, observables=observables,
                    write=False, programs=programs)
    counters = _last_call("run_mcmc")["counters"]
    assert counters["replays.sampler"] == mcmc.n_burn_steps + mcmc.n_sampling_steps
    assert counters.get("captures.sampler", 0) == 0
    assert counters["launches.fused_block_mvn"] == 2 * (mcmc.n_burn_steps + mcmc.n_sampling_steps) + 3


def test_a_closure_batch_counts_one_capture_on_the_card(card_analysis):
    """The closure batch on its prewarmed programs builds one program, phase
    2's, and replays one step graph per step run."""
    from bayesian_inference_tpu_torch.mcmc import runner
    from bayesian_inference_tpu_torch.mcmc.programs import prewarm_sampler_programs
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    indices = [0, 1]
    programs = prewarm_sampler_programs(mcmc, device=device, observables=observables, n_points=len(indices))
    runner.run_closure_batch(mcmc, indices, seed=3, device=device, emulation_results=artifacts,
                             observables=observables, write=False, programs=programs)
    counters = _last_call("run_closure_batch")["counters"]
    assert counters["captures.sampler"] == 1
    assert counters["replays.sampler"] == mcmc.n_burn_steps + mcmc.n_sampling_steps

CARD_OPTION_CASES = {
    "a": {"a": 1.5},
    "fixed_split": {"randomize_split": False},
    "thin": {"thin": 4},
    "no_chain": {"store_chain": False},
    "all": {"a": 1.5, "randomize_split": False, "thin": 4, "store_chain": False},
}


@pytest.mark.parametrize("n_points", [None, 3], ids=["single", "batched"])
@pytest.mark.parametrize("case", sorted(CARD_OPTION_CASES))
def test_sampler_program_options_equal_the_eager_loop_on_the_card(card_analysis, case, n_points):
    """On the card a captured program built with ``a``, ``randomize_split``,
    ``thin`` or ``store_chain`` (and all four) equals the eager loop with the
    same options bit for bit, over a chunk longer than its buffers; one replay
    is ``thin`` sub-steps, and K1 still launches twice per sub-step."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc import likelihood as lik
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators

    options = CARD_OPTION_CASES[case]
    store, thin = options.get("store_chain", True), options.get("thin", 1)
    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    box = mcmc.parameterization_spec()
    kw = dict(observable_filter=emu.observable_filter, observables=observables)
    exp = obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, **kw)
    like = lik.build_likelihood(emu, artifacts, exp, box["min"], box["max"], device=device, observables=observables)
    W, ndim, n, dt = 20, len(box["min"]), 28, like.theta_min.dtype
    lead = ()
    if n_points:
        ys = np.stack([obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, pseudodata_index=i,
                                                 rng=np.random.default_rng(i), **kw)["y"] for i in range(n_points)])
        d0 = tuple(torch.tensor(d, dtype=dt, device=device) for d in lik.pad_residual_offsets(emu, artifacts, ys, observables))
        like, lead = like.with_d0(d0), (n_points,)
    gens = [torch.Generator(device=device).manual_seed(7 + i) for i in range(n_points or 1)]
    x0 = like.theta_min + (like.theta_max - like.theta_min) * torch.rand((*lead, W, ndim), generator=gens[0],
                                                                         dtype=dt, device=device)
    split = options.get("randomize_split", True)
    if n_points:
        rands, eager_chunk = stretch.pregen_rands_batched(n, W, gens, dt, split), stretch.run_chunk_batched
    else:
        rands, eager_chunk = stretch.pregen_rands(n, W, gens[0], dt, split), stretch.run_chunk
    fn = like.log_posterior
    state0 = stretch.init_state(fn, x0)
    ref_state, ref = eager_chunk(state0, fn, n, rands=rands, **options)

    programs = SamplerPrograms(like, W, ndim, [13], n_points=n_points, **options)
    programs.compile()
    assert programs.captured and programs.capacity == (12 if thin == 4 else 13)
    before = fused_mvn.KERNEL.launches
    state, out = programs.chunk(programs.init(like, x0), like, n, rands=rands)
    torch.cuda.synchronize()
    assert fused_mvn.KERNEL.launches == before + 1 + 2 * n
    if not store:
        assert isinstance(out, torch.Tensor)
        out, ref = (out,), (ref,)
    assert out[-1].shape[0] == n // thin
    for a, b in zip((*state, *out), (*ref_state, *ref)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_one_device_mesh_equals_no_mesh_on_the_card(card_analysis):
    """On the card ``run_mcmc(mesh=get_mesh())`` (one device) runs through
    the captured graph and equals ``mesh=None`` bit for bit; a mesh that names
    the card three times still runs one captured graph, with three K1
    launches per evaluation; the closure batch over it pads 2 points to 3 and
    returns the 2."""
    from bayesian_inference_tpu_torch.mcmc import runner
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators
    from bayesian_inference_tpu_torch.parallel.mesh import get_mesh

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    kw = dict(seed=3, device=device, emulation_results=artifacts, observables=observables, write=False)
    before = fused_mvn.KERNEL.launches
    plain = runner.run_mcmc(mcmc, **kw)
    per_run = fused_mvn.KERNEL.launches - before
    mesh = get_mesh()
    assert mesh.size == torch.cuda.device_count() and mesh.devices[0] == device
    one = runner.run_mcmc(mcmc, mesh=get_mesh(1), **kw)
    assert one["programs_captured"] and plain["programs_captured"]
    for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat"):
        np.testing.assert_array_equal(one[key], plain[key], err_msg=key)

    thrice = get_mesh(devices=["cuda:0"] * 3)
    before = fused_mvn.KERNEL.launches
    out = runner.run_mcmc(mcmc, mesh=thrice, **kw)
    assert out["programs_captured"] and fused_mvn.KERNEL.launches - before == 3 * per_run
    assert np.isfinite(out["log_prob"]).all() and 0.0 < out["acceptance_fraction"].mean() < 1.0
    batch = runner.run_closure_batch(mcmc, [0, 1], mesh=thrice, **kw)
    assert sorted(batch) == [0, 1] and batch[0]["chain"].shape == plain["chain"].shape
    assert all(np.isfinite(batch[i]["log_prob"]).all() for i in (0, 1))


def test_mesh_fit_matches_the_unsharded_fit_on_the_card(device):
    """On the card ``fit_gps(mesh=)`` over a mesh naming the card four times
    runs every share through its own captured program and K3, and lands within
    0.1 nat of the unsharded fit's LMLs."""
    from bayesian_inference_tpu_torch.models import gp_fit
    from bayesian_inference_tpu_torch.parallel.mesh import get_mesh

    spec, X, Y, rand_logs = _fit_inputs(2)
    gp_fit.clear_fit_programs()
    single = gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs)
    before = bc.KERNEL.launches
    meshed = gp_fit.fit_gps(spec, X, Y, rand_logs=rand_logs, mesh=get_mesh(devices=["cuda:0"] * 4))
    torch.cuda.synchronize()
    assert bc.KERNEL.launches > before and all(p.captured for p in gp_fit._PROGRAMS.values())
    assert float((meshed.lml - single.lml).abs().max()) <= 0.1
    gp_fit.clear_fit_programs()


def test_compile_async_builds_the_captured_program_on_the_card(card_analysis):
    """compile_async on the card: the capture runs on its own thread while
    this one does host work only; ok() waits for it, the program is a
    captured graph and gives the synchronously built program's chunk."""
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms, likelihood_shape_spec

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    box = mcmc.parameterization_spec()
    spec = likelihood_shape_spec(emu, box["min"], box["max"], device=device, observables=observables)
    W, ndim = 20, len(box["min"])
    x0 = spec.theta_min + (spec.theta_max - spec.theta_min) * torch.rand(
        (W, ndim), generator=torch.Generator(device=device).manual_seed(1), device=device)
    background = SamplerPrograms(spec, W, ndim, [16]).compile_async()
    assert background.ok() and background.captured
    sync = SamplerPrograms(spec, W, ndim, [16])
    sync.compile()
    outs = [p.chunk(p.init(spec, x0), spec, 16, generator=torch.Generator(device=device).manual_seed(2))
            for p in (background, sync)]
    for a, b in zip((*outs[0][0], *outs[0][1]), (*outs[1][0], *outs[1][1])):
        assert torch.equal(a, b)


def _gp_stack(k=41, N=195, d=6, seed=11, nu=1.5, with_constant=False):
    """k stacked Matern GPs (+ white noise) on one random design, by default
    of the production width, hyperparameters from the fit's range, fitted on
    the host in float64."""
    from bayesian_inference_tpu_torch.models import gp
    from bayesian_inference_tpu_torch.ops.gram import KernelConfig, KernelParams

    rng = np.random.default_rng(seed)
    X, Y = rng.uniform(0.0, 1.0, (N, d)), rng.normal(size=(k, N))
    params = KernelParams(torch.tensor(np.log(rng.uniform(0.2, 3.0, (k, d)))),
                          torch.tensor(np.log(rng.uniform(1e-3, 0.1, k))),
                          torch.tensor(np.log(rng.uniform(0.5, 2.0, k))))
    cfg = KernelConfig(nu=nu, with_constant=with_constant)
    return cfg, gp.posterior_from_params_matmul(cfg, params, torch.tensor(X), torch.tensor(Y), 1e-6)


def _posterior_on(post, device, dtype):
    import dataclasses

    move = lambda x: x.to(device=device, dtype=dtype).contiguous()  # noqa: E731
    params = dataclasses.replace(post.params, **{f.name: move(getattr(post.params, f.name))
                                                 for f in dataclasses.fields(post.params)})
    return dataclasses.replace(post, params=params, X=move(post.X), alpha=move(post.alpha), Kinv=move(post.Kinv),
                               prior_var=move(post.prior_var), lml=move(post.lml))


@pytest.mark.parametrize("B", [50, 100, 1500])
def test_gp_predict_kernel_matches_float64(device, B):
    """K5 at the main path's batches (one analysis' half-ensemble, a
    200-walker run's, the 30-point closure batch's) on 41 PCs x 195 design
    points: its error against the float64 plain version, max |err| / max
    |ref| for the means and for the variances, is at most twice the f32
    plain version's; one launch per call, bit-equal on repeat and to the
    same walkers in a batch of 50 (a walker's values do not depend on its
    batch)."""
    from bayesian_inference_tpu_torch.ops import gp_predict as k5

    cfg, post = _gp_stack()
    post32, post64 = _posterior_on(post, device, torch.float32), _posterior_on(post, device, torch.float64)
    theta64 = torch.tensor(np.random.default_rng(B).uniform(0.0, 1.0, (B, 6)), device=device)
    theta = theta64.float()
    before = k5.KERNEL.launches
    mean, var = k5.gp_predict(cfg, post32, theta)
    torch.cuda.synchronize()
    assert k5.KERNEL.launches == before + 1
    plain = k5.gp_predict_plain(cfg, post32, theta)
    ref = k5.gp_predict_plain(cfg, post64, theta64)
    for name, got, f32, want in zip(("mean", "var"), (mean, var), plain, ref):
        assert got.shape == (B, 41) and bool(torch.isfinite(got).all())
        scale = float(want.abs().max())
        err, err_plain = (float((x.double() - want).abs().max()) / scale for x in (got, f32))
        assert err <= 2 * err_plain, (name, err, err_plain)
    again = k5.gp_predict(cfg, post32, theta)
    assert torch.equal(again[0], mean) and torch.equal(again[1], var)
    first = k5.gp_predict(cfg, post32, theta[:50].contiguous())
    assert torch.equal(first[0], mean[:50]) and torch.equal(first[1], var[:50])


@pytest.mark.parametrize("nu,with_constant,N,d,B", [(0.5, False, 300, 3, 37), (1.5, True, 20, 6, 200),
                                                    (2.5, False, 195, 8, 700), (None, True, 257, 6, 50),
                                                    (1.5, False, 700, 6, 9), (1.5, False, 1, 6, 3)])
def test_gp_predict_kernel_for_every_kernel_and_design_size(device, nu, with_constant, N, d, B):
    """K5 for every Matern order and RBF, with and without the constant
    kernel, at designs smaller than a Kinv panel, wider than one column chunk
    (256), not a multiple of either, from one point to 700, at each walker
    tile: within twice the f32 plain version's error of float64, bit-equal
    on repeat."""
    from bayesian_inference_tpu_torch.ops import gp_predict as k5

    cfg, post = _gp_stack(k=5, N=N, d=d, seed=N + B, nu=nu, with_constant=with_constant)
    post32, post64 = _posterior_on(post, device, torch.float32), _posterior_on(post, device, torch.float64)
    theta64 = torch.tensor(np.random.default_rng(B).uniform(-0.1, 1.1, (B, d)), device=device)
    got = k5.gp_predict(cfg, post32, theta64.float())
    plain = k5.gp_predict_plain(cfg, post32, theta64.float())
    ref = k5.gp_predict_plain(cfg, post64, theta64)
    eps = float(torch.finfo(torch.float32).eps)
    for name, x, f32, want in zip(("mean", "var"), got, plain, ref):
        assert x.shape == (B, 5) and bool(torch.isfinite(x).all())
        scale = float(want.abs().max())
        err, err_plain = (float((y.double() - want).abs().max()) / scale for y in (x, f32))
        # At a few design points the plain version's error can be one rounding.
        assert err <= max(2 * err_plain, 4 * eps), (name, err, err_plain)
    again = k5.gp_predict(cfg, post32, theta64.float())
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def _box_gaussian(d, device):
    lo, hi = torch.zeros(d, device=device), torch.ones(d, device=device)

    def fn(x):
        inside = torch.all((x > lo) & (x < hi), dim=-1)
        r = (x - 0.4) / 0.15
        return torch.where(inside, -0.5 * (r * r).sum(-1), -torch.inf)

    return fn


def _plain_chunk(state, fn, n, rands, a):
    """``run_chunk`` through the move's plain phases, on the card."""
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.ops import stretch_move as k6

    outputs = stretch.chunk_outputs(n, state)
    t = torch.zeros(1, dtype=torch.long, device=state.coords.device)
    for _ in range(n):
        move = k6.propose_plain(state.coords, state.log_prob, rands, t, 1, 0, a)
        move = k6.accept_propose_plain(move, fn(move.y), rands, t, 1, 0, a)
        state = stretch.EnsembleState(*k6.accept_assemble_plain(move, fn(move.y), rands, t, 1, 0, a, state.n_accepted,
                                                                state.n_accepted, outputs))
        t += 1
    return state, outputs


@pytest.mark.parametrize("a", [2.0, 1.7])
@pytest.mark.parametrize("n_points", [None, 30])
def test_stretch_move_kernel_matches_plain(device, n_points, a):
    """K6 (three launches per step) against its plain version on the same
    states, draws and log-prob function, 100 walkers in 6 dimensions, one
    ensemble and 30: over 50 steps the chain, log-probs, final state and
    accept counts are bit-equal (the kernel rounds each operation as
    torch's elementwise calls do), the mean acceptance within one ulp."""
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.ops import stretch_move as k6

    W, d, n = 100, 6, 50
    lead = (n_points,) if n_points else ()
    gens = [torch.Generator(device=device).manual_seed(40 + i) for i in range(n_points or 1)]
    x0 = 0.1 + 0.8 * torch.rand((*lead, W, d), generator=gens[0], device=device)
    fn = _box_gaussian(d, device)
    rands = (stretch.pregen_rands_batched(n, W, gens, torch.float32) if n_points
             else stretch.pregen_rands(n, W, gens[0], torch.float32))
    state0 = stretch.init_state(fn, x0)
    before = k6.KERNEL.launches
    chunk = stretch.run_chunk_batched if n_points else stretch.run_chunk
    final, (chain, log_prob, acc) = chunk(state0, fn, n, rands=rands, a=a)
    torch.cuda.synchronize()
    assert k6.KERNEL.launches == before + 3 * n
    ref_final, (ref_chain, ref_log_prob, ref_acc) = _plain_chunk(state0, fn, n, rands, a)
    for got, want in zip((*final, chain, log_prob), (*ref_final, ref_chain, ref_log_prob)):
        assert torch.equal(got, want)
    assert float((acc - ref_acc).abs().max()) <= float(torch.finfo(torch.float32).eps) * float(ref_acc.abs().max())
    assert 0 < int(final.n_accepted.sum()) < n * W * (n_points or 1)


@pytest.mark.parametrize("n_points", [None, 30], ids=["analysis", "closure-batch"])
def test_program_with_the_step_kernels_equals_the_eager_loop_over_200_steps(card_analysis, n_points):
    """Block mode at 100 walkers, one analysis and a 30-point batch: the
    captured program and the eager loop, both running K5, K6 and K1, agree
    bit for bit over 200 steps, and the replays count K5 2, K6 3 and K1 2
    launches per step."""
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc import likelihood as lik
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators
    from bayesian_inference_tpu_torch.ops import gp_predict as k5
    from bayesian_inference_tpu_torch.ops import stretch_move as k6

    emu, mcmc, observables = card_analysis
    device = torch.device("cuda", 0)
    artifacts = fit_emulators(emu, n_opt_iters=20, device=device, observables=observables, write=False)
    box = mcmc.parameterization_spec()
    kw = dict(observable_filter=emu.observable_filter, observables=observables)
    exp = obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, **kw)
    like = lik.build_likelihood(emu, artifacts, exp, box["min"], box["max"], device=device, observables=observables)
    W, ndim, n, dt = 100, len(box["min"]), 200, like.theta_min.dtype
    lead = ()
    if n_points:
        ys = np.stack([obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename, pseudodata_index=i,
                                                 rng=np.random.default_rng(i), **kw)["y"] for i in range(n_points)])
        d0 = tuple(torch.tensor(x, dtype=dt, device=device)
                   for x in lik.pad_residual_offsets(emu, artifacts, ys, observables))
        like, lead = like.with_d0(d0), (n_points,)
    gens = [torch.Generator(device=device).manual_seed(60 + i) for i in range(n_points or 1)]
    x0 = like.theta_min + (like.theta_max - like.theta_min) * torch.rand((*lead, W, ndim), generator=gens[0],
                                                                         dtype=dt, device=device)
    rands = (stretch.pregen_rands_batched(n, W, gens, dt) if n_points else stretch.pregen_rands(n, W, gens[0], dt))
    fn = like.log_posterior
    state0 = stretch.init_state(fn, x0)
    eager = (stretch.run_chunk_batched if n_points else stretch.run_chunk)(state0, fn, n, rands=rands)
    programs = SamplerPrograms(like, W, ndim, [n], n_points=n_points)
    programs.compile()
    assert programs.captured
    kernels = (k5.KERNEL, k6.KERNEL, fused_mvn.KERNEL)
    before = [k.launches for k in kernels]
    out = programs.chunk(state0, like, n, rands=rands)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2 * n, 3 * n, 2 * n]
    for a, b in zip((*out[0], *out[1]), (*eager[0], *eager[1])):
        assert torch.equal(a, b)
    assert 0 < int(out[0].n_accepted.sum()) < n * W * (n_points or 1)
