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
from bayesian_inference_tpu_torch.ops import fused_mvn

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


@pytest.mark.parametrize("B,n", [(1, 1), (3, 17), (300, 64)])
def test_diag_chol_inv_kernel_matches_plain(device, B, n):
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


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    A = torch.tensor(_spd(2, 8), device=device)
    with pytest.raises(TypeError, match="float32"):
        bc.diag_chol_inv(A)
    with pytest.raises(ValueError, match="n <= 64"):
        bc.diag_chol_inv(torch.zeros((2, 65, 65), device=device))
    with pytest.raises(ValueError, match="contiguous"):
        bc.diag_chol_inv(A.float().transpose(-1, -2))
    ops = [torch.tensor(x, device=device).float() for x in _mvn(2, 56, 3, 4)]
    with pytest.raises(ValueError, match="no CUDA kernel"):
        fused_mvn.fused_block_mvn_loglike(*ops)
    ops = [torch.tensor(x, device=device).float() for x in _mvn(2, 8, 3, 4)]
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_mvn.fused_block_mvn_loglike(ops[0], ops[1], ops[2], ops[3][:, :2], ops[4])
