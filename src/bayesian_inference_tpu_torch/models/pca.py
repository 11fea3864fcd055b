"""Standard scaling + SVD principal-component analysis (host numpy, carried
over from ``bayesian_inference_tpu.models.pca``).

Conventions match sklearn's StandardScaler + PCA(svd_solver='full'):
features centered and scaled to unit variance (ddof=0), components are the
right singular vectors with sklearn's sign flip, explained_variance_ =
s^2 / (n_samples - 1). PCA is one-time setup math, so ``fit_pca`` stays on the
host in float64; callers move the pieces the device needs. ``PCAState``'s
methods are plain arithmetic on its leaves, so a state whose leaves are
tensors (``from_host_dict(d, device=...)``) transforms tensors on their
device: Z = ((Y - mean) / scale) @ components.T, and back.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch


@dataclass
class PCAState:
    """Fitted scaler + PCA. Leaves are numpy arrays (what ``fit_pca`` returns)
    or tensors of one device; the arguments of its methods are of the same
    kind."""

    mean: np.ndarray                      # (n_features,)
    scale: np.ndarray                     # (n_features,) std, ddof=0
    components: np.ndarray                # (n_components, n_features)
    explained_variance: np.ndarray        # (n_components,)
    explained_variance_ratio: np.ndarray  # (n_components,)
    singular_values: np.ndarray           # (n_components,)

    @property
    def n_components(self) -> int:
        return self.components.shape[0]

    def scale_features(self, Y):
        return (Y - self.mean) / self.scale

    def unscale_features(self, Y_scaled):
        return Y_scaled * self.scale + self.mean

    def transform(self, Y, n_pc: int | None = None):
        """PC scores of ``Y`` (..., n_features) on the first ``n_pc`` components (all when None)."""
        comps = self.components if n_pc is None else self.components[:n_pc]
        return self.scale_features(Y) @ comps.T

    def inverse_transform(self, Z):
        """Features from the scores ``Z`` (..., n_pc) of the first n_pc components."""
        return self.unscale_features(Z @ self.components[: Z.shape[-1]])

    def reconstruction(self, Y, n_pc: int):
        """Round trip of ``Y`` through the first ``n_pc`` components (diagnostics)."""
        return self.inverse_transform(self.transform(Y, n_pc=n_pc))

    def to_host_dict(self) -> dict[str, Any]:
        def host(v):
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

        return {f.name: host(getattr(self, f.name)) for f in fields(self)}

    @classmethod
    def from_host_dict(cls, d: dict[str, Any], device=None, dtype: torch.dtype | None = None) -> "PCAState":
        """The state of ``to_host_dict``'s dictionary. ``device=None`` keeps
        numpy leaves (the host state ``fit_pca`` gives); a device makes them
        tensors there, of ``dtype`` (float32 on CUDA, float64 on the CPU when
        None), and a CUDA device raises where there is no card."""
        if device is None:
            return cls(**{k: np.asarray(v) for k, v in d.items()})
        from bayesian_inference_tpu_torch.models.emulator import default_dtype, resolve_device

        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        return cls(**{k: torch.tensor(np.asarray(v), dtype=dtype, device=device) for k, v in d.items()})


def _svd_sign_flip(U, Vt):
    """sklearn's svd_flip(u_based_decision=False): per row of Vt, flip so the
    largest-|.| entry is positive; apply the same flip to the columns of U."""
    idx = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(Vt[np.arange(Vt.shape[0]), idx])
    signs[signs == 0] = 1.0
    return U * signs, Vt * signs[:, None]


def fit_pca(Y, max_n_components: int | None = None) -> tuple[PCAState, np.ndarray]:
    """Fit scaler + full-SVD PCA; returns (state, Y_pca) with Y_pca = all-PC scores.

    ``max_n_components`` caps how many PCs are kept.
    """
    Yh = np.asarray(Y, np.float64)
    n_samples = Yh.shape[0]
    mean = Yh.mean(axis=0)
    scale = Yh.std(axis=0)
    scale[scale == 0.0] = 1.0
    U, s, Vt = np.linalg.svd((Yh - mean) / scale, full_matrices=False)
    U, Vt = _svd_sign_flip(U, Vt)

    explained_variance = (s**2) / (n_samples - 1)
    ratio = explained_variance / explained_variance.sum()
    k = min(max_n_components, s.shape[0]) if max_n_components is not None else s.shape[0]
    state = PCAState(
        mean=mean,
        scale=scale,
        components=Vt[:k],
        explained_variance=explained_variance[:k],
        explained_variance_ratio=ratio[:k],
        singular_values=s[:k],
    )
    return state, U[:, :k] * s[:k]


def truncation_covariance(state: PCAState, n_pc: int) -> np.ndarray:
    """Predictive covariance of the discarded PCs, in *scaled* feature space:
    Sigma_unexplained = S_{>n_pc} D^2_{>n_pc} S_{>n_pc}^T (eqs 21-22 of
    arXiv:2102.11337)."""
    S_rest = state.components[n_pc:].T
    return (S_rest * state.explained_variance[n_pc:]) @ S_rest.T
