"""Log-posterior of the emulated Gaussian likelihood, all walkers at once.

Port of ``bayesian_inference_tpu.mcmc.likelihood`` in ``block`` mode: the
merged emulator covariance is block-diagonal per observable, so the
likelihood is a sum of small independent MVN terms. Observable blocks are
grouped into size buckets (padded width a multiple of 8) and each bucket is
one launch of the fused block-MVN kernel (ops/fused_mvn.py).

Uniform box prior: walkers outside [min, max] get -inf (where-masked; the
likelihood itself is evaluated at box-clipped positions so the Cholesky
always sees valid covariances).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from bayesian_inference_tpu_torch.models import emulator as emulator_mod
from bayesian_inference_tpu_torch.models.gp import GPPosterior, predict_all_shared
from bayesian_inference_tpu_torch.ops.fused_mvn import fused_block_mvn_loglike
from bayesian_inference_tpu_torch.ops.gram import KernelConfig

# Cost of one extra kernel launch per likelihood evaluation, in the same
# count * nb^2 units as the per-block factorisation work: it merges buckets
# only where the padding it adds is nearly free.
_LAUNCH_COST = 2048.0


def bucket_layout(widths: Sequence[int], launch_cost: float = _LAUNCH_COST) -> list[tuple[int, list[int]]]:
    """Partition observable blocks into padded-width buckets (multiples of 8).

    A tiny DP over the sorted distinct padded widths picks the partition
    minimizing  sum_groups [launch_cost + (count in group) * (group max nb)^2].
    Returns [(nb_pad, [observable indices])] in ascending nb_pad -- a pure
    function of the bin widths (identical to the JAX package's layout).
    """
    pads: dict[int, list[int]] = {}
    for i, w in enumerate(widths):
        nb = max(8, ((int(w) + 7) // 8) * 8)
        pads.setdefault(nb, []).append(i)
    nbs = sorted(pads)
    counts = [len(pads[nb]) for nb in nbs]
    n = len(nbs)

    # best[j] = (cost, first-index-of-last-group) over widths nbs[:j]
    best: list[tuple[float, int]] = [(0.0, 0)] + [(float("inf"), 0)] * n
    for j in range(1, n + 1):
        for i in range(j):  # last group = nbs[i:j], padded to nbs[j-1]
            cost = best[i][0] + launch_cost + sum(counts[i:j]) * nbs[j - 1] ** 2
            if cost < best[j][0]:
                best[j] = (cost, i)
    cuts = []
    j = n
    while j > 0:
        i = best[j][1]
        cuts.append((i, j))
        j = i
    out = []
    for i, j in reversed(cuts):
        idxs = [k for nb in nbs[i:j] for k in pads[nb]]
        out.append((nbs[j - 1], sorted(idxs)))
    return out


def bucketize_blocks(
    U_rows: Sequence[np.ndarray],
    D_rows: Sequence[np.ndarray],
    d0_rows: Sequence[np.ndarray],
) -> tuple[list[np.ndarray], list[np.ndarray], list[np.ndarray]]:
    """Stack per-observable (w,k)/(w,w)/(w,) blocks into bucketed padded tensors.

    Padded rows get identity covariance and zero residual (contribute exactly
    0 to the log-likelihood). Returns three lists aligned with
    ``bucket_layout`` order: U (n_obs_b, nb, k), D (n_obs_b, nb, nb),
    d0 (n_obs_b, nb).
    """
    widths = [u.shape[0] for u in U_rows]
    k = U_rows[0].shape[1]
    Us, Ds, d0s = [], [], []
    for nb, idxs in bucket_layout(widths):
        U_pad = np.zeros((len(idxs), nb, k))
        D_pad = np.tile(np.eye(nb), (len(idxs), 1, 1))
        d0_pad = np.zeros((len(idxs), nb))
        for r, i in enumerate(idxs):
            w = widths[i]
            U_pad[r, :w] = U_rows[i]
            D_pad[r, :w, :w] = D_rows[i]
            d0_pad[r, :w] = d0_rows[i]
        Us.append(U_pad)
        Ds.append(D_pad)
        d0s.append(d0_pad)
    return Us, Ds, d0s


@dataclass
class EmulatorLikelihood:
    """Device state of the block-mode log-posterior."""

    groups: tuple[tuple[KernelConfig, GPPosterior], ...]
    theta_min: torch.Tensor  # (d,)
    theta_max: torch.Tensor  # (d,)
    # one entry per size bucket (see bucket_layout)
    U: tuple[torch.Tensor, ...]   # each (n_obs_b, nb, k_total)
    D: tuple[torch.Tensor, ...]   # each (n_obs_b, nb, nb) constant covariance (+ data errors, padded diag=1)
    d0: tuple[torch.Tensor, ...]  # each (n_obs_b, nb) constant residual offset (m0 - y), padded 0

    def gp_eval(self, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """PC-space means and variances for all groups, concatenated: (W, k_total)."""
        zs, vs = zip(*(predict_all_shared(cfg, posts, theta) for cfg, posts in self.groups))
        return torch.cat(zs, dim=1), torch.cat(vs, dim=1)

    def log_likelihood(self, theta: torch.Tensor) -> torch.Tensor:
        z, v = self.gp_eval(theta)
        ll = None
        for U_b, D_b, d0_b in zip(self.U, self.D, self.d0):
            term = fused_block_mvn_loglike(U_b, D_b, d0_b, z, v)
            ll = term if ll is None else ll + term
        return ll

    def log_posterior(self, theta: torch.Tensor) -> torch.Tensor:
        """(W, d) -> (W,). Uniform box prior; -inf outside."""
        inside = torch.all((theta > self.theta_min) & (theta < self.theta_max), dim=-1)
        theta_safe = torch.clamp(theta, self.theta_min, self.theta_max)
        ll = self.log_likelihood(theta_safe)
        return torch.where(inside, ll, -torch.inf)


def build_likelihood(
    emulation_config,
    emulation_results: dict[str, dict[str, Any]],
    experimental_results: dict[str, np.ndarray],
    theta_min: Sequence[float],
    theta_max: Sequence[float],
    emulator_cov_unexplained: dict[str, np.ndarray] | None = None,
    mode: str = "block",
    device="cpu",
    dtype: torch.dtype | None = None,
    observables: dict[str, Any] | None = None,
) -> EmulatorLikelihood:
    """Assemble the device likelihood from host artifacts (either package's).

    The truncation covariance enters undivided (one walker per evaluation in
    the reference's sampler). ``observables``: the already-read observables
    dict for the slice map (read from the configured h5 file when None).
    """
    if mode != "block":
        raise NotImplementedError(
            f"likelihood mode {mode!r} is not ported yet (ROADMAP queue 1: lowrank / Woodbury)"
        )
    device = torch.device(device)
    dtype = dtype or emulator_mod.default_dtype(device)

    def to_device(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    if emulator_cov_unexplained is None:
        emulator_cov_unexplained = emulator_mod.compute_emulator_cov_unexplained(
            emulation_config, emulation_results
        )

    slice_map = emulator_mod.GroupSliceMap.learn(emulation_config, observables=observables)
    y = np.asarray(experimental_results["y"], float)
    y_err = np.asarray(experimental_results["y_err"], float)
    if y.shape[0] != slice_map.n_features:
        raise ValueError(f"data vector has {y.shape[0]} features, emulators cover {slice_map.n_features}")

    offsets: dict[str, int] = {}
    U_group: dict[str, np.ndarray] = {}
    m0_group: dict[str, np.ndarray] = {}
    sigma_group: dict[str, np.ndarray] = {}
    k_total = 0
    for name, cfg_g in emulation_config.emulation_groups_config.items():
        art = emulation_results[name]
        n_pc = cfg_g.n_pc
        S_k = np.asarray(art["PCA"]["components"])[:n_pc]  # (k_g, F_g)
        scale = np.asarray(art["PCA"]["scale"])
        U_group[name] = S_k.T * scale[:, None]             # (F_g, k_g): unscaled low-rank factor
        m0_group[name] = np.asarray(art["PCA"]["mean"])
        sigma_group[name] = emulator_cov_unexplained[name] * np.outer(scale, scale)
        offsets[name] = k_total
        k_total += n_pc

    U_rows, D_rows, d0_rows = [], [], []
    for _label, gname, g_slice, grp_slice in slice_map.entries:
        w = g_slice.stop - g_slice.start
        off, k_g = offsets[gname], U_group[gname].shape[1]
        U_i = np.zeros((w, k_total))
        U_i[:, off : off + k_g] = U_group[gname][grp_slice]
        U_rows.append(U_i)
        D_rows.append(sigma_group[gname][grp_slice, grp_slice] + np.diag(y_err[g_slice] ** 2))
        d0_rows.append(m0_group[gname][grp_slice] - y[g_slice])
    U_bkts, D_bkts, d0_bkts = bucketize_blocks(U_rows, D_rows, d0_rows)

    # Fuse groups with identical kernel structure and design into ONE stacked
    # GP batch (on the host, in group order so z/v columns match U's column
    # offsets): the device then predicts all PCs in one set of matmuls.
    ems = [emulation_results[n]["emulators"] for n in emulation_config.emulation_groups_config]
    same = all(e["kernel"] == ems[0]["kernel"] and np.array_equal(e["X"], ems[0]["X"]) for e in ems[1:])
    if same:
        fused = {
            "kernel": ems[0]["kernel"],
            "X": ems[0]["X"],
            "params": {k: np.concatenate([e["params"][k] for e in ems]) for k in ems[0]["params"]},
            **{k: np.concatenate([e[k] for e in ems]) for k in ("alpha", "Kinv", "prior_var", "lml")},
        }
        ems = [fused]
    groups = tuple(emulator_mod.posterior_from_artifact({"emulators": e}, device, dtype) for e in ems)

    return EmulatorLikelihood(
        groups=groups,
        theta_min=to_device(theta_min),
        theta_max=to_device(theta_max),
        U=tuple(to_device(u) for u in U_bkts),
        D=tuple(to_device(d) for d in D_bkts),
        d0=tuple(to_device(d) for d in d0_bkts),
    )
