"""Log-posterior of the emulated Gaussian likelihood, all walkers at once.

Port of ``bayesian_inference_tpu.mcmc.likelihood``. Two likelihood structures:

* ``block`` (default, the reference's model): the merged emulator covariance
  is block-diagonal per observable, so the likelihood is a sum of small
  independent MVN terms. Observable blocks are grouped into size buckets
  (padded width a multiple of 8); one call of the fused block-MVN kernel
  (ops/fused_mvn.py) takes every bucket, one launch per evaluation.
* ``lowrank``: the full cross-observable covariance D + U diag(v) U^T through
  the Woodbury identity (ops/mvn.py), one launch of the tiny-MVN kernel
  (ops/tiny_mvn.py) per evaluation, which builds and factors the k x k
  capacitance matrices and returns the log-likelihood.

Uniform box prior: walkers outside [min, max] get -inf (where-masked; the
likelihood itself is evaluated at box-clipped positions so the Cholesky
always sees valid covariances).

A batched closure run (one pseudodata vector per validation point) differs
only in the residual offset d0. ``with_d0`` swaps it once per run, for one
point or a batch of P; the log-posterior then takes walkers of shape
(P, Wh, d) and returns (P, Wh), all points in one GP predict and one kernel
launch (either mode).
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from bayesian_inference_tpu_torch.models import emulator as emulator_mod
from bayesian_inference_tpu_torch.models.gp import GPPosterior, predict_all_shared
from bayesian_inference_tpu_torch.ops import fused_mvn, tiny_mvn
from bayesian_inference_tpu_torch.ops.fused_mvn import fused_block_mvn_loglike_buckets
from bayesian_inference_tpu_torch.ops.gram import KernelConfig
from bayesian_inference_tpu_torch.ops.mvn import WoodburyNormal, build_woodbury, woodbury_loglike

logger = logging.getLogger(__name__)

MODES = ("block", "lowrank")

# Cost of one extra bucket, in the same count * nb^2 units as the per-block
# factorisation work: it merges buckets only where the padding it adds is
# nearly free. The JAX package launches once per bucket; the port launches
# once for all of them, but keeps this cost so that the layouts match.
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


class GroupGPs(NamedTuple):
    """One stacked GP batch of the likelihood: the kernel structure and the
    posterior stacked over its PCs. A named pair: ``cfg, posts = group``."""

    cfg: KernelConfig
    posts: GPPosterior


@dataclass
class EmulatorLikelihood:
    """Device state of the log-posterior."""

    groups: tuple[GroupGPs, ...]
    theta_min: torch.Tensor  # (d,)
    theta_max: torch.Tensor  # (d,)
    # block mode: one entry per size bucket (see bucket_layout)
    U: tuple[torch.Tensor, ...]   # each (n_obs_b, nb, k_total)
    D: tuple[torch.Tensor, ...]   # each (n_obs_b, nb, nb) constant covariance (+ data errors, padded diag=1)
    d0: tuple[torch.Tensor, ...]  # each (n_obs_b, nb), or (P, n_obs_b, nb): residual offset (m0 - y), padded 0
    # lowrank mode
    wb: WoodburyNormal | None = None
    mode: str = "block"

    def gp_eval(self, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """PC-space means and variances for all groups, concatenated: (W, k_total)."""
        if len(self.groups) == 1:  # the groups fused into one stack: no concatenation
            return predict_all_shared(*self.groups[0], theta)
        zs, vs = zip(*(predict_all_shared(cfg, posts, theta) for cfg, posts in self.groups))
        return torch.cat(zs, dim=1), torch.cat(vs, dim=1)

    def log_likelihood(self, theta: torch.Tensor) -> torch.Tensor:
        """(..., d) -> (...); leading dims (P, Wh) when the offsets are per point."""
        lead = theta.shape[:-1]
        z, v = self.gp_eval(theta.reshape(-1, theta.shape[-1]))
        if self.mode == "block":
            return fused_block_mvn_loglike_buckets(self.U, self.D, self.d0, z, v).reshape(lead)
        if self.mode == "lowrank":
            k = z.shape[-1]
            return woodbury_loglike(self.wb, z.reshape(*lead, k), v.reshape(*lead, k))
        raise ValueError(f"unknown likelihood mode {self.mode!r}")

    def log_posterior(self, theta: torch.Tensor) -> torch.Tensor:
        """(..., d) -> (...). Uniform box prior; -inf outside."""
        inside = torch.all((theta > self.theta_min) & (theta < self.theta_max), dim=-1)
        theta_safe = torch.clamp(theta, self.theta_min, self.theta_max)
        ll = self.log_likelihood(theta_safe)
        return torch.where(inside, ll, -torch.inf)

    def with_d0(self, d0) -> "EmulatorLikelihood":
        """This likelihood with the residual offset swapped for ``d0``.

        Mode-shaped: block mode takes the bucketed tuple layout of ``self.d0``
        (each (n_obs_b, nb), or (P, n_obs_b, nb) for P points); lowrank mode
        takes a flat (F,) or (P, F) residual, from which the d0-dependent
        Woodbury pieces (b, c0) are rebuilt against the cached factorisation.
        Call it once per run: the rebuild is the part the sampler loop must
        not repeat.
        """
        if self.mode == "block":
            return dataclasses.replace(self, d0=tuple(d0))
        if self.mode == "lowrank":
            return dataclasses.replace(self, wb=self.wb.with_d0(d0))
        raise ValueError(f"unknown likelihood mode {self.mode!r}")

    def log_posterior_with_d0(self, d0, theta: torch.Tensor) -> torch.Tensor:
        """log_posterior with the residual offset swapped for ``d0`` (see
        ``with_d0``); theta is (W, d), or (P, Wh, d) with per-point offsets."""
        return self.with_d0(d0).log_posterior(theta)


def _group_means(emulation_config, emulation_results) -> dict[str, np.ndarray]:
    return {
        name: np.asarray(emulation_results[name]["PCA"]["mean"])
        for name in emulation_config.emulation_groups_config
    }


def pad_residual_offsets(
    emulation_config,
    emulation_results: dict[str, dict[str, Any]],
    y_batch: np.ndarray,
    observables: dict[str, Any] | None = None,
) -> tuple[np.ndarray, ...]:
    """Bucketed padded residual offsets d0 = m0 - y for a batch of data vectors.

    ``y_batch`` is (P, n_features); returns a tuple of (P, n_obs_b, nb) arrays
    laid out exactly like EmulatorLikelihood.d0 (same bucket_layout and numpy
    ops as build_likelihood, so a batched closure run sees the offsets of P
    sequential builds). ``observables``: the already-read observables dict.
    """
    slice_map = emulator_mod.GroupSliceMap.learn(emulation_config, observables=observables)
    y_batch = np.atleast_2d(np.asarray(y_batch, float))
    if y_batch.shape[1] != slice_map.n_features:
        raise ValueError(f"data vectors have {y_batch.shape[1]} features, emulators cover {slice_map.n_features}")
    m0_group = _group_means(emulation_config, emulation_results)
    widths = [e[2].stop - e[2].start for e in slice_map.entries]
    out = []
    for nb, idxs in bucket_layout(widths):
        d0_pad = np.zeros((y_batch.shape[0], len(idxs), nb))
        for r, i in enumerate(idxs):
            _label, gname, g_slice, grp_slice = slice_map.entries[i]
            d0_pad[:, r, : widths[i]] = m0_group[gname][grp_slice][None, :] - y_batch[:, g_slice]
        out.append(d0_pad)
    return tuple(out)


def residual_offsets_flat(
    emulation_config,
    emulation_results: dict[str, dict[str, Any]],
    y_batch: np.ndarray,
    observables: dict[str, Any] | None = None,
) -> np.ndarray:
    """Flat residual offsets d0 = m0 - y, shape (P, n_features).

    Lowrank-mode analogue of ``pad_residual_offsets``: the same slice-map
    entries and numpy ops as build_likelihood's d0_full assembly.
    """
    slice_map = emulator_mod.GroupSliceMap.learn(emulation_config, observables=observables)
    y_batch = np.atleast_2d(np.asarray(y_batch, float))
    if y_batch.shape[1] != slice_map.n_features:
        raise ValueError(f"data vectors have {y_batch.shape[1]} features, emulators cover {slice_map.n_features}")
    m0_group = _group_means(emulation_config, emulation_results)
    d0 = np.zeros_like(y_batch)
    for _label, gname, g_slice, grp_slice in slice_map.entries:
        d0[:, g_slice] = m0_group[gname][grp_slice][None, :] - y_batch[:, g_slice]
    return d0


def build_likelihood(
    emulation_config,
    emulation_results: dict[str, dict[str, Any]],
    experimental_results: dict[str, np.ndarray],
    theta_min: Sequence[float],
    theta_max: Sequence[float],
    emulator_cov_unexplained: dict[str, np.ndarray] | None = None,
    mode: str = "block",
    device="cuda",
    dtype: torch.dtype | None = None,
    observables: dict[str, Any] | None = None,
) -> EmulatorLikelihood:
    """Assemble the device likelihood from host artifacts (either package's).

    The truncation covariance enters undivided (one walker per evaluation in
    the reference's sampler). ``observables``: the already-read observables
    dict for the slice map (read from the configured h5 file when None).
    """
    if mode not in MODES:
        raise ValueError(f"unknown likelihood mode {mode!r}; expected one of {MODES}")
    device = emulator_mod.resolve_device(device)
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

    group_names = list(emulation_config.emulation_groups_config)
    offsets: dict[str, int] = {}
    U_group: dict[str, np.ndarray] = {}
    m0_group: dict[str, np.ndarray] = {}
    sigma_group: dict[str, np.ndarray] = {}
    k_total = 0
    for name in group_names:
        art = emulation_results[name]
        n_pc = emulation_config.emulation_groups_config[name].n_pc
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
    dense = [(u.shape[1], u.shape[0]) for u in U_bkts if u.shape[1] > fused_mvn.MAX_NB]
    if mode == "block" and dense:
        logger.info(f"block likelihood: buckets (width, blocks) {dense} are wider than {fused_mvn.MAX_NB} and take "
                    "the dense path, as in the JAX package; the other buckets take one fused-kernel launch")
    if mode == "lowrank" and k_total > tiny_mvn.MAX_NB:
        logger.info(f"lowrank likelihood: {k_total} PCs > {tiny_mvn.MAX_NB}; the capacitance term takes the dense "
                    "path, as in the JAX package")

    # Lowrank mode: the global (F, k) factor, the dense constant covariance
    # (data errors + every group's full truncation covariance at its rows and
    # columns) and the flat residual offset, factorised once.
    wb = None
    if mode == "lowrank":
        F = slice_map.n_features
        U_full = np.zeros((F, k_total))
        D_full = np.diag(y_err**2).astype(float)
        d0_full = np.zeros(F)
        for _label, gname, g_slice, grp_slice in slice_map.entries:
            off, k_g = offsets[gname], U_group[gname].shape[1]
            U_full[g_slice, off : off + k_g] = U_group[gname][grp_slice]
            d0_full[g_slice] = m0_group[gname][grp_slice] - y[g_slice]
        for gname in group_names:
            rows = [(g_slice, grp_slice) for _label, g, g_slice, grp_slice in slice_map.entries if g == gname]
            for gs_i, grp_i in rows:
                for gs_j, grp_j in rows:
                    D_full[gs_i, gs_j] += sigma_group[gname][grp_i, grp_j]
        wb = build_woodbury(to_device(D_full), to_device(U_full), to_device(d0_full))

    # Fuse groups with identical kernel structure and design into ONE stacked
    # GP batch (on the host, in group order so z/v columns match U's column
    # offsets): the device then predicts all PCs in one set of matmuls.
    ems = [emulation_results[n]["emulators"] for n in group_names]
    same = all(e["kernel"] == ems[0]["kernel"] and np.array_equal(e["X"], ems[0]["X"]) for e in ems[1:])
    if same:
        fused = {
            "kernel": ems[0]["kernel"],
            "X": ems[0]["X"],
            "params": {k: np.concatenate([e["params"][k] for e in ems]) for k in ems[0]["params"]},
            **{k: np.concatenate([e[k] for e in ems]) for k in ("alpha", "Kinv", "prior_var", "lml")},
        }
        ems = [fused]
    groups = tuple(GroupGPs(*emulator_mod.posterior_from_artifact({"emulators": e}, device, dtype)) for e in ems)

    return EmulatorLikelihood(
        groups=groups,
        theta_min=to_device(theta_min),
        theta_max=to_device(theta_max),
        U=tuple(to_device(u) for u in U_bkts),
        D=tuple(to_device(d) for d in D_bkts),
        d0=tuple(to_device(d) for d in d0_bkts),
        wb=wb,
        mode=mode,
    )
