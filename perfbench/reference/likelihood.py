"""The emulated Gaussian log-posterior in float64, from its definition.

Per emulation group g with n_pc retained components: the emulator's feature
mean m(theta) = mean_g + U_g z(theta) and covariance
U_g diag(v(theta)) U_g^T + Sigma_g + diag(y_err^2), where U_g is the retained
components scaled back to feature units, z and v the GP predictive means and
variances of the PCs, and Sigma_g the covariance of the discarded components
(up to ``max_n_components_to_calculate``) in feature units. With the residual
r = m(theta) - y:

* ``block``: the covariance kept only within each observable, log L =
  sum over observables of -r_o^T C_o^-1 r_o / 2 - log det C_o / 2;
* ``lowrank``: the covariance of each group in full, the same sum over groups.

No -n log(2 pi) / 2 term. A uniform prior on the open box: -inf outside.
Evaluated by the library Cholesky in float64, in blocks of points, the
observables of one width factorised together.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import emulator
from reference.data import Data

F64 = torch.float64


class Likelihood:
    def __init__(self, data: Data, config: dict, params: dict[str, dict[str, np.ndarray]], mode: str, device,
                 dtype: torch.dtype = F64):
        """``params``: per group name, the fitted ``log_length_scale`` (k_g, d)
        and ``log_noise`` (k_g,) the reference is asked to judge with.
        ``dtype``: float64 for the reference (a lower one for the control)."""
        self.mode, self.device, self.dtype = mode, torch.device(device), dtype
        self.theta_min = torch.tensor(config["prior_min"], dtype=dtype, device=self.device)
        self.theta_max = torch.tensor(config["prior_max"], dtype=dtype, device=self.device)
        nu, alpha = float(config["kernel"]["nu"]), float(config["alpha"])
        X = torch.tensor(data.design, dtype=dtype, device=self.device)
        self.groups = []
        for g in data.groups:
            p = emulator.pca(g.Y, config["max_n_components_to_calculate"])
            k = g.n_pc

            def t(x):
                return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

            comps, ev = p.components, p.explained_variance
            U = comps[:k].T * p.scale[:, None]
            rest = comps[k:]
            sigma = ((rest.T * ev[k:]) @ rest) * np.outer(p.scale, p.scale)
            gps = emulator.GPs(nu, alpha, X, t(p.scores[:, :k].T), t(params[g.name]["log_length_scale"]),
                               t(params[g.name]["log_noise"]))
            cov = sigma + np.diag(g.y_err**2)
            if mode == "lowrank":
                spans = [np.arange(cov.shape[0])[None]]
            else:  # the observables' blocks, those of one width stacked: (n_obs, w) feature indices
                starts = np.cumsum([0, *g.widths[:-1]])
                spans = [np.stack([np.arange(o, o + w) for o, w in zip(starts, g.widths) if w == width])
                         for width in sorted(set(g.widths))]
            blocks = [(torch.tensor(ix, device=self.device), t(U[ix]), t(cov[ix[:, :, None], ix[:, None, :]]))
                      for ix in spans]
            self.groups.append({"name": g.name, "blocks": blocks, "U": t(U), "mean": t(p.mean),
                                "y_exp": t(g.y_exp), "predict": gps.predictor()})

    def log_likelihood(self, theta: torch.Tensor, y: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        """theta (B, d) inside the box -> (B,). ``y``: a data vector per group
        (the experimental values when None)."""
        ll = torch.zeros(theta.shape[0], dtype=self.dtype, device=self.device)
        for g in self.groups:
            z, v = g["predict"](theta)
            yg = g["y_exp"] if y is None else y[g["name"]]
            r = g["mean"] + z @ g["U"].T - yg
            for ix, Ub, cov in g["blocks"]:                      # Ub (n_obs, w, k), cov (n_obs, w, w)
                C = torch.einsum("ofk,bk,ogk->bofg", Ub, v, Ub) + cov
                L = torch.linalg.cholesky(C)
                e = torch.linalg.solve_triangular(L, r[:, ix, None], upper=False)[..., 0]
                ll = ll - 0.5 * (e * e).sum((-2, -1)) - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum((-2, -1))
        return ll

    def log_posterior(self, theta, y: dict[str, torch.Tensor] | None = None, block: int = 256) -> torch.Tensor:
        """theta (B, d), any device and precision -> (B,) float64 on the
        reference's device, -inf outside the box; ``block`` points at a time."""
        theta = torch.as_tensor(theta).to(self.device, self.dtype).reshape(-1, self.theta_min.shape[0])
        out = torch.full((theta.shape[0],), -torch.inf, dtype=F64, device=self.device)
        inside = torch.all((theta > self.theta_min) & (theta < self.theta_max), dim=-1)
        idx = torch.nonzero(inside)[:, 0]
        for i in range(0, idx.shape[0], block):
            sel = idx[i:i + block]
            out[sel] = self.log_likelihood(theta[sel], y).to(F64)
        return out

    def data_vector(self, per_group: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.tensor(v, dtype=self.dtype, device=self.device) for k, v in per_group.items()}
