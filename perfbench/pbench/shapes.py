"""The shapes the per-layer metrics count with, worked out from the cell's
configuration and data alone: the design, the PCs, the walkers, and the
block likelihood's width buckets.

``bucket_layout`` is a frozen copy of ``mcmc/likelihood.bucket_layout`` at
commit 7be95f0: the partition of the observables into padded-width buckets
(multiples of 8) that minimises sum [2048 + count * nb^2].
"""

from __future__ import annotations

import dataclasses

LAUNCH_COST = 2048.0


def bucket_layout(widths, launch_cost: float = LAUNCH_COST) -> list[tuple[int, int]]:
    """[(padded width nb, number of observables)] in ascending nb."""
    pads: dict[int, int] = {}
    for w in widths:
        nb = max(8, ((int(w) + 7) // 8) * 8)
        pads[nb] = pads.get(nb, 0) + 1
    nbs = sorted(pads)
    counts = [pads[nb] for nb in nbs]
    n = len(nbs)
    best: list[tuple[float, int]] = [(0.0, 0)] + [(float("inf"), 0)] * n
    for j in range(1, n + 1):
        for i in range(j):
            cost = best[i][0] + launch_cost + sum(counts[i:j]) * nbs[j - 1] ** 2
            if cost < best[j][0]:
                best[j] = (cost, i)
    out, j = [], n
    while j > 0:
        i = best[j][1]
        out.append((nbs[j - 1], sum(counts[i:j])))
        j = i
    return out[::-1]


@dataclasses.dataclass(frozen=True)
class Shapes:
    n_design: int          # N, training design points
    ndim: int              # d, model parameters
    k: int                 # PCs over all groups
    walkers: int           # W per ensemble
    points: int            # P ensembles advanced together (1 for an analysis)
    buckets: tuple         # ((nb, n_obs), ...) of the block likelihood
    mode: str
    restarts: int
    opt_iters: int

    @property
    def half_batch(self) -> int:
        """Walkers per likelihood evaluation of a half-step: P * W / 2."""
        return self.points * self.walkers // 2


def of(config: dict, traffic: dict, data) -> Shapes:
    points = 1
    if traffic["unit"] == "closure":
        v0, v1 = config["validation_indices"]
        points = data.design_val.shape[0] if traffic.get("validation_points", "all") == "all" else int(
            traffic["validation_points"])
    return Shapes(n_design=data.design.shape[0], ndim=data.design.shape[1],
                  k=sum(int(g["n_pc"]) for g in config["emulators"].values()), walkers=int(config["n_walkers"]),
                  points=points, buckets=tuple(bucket_layout(data.widths)), mode=config["likelihood_mode"],
                  restarts=int(config["n_restarts"]), opt_iters=int(config["opt_iters"]))
