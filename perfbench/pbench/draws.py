"""Every random number of one sampler run, made by the benchmark from a seed
and handed to the program through its documented ``draws=`` argument, so
that the reference can judge each accept decision of the run.

Layout (the runners' ``draws`` contract): ``{"x0": start, "burn": [phase 1,
phase 2], "production": draws}``; each phase holds ``perm``/``inv`` (n, [P,]
W) int32 and ``u_z``/``partners``/``u_acc`` (n, [P,] 2, W // 2), the uniforms
float32, the partners int32. The start is uniform in the prior box.
"""

from __future__ import annotations

import numpy as np
import torch


def _phase(n: int, lead: tuple[int, ...], W: int, gen: torch.Generator, device) -> dict[str, np.ndarray]:
    h = W // 2
    perm = torch.argsort(torch.rand((n, *lead, W), generator=gen, device=device), dim=-1)
    out = {
        "perm": perm,
        "inv": torch.argsort(perm, dim=-1),
        "u_z": torch.rand((n, *lead, 2, h), generator=gen, device=device),
        "partners": torch.randint(0, h, (n, *lead, 2, h), generator=gen, device=device),
        "u_acc": torch.rand((n, *lead, 2, h), generator=gen, device=device),
    }
    return {k: v.to(torch.int32 if k in ("perm", "inv", "partners") else torch.float32).cpu().numpy()
            for k, v in out.items()}


def make(seed: int, n_burn: int, n_steps: int, W: int, prior_min, prior_max, n_points: int | None,
         device) -> dict:
    """The draws of one run of ``n_burn`` + ``n_steps`` steps, for one
    ensemble or, with ``n_points``, for a batch of them."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lead = () if n_points is None else (n_points,)
    lo = torch.tensor(prior_min, dtype=torch.float64, device=device)
    hi = torch.tensor(prior_max, dtype=torch.float64, device=device)
    # strictly inside the box after rounding to float32
    u = torch.rand((*lead, W, lo.shape[0]), generator=gen, dtype=torch.float64, device=device).clamp(1e-6, 1 - 1e-6)
    x0 = (lo + (hi - lo) * u).to(torch.float32).cpu().numpy()
    b0 = n_burn // 2
    return {"x0": x0, "burn": [_phase(b0, lead, W, gen, device), _phase(n_burn - b0, lead, W, gen, device)],
            "production": _phase(n_steps, lead, W, gen, device)}
