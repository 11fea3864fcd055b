"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

Port of ``bayesian_inference_tpu.mcmc.stretch``. Semantics follow emcee's
StretchMove with its defaults:
  - the ensemble is split into two halves, the walker order shuffled every
    iteration (emcee's RedBlueMove randomize_split)
  - for each walker in the half being updated: partner X_c drawn uniformly
    from the complementary half; z ~ g(z) with density ∝ 1/sqrt(z) on
    [1/a, a] via z = ((a-1)u + 1)^2 / a, a = 2; proposal Y = X_c + z (X - X_c)
  - accept with log-probability min(0, (d-1) log z + logp(Y) - logp(X))

All draws of a chunk are generated up front from a ``torch.Generator`` (or
injected, so a test can hand both packages the same numbers); the steps then
run as device ops with no host round trip.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

LogProbFn = Callable[[torch.Tensor], torch.Tensor]
STRETCH_A = 2.0


class EnsembleState(NamedTuple):
    coords: torch.Tensor      # (W, d)
    log_prob: torch.Tensor    # (W,)
    n_accepted: torch.Tensor  # (W,) int32


def _stretch_half_draws(u, partners, u_acc, x_upd, logp_upd, x_comp, log_prob_fn: LogProbFn):
    """One half-update from pregenerated draws. Returns (x, logp, accepted)."""
    d = x_upd.shape[1]
    a = STRETCH_A
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    x_c = x_comp[partners]
    y = x_c + z[:, None] * (x_upd - x_c)

    logp_y = log_prob_fn(y)
    log_ratio = (d - 1.0) * torch.log(z) + logp_y - logp_upd
    accept = torch.log(u_acc) < log_ratio

    x_new = torch.where(accept[:, None], y, x_upd)
    logp_new = torch.where(accept, logp_y, logp_upd)
    return x_new, logp_new, accept


def pregen_rands(n: int, W: int, generator: torch.Generator, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every draw of ``n`` ensemble steps, laid out like the JAX package's
    ``_pregen_rands``: perm/inv (n, W), u_z/partners/u_acc (n, 2, W // 2)."""
    half = W // 2
    device = generator.device
    perm = torch.argsort(torch.rand((n, W), generator=generator, device=device), dim=-1)
    inv = torch.argsort(perm, dim=-1)
    return {
        "perm": perm,
        "inv": inv,
        "u_z": torch.rand((n, 2, half), generator=generator, dtype=dtype, device=device),
        "partners": torch.randint(0, half, (n, 2, half), generator=generator, device=device),
        "u_acc": torch.rand((n, 2, half), generator=generator, dtype=dtype, device=device),
    }


def _step_with_rands(state: EnsembleState, r: dict[str, torch.Tensor], log_prob_fn: LogProbFn) -> EnsembleState:
    """One full ensemble step from one step's slice of the draws.

    The updated ensemble is assembled by concatenation and a gather with the
    inverse permutation, never by a scatter: the second half's complementary
    set is exactly the freshly updated first half.
    """
    half = state.coords.shape[0] // 2
    x = state.coords[r["perm"]]
    logp = state.log_prob[r["perm"]]

    x0, lp0, a0 = _stretch_half_draws(
        r["u_z"][0], r["partners"][0], r["u_acc"][0], x[:half], logp[:half], x[half:], log_prob_fn
    )
    x1, lp1, a1 = _stretch_half_draws(
        r["u_z"][1], r["partners"][1], r["u_acc"][1], x[half:], logp[half:], x0, log_prob_fn
    )

    inv = r["inv"]
    return EnsembleState(
        coords=torch.cat([x0, x1])[inv],
        log_prob=torch.cat([lp0, lp1])[inv],
        n_accepted=state.n_accepted + torch.cat([a0, a1])[inv].to(torch.int32),
    )


def init_state(log_prob_fn: LogProbFn, x0: torch.Tensor) -> EnsembleState:
    """Evaluate the initial ensemble log-probabilities and zero the counters."""
    if x0.shape[0] % 2:
        raise ValueError("n_walkers must be even")
    return EnsembleState(
        coords=x0,
        log_prob=log_prob_fn(x0),
        n_accepted=torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device),
    )


def run_chunk(
    state: EnsembleState,
    log_prob_fn: LogProbFn,
    n_steps: int,
    generator: torch.Generator | None = None,
    rands: dict[str, torch.Tensor] | None = None,
):
    """Advance the ensemble by ``n_steps``.

    Draws come from ``rands`` when given (``pregen_rands`` layout), else from
    ``generator``. Returns (final_state, (chain (n, W, d), log_prob (n, W),
    per-step mean acceptance (n,))), all on the state's device.
    """
    W, d = state.coords.shape
    if rands is None:
        if generator is None:
            raise ValueError("run_chunk needs a generator or injected draws")
        rands = pregen_rands(n_steps, W, generator, state.coords.dtype)
    chain = torch.empty((n_steps, W, d), dtype=state.coords.dtype, device=state.coords.device)
    log_prob = torch.empty((n_steps, W), dtype=state.log_prob.dtype, device=state.coords.device)
    acc = torch.empty((n_steps,), dtype=state.coords.dtype, device=state.coords.device)
    for t in range(n_steps):
        new = _step_with_rands(state, {k: v[t] for k, v in rands.items()}, log_prob_fn)
        chain[t], log_prob[t] = new.coords, new.log_prob
        acc[t] = (new.n_accepted - state.n_accepted).to(acc.dtype).mean()
        state = new
    return state, (chain, log_prob, acc)
