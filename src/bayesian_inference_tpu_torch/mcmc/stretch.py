"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

Port of ``bayesian_inference_tpu.mcmc.stretch``. Semantics follow emcee's
StretchMove:
  - the ensemble is split into two halves; with ``randomize_split`` (the
    default, emcee's RedBlueMove) the walker order is shuffled every iteration
  - for each walker in the half being updated: partner X_c drawn uniformly
    from the complementary half; z ~ g(z) with density ∝ 1/sqrt(z) on
    [1/a, a] via z = ((a-1)u + 1)^2 / a (``a`` = 2 by default); proposal
    Y = X_c + z (X - X_c)
  - accept with log-probability min(0, (d-1) log z + logp(Y) - logp(X))

``thin`` keeps every ``thin``-th state: one output row is the state after
``thin`` sub-steps, and its acceptance entry the walker mean of the
acceptances over those sub-steps (it can reach ``thin``), as in the JAX
package. ``store_chain=False`` keeps no chain and no log-probs, only that
acceptance trace. A chunk draws one row per sub-step whatever ``thin`` is, so
a thinned chunk consumes the random stream of an unthinned one of its length.

All draws of a chunk are generated up front from a ``torch.Generator`` (or
injected, so a test can hand both packages the same numbers); the steps then
run as device ops with no host round trip. ``run_chunk`` dispatches them one
op at a time from a Python loop; the runners go through
``mcmc/programs.SamplerPrograms`` instead, which on CUDA replays the same
step (``step_at``) as a captured graph. The move itself is
``ops/stretch_move.py``: three phases around the two ``log_prob_fn`` calls,
on the card three launches of its kernel, which read their draws from the
device step counter; on the CPU its plain version, the JAX package's move.

Batched ensembles: P independent samplers (the closure test's validation
points) advance together. Every state leaf gets a leading P axis, each point
draws from its own generator, and each half-step makes one ``log_prob_fn``
call over all P * W/2 walkers, which maps (P, W/2, d) to (P, W/2). The same
step code serves both: walkers sit on axis -2 of the coordinates.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from bayesian_inference_tpu_torch.ops import stretch_move

LogProbFn = Callable[[torch.Tensor], torch.Tensor]
STRETCH_A = 2.0


class EnsembleState(NamedTuple):
    coords: torch.Tensor      # (W, d), or (P, W, d)
    log_prob: torch.Tensor    # (W,), or (P, W)
    n_accepted: torch.Tensor  # (W,), or (P, W); int32


def pregen_rands(n: int, W: int, generator: torch.Generator, dtype: torch.dtype,
                 randomize_split: bool = True) -> dict[str, torch.Tensor]:
    """Every draw of ``n`` ensemble steps, laid out like the JAX package's
    ``_pregen_rands``: perm/inv (n, W), u_z/partners/u_acc (n, 2, W // 2).
    Without ``randomize_split`` the permutation is the identity and nothing
    is drawn for it."""
    half = W // 2
    device = generator.device
    if randomize_split:
        perm = torch.argsort(torch.rand((n, W), generator=generator, device=device), dim=-1)
        inv = torch.argsort(perm, dim=-1)
    else:
        perm = torch.arange(W, device=device).expand(n, W).contiguous()
        inv = perm.clone()
    return {
        "perm": perm,
        "inv": inv,
        "u_z": torch.rand((n, 2, half), generator=generator, dtype=dtype, device=device),
        "partners": torch.randint(0, half, (n, 2, half), generator=generator, device=device),
        "u_acc": torch.rand((n, 2, half), generator=generator, dtype=dtype, device=device),
    }


def pregen_rands_batched(
    n: int, W: int, generators: Sequence[torch.Generator], dtype: torch.dtype, randomize_split: bool = True
) -> dict[str, torch.Tensor]:
    """``pregen_rands`` of each point from its own generator, stacked on axis
    1: perm/inv (n, P, W), u_z/partners/u_acc (n, P, 2, W // 2). Each point's
    draws are exactly those of a sequential run seeded like its generator."""
    per_point = [pregen_rands(n, W, g, dtype, randomize_split) for g in generators]
    return {k: torch.stack([r[k] for r in per_point], dim=1) for k in per_point[0]}


def _step_at_row(state: EnsembleState, rands: dict[str, torch.Tensor], t: torch.Tensor, thin: int, j: int,
                 log_prob_fn: LogProbFn, a: float, base_accepted: torch.Tensor, outputs=None) -> EnsembleState:
    """One full ensemble step from draw row ``t * thin + j``: the move's three
    phases (ops/stretch_move.py) around the two half-updates' ``log_prob_fn``
    calls; with ``outputs``, row ``t`` of them written.

    The second half's complementary set is exactly the freshly updated first
    half, and the updated ensemble is assembled by a gather with the inverse
    permutation, never by a scatter.
    """
    move = stretch_move.propose(state.coords, state.log_prob, rands, t, thin, j, a)
    move = stretch_move.accept_propose(move, log_prob_fn(move.y), rands, t, thin, j, a)
    return EnsembleState(*stretch_move.accept_assemble(move, log_prob_fn(move.y), rands, t, thin, j, a,
                                                       state.n_accepted, base_accepted, outputs))


def _index_draws(rands: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The draws with int64 indices (injected draws may carry int32 ones)."""
    return {k: v.long() if k in stretch_move.INDEX_KEYS else v for k, v in rands.items()}


def _step_with_rands(state: EnsembleState, r: dict[str, torch.Tensor], log_prob_fn: LogProbFn,
                     a: float = STRETCH_A) -> EnsembleState:
    """One full ensemble step from one step's slice of the draws (perm/inv
    (..., W), u_z/partners/u_acc (..., 2, W // 2))."""
    rands = {k: v[None].contiguous() for k, v in _index_draws(r).items()}
    t = torch.zeros(1, dtype=torch.long, device=state.coords.device)
    return _step_at_row(state, rands, t, 1, 0, log_prob_fn, a, state.n_accepted)


def init_state(log_prob_fn: LogProbFn, x0: torch.Tensor) -> EnsembleState:
    """Evaluate the initial ensemble log-probabilities and zero the counters.
    ``x0``: (W, d), or (P, W, d) for P independent ensembles."""
    if x0.shape[-2] % 2:
        raise ValueError("n_walkers must be even")
    return EnsembleState(
        coords=x0,
        log_prob=log_prob_fn(x0),
        n_accepted=torch.zeros(x0.shape[:-1], dtype=torch.int32, device=x0.device),
    )


def init_state_batched(log_prob_fn: LogProbFn, x0: torch.Tensor) -> EnsembleState:
    """``init_state`` of P ensembles at once: x0 (P, W, d), one
    ``log_prob_fn`` call over all of them."""
    if x0.dim() != 3:
        raise ValueError(f"init_state_batched takes x0 of shape (P, W, d), got {tuple(x0.shape)}")
    return init_state(log_prob_fn, x0)


def _check_thin(n_steps: int, thin: int) -> None:
    if thin < 1 or n_steps % thin:
        raise ValueError(f"thin {thin} must divide n_steps {n_steps}")


def chunk_outputs(n_rows: int, state: EnsembleState, store_chain: bool = True):
    """Empty outputs of ``n_rows`` output rows from ``state``: chain
    (n, ..., W, d), log-probs (n, ..., W) and mean acceptance (n, ...); the
    acceptance alone, as a one-element tuple, without ``store_chain``."""
    dt, dev = state.coords.dtype, state.coords.device
    acc = torch.empty((n_rows, *state.log_prob.shape[:-1]), dtype=dt, device=dev)
    if not store_chain:
        return (acc,)
    return (
        torch.empty((n_rows, *state.coords.shape), dtype=dt, device=dev),
        torch.empty((n_rows, *state.log_prob.shape), dtype=state.log_prob.dtype, device=dev),
        acc,
    )


def step_at(state: EnsembleState, rands: dict[str, torch.Tensor], outputs, t: torch.Tensor,
            log_prob_fn: LogProbFn, a: float = STRETCH_A, thin: int = 1) -> EnsembleState:
    """The output row at index ``t``, a one-element int64 tensor on the
    state's device: ``thin`` ensemble steps reading rows ``t * thin`` to
    ``t * thin + thin - 1`` of a chunk's draws, then row ``t`` of the chunk's
    ``outputs`` (``chunk_outputs`` layout, with or without the chain) is
    written and the new state returned. The index is a tensor so that the
    eager loop and a captured device program (mcmc/programs.py) run the same
    ops; on the card each step is three launches of the move's kernel around
    the two ``log_prob_fn`` calls, the last of them writing the row."""
    new = state
    for j in range(thin):
        new = _step_at_row(new, rands, t, thin, j, log_prob_fn, a, state.n_accepted,
                           outputs if j == thin - 1 else None)
    return new


def _run_steps(state: EnsembleState, log_prob_fn: LogProbFn, n_steps: int, rands: dict[str, torch.Tensor],
               a: float, store_chain: bool, thin: int):
    _check_thin(n_steps, thin)
    rands = _index_draws(rands)
    outputs = chunk_outputs(n_steps // thin, state, store_chain)
    t = torch.zeros(1, dtype=torch.long, device=state.coords.device)
    for _ in range(n_steps // thin):
        state = step_at(state, rands, outputs, t, log_prob_fn, a, thin)
        t += 1
    return state, (outputs if store_chain else outputs[0])


def step(
    state: EnsembleState,
    log_prob_fn: LogProbFn,
    generator: torch.Generator | None = None,
    rands: dict[str, torch.Tensor] | None = None,
    a: float = STRETCH_A,
    randomize_split: bool = True,
) -> EnsembleState:
    """One full ensemble step (both halves updated).

    The step's draws come from ``rands`` when given (one step's slice of the
    ``pregen_rands`` layout: perm/inv (W,), u_z/partners/u_acc (2, W // 2)),
    else from ``generator`` (``randomize_split`` then says whether the walker
    order is shuffled).
    """
    if rands is None:
        if generator is None:
            raise ValueError("step needs a generator or injected draws")
        drawn = pregen_rands(1, state.coords.shape[0], generator, state.coords.dtype, randomize_split)
        rands = {k: v[0] for k, v in drawn.items()}
    return _step_with_rands(state, rands, log_prob_fn, a)


def run_chunk(
    state: EnsembleState,
    log_prob_fn: LogProbFn,
    n_steps: int,
    generator: torch.Generator | None = None,
    rands: dict[str, torch.Tensor] | None = None,
    a: float = STRETCH_A,
    randomize_split: bool = True,
    store_chain: bool = True,
    thin: int = 1,
):
    """Advance the ensemble by ``n_steps``.

    Draws come from ``rands`` when given (``pregen_rands`` layout, one row per
    step whatever ``thin`` is), else from ``generator``. Returns (final_state,
    (chain (n // thin, W, d), log_prob (n // thin, W), acceptance
    (n // thin,))), all on the state's device; with ``store_chain=False``
    (final_state, acceptance). ``thin`` must divide ``n_steps``.
    """
    if rands is None:
        if generator is None:
            raise ValueError("run_chunk needs a generator or injected draws")
        rands = pregen_rands(n_steps, state.coords.shape[0], generator, state.coords.dtype, randomize_split)
    return _run_steps(state, log_prob_fn, n_steps, rands, a, store_chain, thin)


def run_chunk_batched(
    states: EnsembleState,
    log_prob_fn: LogProbFn,
    n_steps: int,
    generators: Sequence[torch.Generator] | None = None,
    rands: dict[str, torch.Tensor] | None = None,
    a: float = STRETCH_A,
    randomize_split: bool = True,
    store_chain: bool = True,
    thin: int = 1,
):
    """Advance P independent ensembles (state leaves (P, W, ...)) by ``n_steps``.

    Draws come from ``rands`` when given (``pregen_rands_batched`` layout),
    else one ``pregen_rands`` per point from ``generators[p]``. Returns
    (final_states, (chain (n // thin, P, W, d), log_prob (n // thin, P, W),
    acceptance (n // thin, P))); with ``store_chain=False`` (final_states,
    acceptance).
    """
    if rands is None:
        if generators is None or len(generators) != states.coords.shape[0]:
            raise ValueError("run_chunk_batched needs one generator per point or injected draws")
        rands = pregen_rands_batched(n_steps, states.coords.shape[1], generators, states.coords.dtype,
                                     randomize_split)
    return _run_steps(states, log_prob_fn, n_steps, rands, a, store_chain, thin)


def run_ensemble(
    log_prob_fn: LogProbFn,
    x0: torch.Tensor,
    n_steps: int,
    generator: torch.Generator | None = None,
    rands: dict[str, torch.Tensor] | None = None,
    chunk_size: int | None = None,
    a: float = STRETCH_A,
    randomize_split: bool = True,
    store_chain: bool = True,
    thin: int = 1,
) -> dict[str, torch.Tensor]:
    """Run the sampler for ``n_steps`` from the ensemble ``x0`` (W, d).

    ``chunk_size`` splits the run into chunks of that many steps (it must
    divide ``n_steps``, and ``thin`` must divide it), each pregenerating its
    own draws from ``generator``; None runs one chunk. ``rands`` injects the
    draws of all ``n_steps`` instead (``pregen_rands`` layout).

    Returns {'chain': (n_steps // thin, W, d), 'log_prob': (n_steps // thin, W)
    (both only with ``store_chain``), 'acceptance_trace': (n_steps // thin,),
    'coords', 'final_log_prob', 'acceptance_fraction'}, as the JAX package's
    ``run_ensemble`` does.
    """
    if x0.shape[0] % 2:
        raise ValueError("n_walkers must be even")
    chunk_size = n_steps if chunk_size is None else chunk_size
    if chunk_size < 1 or n_steps % chunk_size:
        raise ValueError(f"chunk_size {chunk_size} must divide n_steps {n_steps}")
    state = init_state(log_prob_fn, x0)
    pieces = []
    for start in range(0, n_steps, chunk_size):
        r = None if rands is None else {k: v[start:start + chunk_size] for k, v in rands.items()}
        state, ys = run_chunk(state, log_prob_fn, chunk_size, generator=generator, rands=r, a=a,
                              randomize_split=randomize_split, store_chain=store_chain, thin=thin)
        pieces.append(ys if store_chain else (ys,))
    *stored, acc = (p[0] if len(p) == 1 else torch.cat(p) for p in zip(*pieces))
    result = {
        "acceptance_trace": acc,
        "coords": state.coords,
        "final_log_prob": state.log_prob,
        "acceptance_fraction": state.n_accepted.to(x0.dtype) / n_steps,
    }
    if store_chain:
        result["chain"], result["log_prob"] = stored
    return result
