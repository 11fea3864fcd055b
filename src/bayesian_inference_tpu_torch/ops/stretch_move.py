"""The stretch move of one ensemble step, in three phases around the two
``log_prob_fn`` calls.

The JAX package's step (``bayesian_inference_tpu.mcmc.stretch._step_with_rands``)
runs in one ``lax.scan`` program, where XLA fuses the move's gathers and
elementwise work around the likelihood; it has no Pallas kernel. Here the
move is ``csrc/stretch_move.cu`` (K6), one kernel launched three times per
step with a phase argument:

1. ``propose``: the walkers in permuted order (``Move.xp``, ``Move.lpp``) and
   the first half's proposals ``Move.y`` against the second half;
2. ``accept_propose``: the first half's accept/reject against ``lp_y =
   log_prob_fn(Move.y)``, then the second half's proposals against the
   updated first half;
3. ``accept_assemble``: the second half's accept/reject, then the new state
   gathered with the inverse permutation (never a scatter) and, where
   ``outputs`` are given, the output row: chain, log-probs (with
   ``store_chain``) and mean acceptance.

Every phase reads its draws itself from row ``t * thin + j`` of a chunk's
draws (``stretch.pregen_rands`` layout, perm/inv (n, [P,] W), u_z/partners/
u_acc (n, [P,] 2, W // 2)), ``t`` a one-element int64 tensor on the
state's device, so the step is the same on the eager loop and in a captured
graph. States may carry a leading point axis (P, W, d): the closure batch.

On CPU tensors each phase runs its plain version (``*_plain``: the JAX
package's move, split into the three phases); on CUDA tensors it launches the
kernel or raises. The kernel takes float32 states and log-probs, int64 indices
and an int32 acceptance count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bayesian_inference_tpu_torch.ops._native import P, I, NativeKernel, stream_handle

F = ctypes.c_float
KERNEL = NativeKernel("stretch_move.cu", {"stretch_move_f32": [I] + [P] * 16 + [I] * 2 + [F] * 2 + [P] * 6 + [I] * 4
                                          + [P]})
INDEX_KEYS = ("perm", "inv", "partners")


class Move(NamedTuple):
    """What passes between the phases: the walkers and their log-probs in
    permuted order, the first half's accept flags (after phase 2), and the
    proposals whose log-probs the next phase takes."""

    xp: torch.Tensor            # (..., W, d)
    lpp: torch.Tensor           # (..., W)
    acc: torch.Tensor | None    # plain: (..., W // 2) bool of the first half; kernel: (..., W) int32 scratch
    y: torch.Tensor             # (..., W // 2, d)


def _take_walkers(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Walkers of x (..., W, d) or (..., W) at indices idx (..., n), per point."""
    idx = idx.long()  # injected draws may carry int32 indices
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _draw_row(rands: dict[str, torch.Tensor], key: str, t: torch.Tensor, thin: int, j: int,
              half: int | None = None) -> torch.Tensor:
    """Row ``t * thin + j`` of the draws ``key`` (and of a (2, W // 2) draw, half ``half``)."""
    row = t if thin == 1 else t * thin + j
    r = rands[key].index_select(0, row)[0]
    return r if half is None else r[..., half, :]


def _z(u: torch.Tensor, a: float) -> torch.Tensor:
    return ((a - 1.0) * u + 1.0) ** 2 / a


def _proposals(x_upd: torch.Tensor, x_comp: torch.Tensor, u: torch.Tensor, partners: torch.Tensor, a: float):
    x_c = _take_walkers(x_comp, partners)
    return x_c + _z(u, a)[..., None] * (x_upd - x_c)


def _accepts(u: torch.Tensor, u_acc: torch.Tensor, lp_y: torch.Tensor, lp_x: torch.Tensor, d: int, a: float):
    log_ratio = (d - 1.0) * torch.log(_z(u, a)) + lp_y - lp_x
    return torch.log(u_acc) < log_ratio


# -- the plain version ----------------------------------------------------------

def propose_plain(coords, log_prob, rands, t, thin: int, j: int, a: float) -> Move:
    """Phase 1: the ensemble permuted, and the first half's proposals."""
    half = coords.shape[-2] // 2
    perm = _draw_row(rands, "perm", t, thin, j)
    xp, lpp = _take_walkers(coords, perm), _take_walkers(log_prob, perm)
    y = _proposals(xp[..., :half, :], xp[..., half:, :], _draw_row(rands, "u_z", t, thin, j, 0),
                   _draw_row(rands, "partners", t, thin, j, 0), a)
    return Move(xp, lpp, None, y)


def accept_propose_plain(move: Move, lp_y, rands, t, thin: int, j: int, a: float) -> Move:
    """Phase 2: the first half accepted or rejected, and the second half's
    proposals against it."""
    half, d = move.xp.shape[-2] // 2, move.xp.shape[-1]
    x_upd, lp_upd = move.xp[..., :half, :], move.lpp[..., :half]
    accept = _accepts(_draw_row(rands, "u_z", t, thin, j, 0), _draw_row(rands, "u_acc", t, thin, j, 0), lp_y, lp_upd,
                      d, a)
    x0 = torch.where(accept[..., None], move.y, x_upd)
    lp0 = torch.where(accept, lp_y, lp_upd)
    xp = torch.cat([x0, move.xp[..., half:, :]], dim=-2)
    lpp = torch.cat([lp0, move.lpp[..., half:]], dim=-1)
    y = _proposals(move.xp[..., half:, :], x0, _draw_row(rands, "u_z", t, thin, j, 1),
                   _draw_row(rands, "partners", t, thin, j, 1), a)
    return Move(xp, lpp, accept, y)


def accept_assemble_plain(move: Move, lp_y, rands, t, thin: int, j: int, a: float, n_accepted, base_accepted,
                          outputs=None):
    """Phase 3: the second half accepted or rejected, the new (coords,
    log_prob, n_accepted) gathered with the inverse permutation, and, with
    ``outputs`` (``stretch.chunk_outputs`` layout), row ``t`` written: the
    state (with the chain) and the mean over walkers of ``n_accepted -
    base_accepted``."""
    half, d = move.xp.shape[-2] // 2, move.xp.shape[-1]
    x_upd, lp_upd = move.xp[..., half:, :], move.lpp[..., half:]
    accept = _accepts(_draw_row(rands, "u_z", t, thin, j, 1), _draw_row(rands, "u_acc", t, thin, j, 1), lp_y, lp_upd,
                      d, a)
    x1 = torch.where(accept[..., None], move.y, x_upd)
    lp1 = torch.where(accept, lp_y, lp_upd)
    inv = _draw_row(rands, "inv", t, thin, j)
    coords = _take_walkers(torch.cat([move.xp[..., :half, :], x1], dim=-2), inv)
    log_prob = _take_walkers(torch.cat([move.lpp[..., :half], lp1], dim=-1), inv)
    n_new = n_accepted + _take_walkers(torch.cat([move.acc, accept], dim=-1), inv).to(torch.int32)
    if outputs is not None:
        *stored, acc = outputs
        if stored:
            chain, chain_log_prob = stored
            chain.index_copy_(0, t, coords[None])
            chain_log_prob.index_copy_(0, t, log_prob[None])
        acc.index_copy_(0, t, (n_new - base_accepted).to(acc.dtype).mean(dim=-1)[None])
    return coords, log_prob, n_new


# -- the kernel -------------------------------------------------------------------

def _check_operands(coords, log_prob, rands, t, n_accepted=None):
    """Raise unless the operands are what the kernel takes."""
    *lead, W, d = coords.shape
    if len(lead) > 1 or W % 2 or W < 2:
        raise ValueError(f"stretch_move: coords {tuple(coords.shape)}; the kernel takes (W, d) or (P, W, d), W even")
    half = W // 2
    n = rands["perm"].shape[0]
    want = {"perm": (n, *lead, W), "inv": (n, *lead, W), "u_z": (n, *lead, 2, half),
            "partners": (n, *lead, 2, half), "u_acc": (n, *lead, 2, half)}
    for key, shape in want.items():
        r = rands[key]
        dtype = torch.int64 if key in INDEX_KEYS else torch.float32
        if tuple(r.shape) != shape or r.dtype != dtype or not r.is_contiguous() or r.device != coords.device:
            raise ValueError(f"stretch_move: draws {key!r} {tuple(r.shape)} {r.dtype} on {r.device}; the kernel takes "
                             f"contiguous {shape} {dtype} on {coords.device}")
    tensors = {"coords": (coords, torch.float32, (*lead, W, d)), "log_prob": (log_prob, torch.float32, (*lead, W)),
               "t": (t, torch.int64, (1,))}
    if n_accepted is not None:
        tensors["n_accepted"] = (n_accepted, torch.int32, (*lead, W))
    for name, (x, dtype, shape) in tensors.items():
        if tuple(x.shape) != shape or x.dtype != dtype or not x.is_contiguous() or x.device != coords.device:
            raise ValueError(f"stretch_move: {name} {tuple(x.shape)} {x.dtype} on {x.device}; the kernel takes "
                             f"contiguous {shape} {dtype} on {coords.device}")
    return (lead[0] if lead else 1), W, d


def _launch(phase: int, coords, log_prob, rands, t, thin: int, j: int, a: float, xp, lpp, acc, y0, y1=None, lp_y=None,
            n_accepted=None, base=None, out=(None, None, None), row=(None, None, None)) -> None:
    n_points, W, d = _check_operands(coords, log_prob, rands, t, n_accepted)
    if not 0 <= j < thin:
        raise ValueError(f"stretch_move: sub-step {j} of thin {thin}")
    if lp_y is not None and (tuple(lp_y.shape) != (*coords.shape[:-2], W // 2) or lp_y.dtype != torch.float32
                             or lp_y.device != coords.device):
        raise ValueError(f"stretch_move: log-probs of the proposals {tuple(lp_y.shape)} {lp_y.dtype} on "
                         f"{lp_y.device}; the kernel takes {(*coords.shape[:-2], W // 2)} float32 on {coords.device}")
    # The scalars as torch passes a Python float to its kernels on the card:
    # a - 1 rounded to float32, and the division by a as a product with
    # 1 / a taken in double and rounded (ctypes rounds both).
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    write_row = row[2] is not None
    KERNEL.launch(
        "stretch_move_f32", phase, *(ptr(x) for x in (coords, log_prob, n_accepted, base)),
        *(rands[k].data_ptr() for k in ("perm", "inv", "u_z", "partners", "u_acc")),
        *(ptr(x) for x in (xp, lpp, acc, y0, y1, lp_y, t)), thin, j, a - 1.0, 1.0 / a,
        *(ptr(x) for x in (*out, *row)), int(write_row), n_points, W, d, stream_handle(coords.device),
        device=coords.device,
    )


def _propose_cuda(coords, log_prob, rands, t, thin, j, a) -> Move:
    *lead, W, d = coords.shape
    xp, lpp = torch.empty_like(coords), torch.empty_like(log_prob)
    acc = torch.empty(log_prob.shape, dtype=torch.int32, device=coords.device)
    y = torch.empty((*lead, W // 2, d), dtype=coords.dtype, device=coords.device)
    _launch(0, coords, log_prob, rands, t, thin, j, a, xp, lpp, acc, y)
    return Move(xp, lpp, acc, y)


def _accept_propose_cuda(move: Move, lp_y, rands, t, thin, j, a) -> Move:
    y1 = torch.empty_like(move.y)
    _launch(1, move.xp, move.lpp, rands, t, thin, j, a, move.xp, move.lpp, move.acc, move.y, y1, lp_y.contiguous())
    return Move(move.xp, move.lpp, move.acc, y1)


def _accept_assemble_cuda(move: Move, lp_y, rands, t, thin, j, a, n_accepted, base_accepted, outputs=None):
    coords, log_prob = torch.empty_like(move.xp), torch.empty_like(move.lpp)
    n_new = torch.empty_like(n_accepted)
    row = (None, None, None)
    if outputs is not None:
        *stored, acc = outputs
        n_rows = acc.shape[0]
        chain, chain_log_prob = stored if stored else (None, None)
        for name, x, shape in (("chain", chain, (n_rows, *coords.shape)),
                               ("log-prob", chain_log_prob, (n_rows, *log_prob.shape)),
                               ("acceptance", acc, (n_rows, *log_prob.shape[:-1]))):
            if x is not None and (tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_contiguous()):
                raise ValueError(f"stretch_move: {name} output {tuple(x.shape)} {x.dtype}; the kernel takes "
                                 f"contiguous {shape} float32")
        if base_accepted.shape != n_accepted.shape or base_accepted.dtype != torch.int32:
            raise ValueError("stretch_move: base_accepted must match n_accepted")
        row = (chain, chain_log_prob, acc)
    _launch(2, move.xp, move.lpp, rands, t, thin, j, a, move.xp, move.lpp, move.acc, None, move.y, lp_y.contiguous(),
            n_accepted, base_accepted.contiguous() if outputs is not None else None, (coords, log_prob, n_new), row)
    return coords, log_prob, n_new


# -- the wrappers ---------------------------------------------------------------

def _route(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"stretch_move: unsupported device {x.device}")


def propose(coords, log_prob, rands, t, thin: int, j: int, a: float) -> Move:
    """Phase 1 of the step at draw row ``t * thin + j``: see the module notes."""
    return _route(coords, propose_plain, _propose_cuda)(coords, log_prob, rands, t, thin, j, a)


def accept_propose(move: Move, lp_y, rands, t, thin: int, j: int, a: float) -> Move:
    """Phase 2, with ``lp_y = log_prob_fn(move.y)``."""
    return _route(move.xp, accept_propose_plain, _accept_propose_cuda)(move, lp_y, rands, t, thin, j, a)


def accept_assemble(move: Move, lp_y, rands, t, thin: int, j: int, a: float, n_accepted, base_accepted,
                    outputs=None):
    """Phase 3, with ``lp_y = log_prob_fn(move.y)``: (coords, log_prob,
    n_accepted) of the new state; with ``outputs``, row ``t`` written, its
    acceptance the walker mean of ``n_accepted - base_accepted``."""
    return _route(move.xp, accept_assemble_plain, _accept_assemble_cuda)(
        move, lp_y, rands, t, thin, j, a, n_accepted, base_accepted, outputs)
