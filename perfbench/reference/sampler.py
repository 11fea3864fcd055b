"""One step of the affine-invariant stretch move (Goodman & Weare 2010,
emcee's RedBlueMove with a shuffled split), in float64, from the step's draws.

The ensemble, permuted by ``perm``, is split into halves. Each walker x_k of
the first half gets a partner x_c from the second half (``partners``), a
stretch z = ((a - 1) u + 1)^2 / a, the proposal y = x_c + z (x_k - x_c), and
moves there when log u_acc < (d - 1) log z + log p(y) - log p(x_k). The
second half then moves the same way against the updated first half.

The reference follows the program's chain one step at a time from the
program's own states: each half-step starts from the positions the program
recorded and is judged by its own proposal and its own float64 decision.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def proposals(x_prev: np.ndarray, x_next: np.ndarray, draws: dict[str, np.ndarray], t: int,
              a: float = 2.0) -> dict:
    """The points row ``t`` of the draws proposes, from the program's states
    ``x_prev`` (W, d) before the step and ``x_next`` after it: the walkers in
    permuted order ``xp``, the program's result ``xn`` in that order, and per
    half its stretch ``z`` and proposals ``y``, and ``y32``, the proposals as
    the configuration's float32 rounds them (``float32_proposals``)."""
    h = x_prev.shape[0] // 2
    perm = np.asarray(draws["perm"][t], np.int64)
    xp = torch.tensor(x_prev[perm], dtype=F64)
    xn = torch.tensor(x_next[perm], dtype=F64)
    out = {"xp": xp, "xn": xn, "z": [], "y": [], "y32": []}
    for half in (0, 1):
        upd = xp[:h] if half == 0 else xp[h:]
        comp = xp[h:] if half == 0 else xn[:h]           # the second half moves against the updated first
        u = np.asarray(draws["u_z"][t, half])
        z = ((a - 1.0) * torch.tensor(u, dtype=F64) + 1.0) ** 2 / a
        xc = comp[torch.tensor(np.asarray(draws["partners"][t, half], np.int64))]
        out["z"].append(z)
        out["y"].append(xc + z[:, None] * (upd - xc))
        out["y32"].append(float32_proposals(upd, xc, u, a))
    return out


def float32_proposals(x: torch.Tensor, xc: torch.Tensor, u: np.ndarray, a: float = 2.0) -> torch.Tensor:
    """The stretch proposals in float32, each operation rounded to nearest
    in this order: s = fl(fl((a - 1) u) + 1), z = fl(fl(s s) / a) and
    y = fl(x_c + fl(z fl(x - x_c))). For a stretch within a rounding or two
    of 1 this y is the start x itself, bit for bit, where the float64
    proposal lies a few roundings away from it."""
    f32 = torch.float32
    am1, inv_a = torch.tensor(a - 1.0, dtype=f32), torch.tensor(1.0 / a, dtype=f32)
    s = torch.tensor(np.asarray(u, np.float32)) * am1 + 1.0
    z = (s * s) * inv_a
    x32, c32 = x.to(f32), xc.to(f32)
    return (c32 + z[:, None] * (x32 - c32)).to(F64)


def judge_step(p: dict, lp_cur: torch.Tensor, lp_y: list[torch.Tensor], draws: dict[str, np.ndarray], t: int,
               width: np.ndarray, margin: float = 0.05, pos_tol: float = 1e-4) -> dict:
    """Judge one step given the reference's log-posteriors of the permuted
    walkers (``lp_cur``, (W,)) and of each half's proposals (``lp_y``).

    Returns the decisions checked; the mismatches: decisions that differ
    from the reference's where its log ratio lies more than ``margin`` from
    log u_acc, and moves to a point more than ``pos_tol`` box widths
    (``width`` (d,)) from the reference's proposal; and the largest such
    distance of a move both took.

    A walker that stays where the reference accepts is no mismatch only where
    its float32 proposal (``y32``) is its start exactly: there the accepted
    move leaves it where it was. Any other stay against an accept is one."""
    xp, xn = p["xp"], p["xn"]
    W, d = xp.shape
    h = W // 2
    mismatches, pos_gap = 0, 0.0
    for half in (0, 1):
        sl = slice(half * h, (half + 1) * h)
        z, y = p["z"][half], p["y"][half]
        ratio = (d - 1.0) * torch.log(z) + lp_y[half] - lp_cur[sl]
        log_u = torch.log(torch.tensor(np.asarray(draws["u_acc"][t, half], np.float64)))
        accept_ref = log_u < ratio
        moved = torch.any(xn[sl] != xp[sl], dim=-1)
        at_start = torch.all(p["y32"][half] == xp[sl], dim=-1)
        clear = ((ratio - log_u).abs() > margin) & ~(accept_ref & ~moved & at_start)
        gap = ((xn[sl] - y).abs() / torch.tensor(width, dtype=F64)).amax(-1)
        both = moved & accept_ref
        mismatches += int(((accept_ref != moved) & clear).sum()) + int((both & (gap > pos_tol)).sum())
        if both.any():
            pos_gap = max(pos_gap, float(gap[both].max()))
    return {"decisions": W, "mismatches": mismatches, "position_gap": pos_gap}


def off_line(x_prev: torch.Tensor, x_next: torch.Tensor, a: float = 2.0, rtol: float = 64 * 2.0**-23,
             block: int = 2**24) -> int:
    """The moves that no stretch move could make, judged without the draws:
    walkers whose position after a step (``x_next``, (T, W, d), float64) is
    not their position before it (``x_prev``) and lies farther than ``rtol``
    from every stretch segment through it, the points c + z (x - c) with z in
    [1/a, a] of another walker c, before or after the step. Rows are taken
    ``block`` elements at a time. A count.

    Each coordinate is measured in units of its points' magnitudes,
    scale = |c| + |x| + |y| for the walker's x before and y after: v = (x - c)
    / scale, w = (y - c) / scale. z is fitted by least squares, z* = v.w / v.v,
    and clamped to [1/a, a]; the move is on the segment when
    |w - clamp(z*) v| <= rtol in every coordinate.

    The bound a sound move keeps. The program proposes y = fl(c + fl(z
    fl(x - c))) in float32, from a float32 z in [1/a, a] (for a = 2 exactly:
    s = fl(u + 1) lies in [1, 2], fl(s s) <= 4 and the halving is exact), so
    w = z v + e with |e_i| at most 2 a roundings (2^-24) in these units. The
    fitted z* differs from z by e's projection on v, v.e / v.v; the clamp only
    brings it nearer z, so |clamp(z*) - z| ||v|| <= |v.e| / ||v|| <= ||e||, and
    the residual e + (z - clamp(z*)) v is at most |e_i| + ||e|| <=
    (1 + sqrt(d)) 2 a roundings in a coordinate: 14 * 2^-24 for a = 2 and
    d = 6, against rtol = 128 * 2^-24. A test of z* itself against [1/a, a]
    holds no such bound: z*'s own error, ||e|| / ||v||, grows without limit as
    two walkers come close against their coordinates' magnitudes. For a != 2
    the program's z may pass a or 1/a by a rounding; that moves the residual by
    a rounding of |v_i| <= 1, inside the same budget. A point that no segment
    reaches within rtol (a stretch beyond [1/a, a], a point pushed off its line,
    a walker put where no partner's line goes) is counted."""
    T, W, d = x_prev.shape
    not_self = ~torch.eye(W, dtype=torch.bool, device=x_prev.device).repeat(1, 2)      # (W, 2W)
    rows = max(1, block // (2 * W * W * d))
    count = 0
    for s in range(0, T, rows):
        xp, xn = x_prev[s:s + rows], x_next[s:s + rows]
        moved = torch.any(xn != xp, dim=-1)                                            # (t, W)
        cand = torch.cat([xp, xn], dim=1)[:, None]                                     # (t, 1, 2W, d)
        scale = (cand.abs() + xp[:, :, None].abs() + xn[:, :, None].abs()).clamp_min(torch.finfo(xp.dtype).tiny)
        v, w = (xp[:, :, None] - cand) / scale, (xn[:, :, None] - cand) / scale        # (t, W, 2W, d)
        vv = (v * v).sum(-1)
        z = ((v * w).sum(-1) / vv.clamp_min(torch.finfo(v.dtype).tiny)).clamp(1.0 / a, a)
        on = torch.all((w - z[..., None] * v).abs() <= rtol, dim=-1)
        ok = on & (vv > 0) & not_self
        count += int((moved & ~ok.any(-1)).sum())
    return count
