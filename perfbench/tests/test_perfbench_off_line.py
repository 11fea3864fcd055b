"""``off_line_moves`` (``reference.sampler.off_line``) on chains of float32
stretch moves made here, rounded as the program's K6 rounds them:
s = fl(u + 1), z = fl(s s) / 2, y = fl(c + fl(z fl(x - c))) (numpy's
float32 arithmetic rounds to nearest, as ``__fadd_rn`` and ``__fmul_rn``
do), with a Metropolis accept, on Gaussian ensembles whose width is a small
share of their coordinates' magnitudes and with every stretch drawn within
``eps`` of an end of [1/2, 2]. Sound chains read 0; the same chains rounded
to bfloat16 read far above it; a move planted at a stretch beyond [1/2, 2],
pushed off its line or put on no line reads at least 1."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference.sampler import off_line  # noqa: E402

CENTRE = np.array([0.3, 5.0, 3.0, 3.0, 0.7, 40.0])
W, STEPS = 100, 300
F32 = np.float32


def stretch(x: np.ndarray, c: np.ndarray, z: np.ndarray) -> np.ndarray:
    """y = c + z (x - c), each operation rounded to float32 as K6 rounds it."""
    return c + z[:, None] * (x - c)


def chain(width: float, eps: float, seed: int) -> np.ndarray:
    """(STEPS + 1, W, 6) float32 rows of an ensemble of W walkers sampling a
    Gaussian of standard deviation ``width`` times |CENTRE| by stretch moves
    (a = 2, shuffled halves), each u drawn within ``eps`` of 0 or of 1."""
    rng = np.random.default_rng(seed)
    sigma = width * np.abs(CENTRE)
    x = (CENTRE + sigma * rng.standard_normal((W, CENTRE.size))).astype(F32)

    def log_p(y):
        return -0.5 * (((y.astype(np.float64) - CENTRE) / sigma) ** 2).sum(-1)

    h = W // 2
    rows = [x]
    for _ in range(STEPS):
        perm = rng.permutation(W)
        xp = x[perm].copy()
        for half in (0, 1):
            upd = slice(0, h) if half == 0 else slice(h, W)
            comp = xp[h:] if half == 0 else xp[:h]
            off = (eps * rng.random(h)).astype(F32)
            u = np.where(rng.random(h) < 0.5, off, F32(1) - off).astype(F32)
            s = u + F32(1)
            z = (s * s) * F32(0.5)
            y = stretch(xp[upd], comp[rng.integers(0, h, h)], z)
            ok = np.log(rng.random(h)) < 5.0 * np.log(z.astype(np.float64)) + log_p(y) - log_p(xp[upd])
            xp[upd][ok] = y[ok]
        x = np.empty_like(xp)
        x[perm] = xp
        rows.append(x)
    return np.stack(rows)


def count(x_prev: np.ndarray, x_next: np.ndarray) -> int:
    return off_line(torch.tensor(x_prev, dtype=torch.float64), torch.tensor(x_next, dtype=torch.float64),
                    block=2**21)


CASES = [(width, eps) for width in (0.03, 0.003, 0.0003) for eps in (1e-6, 1e-7)]


@pytest.mark.parametrize("width,eps", CASES)
def test_sound_stretch_moves_at_the_ends_of_the_range_read_0(width, eps):
    rows = chain(width, eps, seed=int(width * 1e5) + int(eps * 1e8))
    moved = int(np.any(rows[1:] != rows[:-1], axis=-1).sum())
    assert moved > 0.15 * STEPS * W
    assert count(rows[:-1], rows[1:]) == 0


@pytest.mark.parametrize("width,eps", CASES)
def test_the_same_chains_rounded_to_bfloat16_read_far_above_0(width, eps):
    rows = chain(width, eps, seed=int(width * 1e5) + int(eps * 1e8))
    low = torch.tensor(rows).to(torch.bfloat16).to(torch.float64).numpy()
    moved = int(np.any(low[1:] != low[:-1], axis=-1).sum())
    assert count(low[:-1], low[1:]) >= 0.5 * moved > 0


PLANTS = {"z_2.05": 2.05, "z_0.45": 0.45, "pushed_off_its_line": 2.0, "teleported": 2.0}


@pytest.mark.parametrize("fault", sorted(PLANTS))
@pytest.mark.parametrize("width", [0.03, 0.003, 0.0003])
def test_a_planted_move_no_stretch_move_makes_reads_1(fault, width):
    """One step appended to a sound chain, from its middle row, in which
    walker k alone moves, against walker j put 1 % of the magnitude from it:
    to j's line at the end of [1/2, 2] nearest the fault's stretch it reads 0;
    planted (a stretch beyond the range, that point pushed along one
    coordinate by 1e-4 of its magnitude, a point on no line) it reads 1."""
    rows = chain(width, 1e-7, seed=7)
    rng = np.random.default_rng(11)
    k, j = 0, 1
    x_prev = rows[STEPS // 2].copy()
    x_prev[j] = (x_prev[k] * (1 + 0.01 * rng.choice([-1.0, 1.0], CENTRE.size))).astype(F32)
    z = PLANTS[fault]
    sound, bad = x_prev.copy(), x_prev.copy()
    sound[k] = stretch(x_prev[[k]], x_prev[[j]], np.array([2.0 if z > 1 else 0.5], F32))[0]
    if fault.startswith("z_"):
        bad[k] = stretch(x_prev[[k]], x_prev[[j]], np.array([z], F32))[0]
    elif fault == "pushed_off_its_line":
        bad[k] = sound[k]
        bad[k, 2] += F32(1e-4) * abs(sound[k, 2])
    else:
        bad[k] = (x_prev[k] + 0.01 * np.abs(x_prev[k]) * rng.standard_normal(CENTRE.size)).astype(F32)

    def judged(x_next):
        return count(np.concatenate([rows[:-1], x_prev[None]]), np.concatenate([rows[1:], x_next[None]]))

    assert judged(sound) == 0
    assert judged(bad) == 1
