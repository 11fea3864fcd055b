"""Chain statistics in float64, from their definitions: the integrated
autocorrelation time (Goodman & Weare / emcee: the walkers' normalised
autocorrelation functions averaged, tau_M = 2 sum_{t<M} rho(t) - 1 with
Sokal's window, the first M >= c tau_M, c = 5) and the split-chain R-hat
(Gelman et al., BDA3 eq. 11.4: each walker's chain cut in halves)."""

from __future__ import annotations

import numpy as np

TAU_C = 5.0
TAU_TOL = 50.0


def integrated_time(chain: np.ndarray, c: float = TAU_C) -> np.ndarray:
    """tau per parameter of a (n, W, d) chain."""
    x = np.asarray(chain, np.float64)
    n = x.shape[0]
    x = x - x.mean(axis=0)
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, n=nfft, axis=0)
    acf = np.fft.irfft(f.real**2 + f.imag**2, n=nfft, axis=0)[:n]
    with np.errstate(invalid="ignore", divide="ignore"):  # a walker that never moves: NaN, judged as such
        acf = (acf / acf[0]).mean(axis=1)                  # (n, d)
    taus = 2.0 * np.cumsum(acf, axis=0) - 1.0
    out = np.empty(x.shape[2])
    for j in range(x.shape[2]):
        m = np.arange(n) < c * taus[:, j]
        out[j] = taus[int(np.argmin(m)) if m.any() else n - 1, j]
    return out


def split_rhat(chain: np.ndarray) -> np.ndarray:
    """R-hat per parameter of a (n, W, d) chain over its 2 W half-chains."""
    x = np.asarray(chain, np.float64)
    half = x.shape[0] // 2
    parts = np.concatenate([x[:half], x[half:2 * half]], axis=1)  # (half, 2W, d)
    means = parts.mean(axis=0)
    within = parts.var(axis=0, ddof=1).mean(axis=0)
    between = means.var(axis=0, ddof=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(((half - 1) / half * within + between) / within)
