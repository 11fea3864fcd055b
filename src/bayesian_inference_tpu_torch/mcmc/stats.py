"""Chain diagnostics on the host (numpy, carried over from
``bayesian_inference_tpu.mcmc.stats``): emcee's FFT-based integrated
autocorrelation time with Sokal windowing, and split-chain R-hat.
"""

from __future__ import annotations

import os

import numpy as np
import numpy.typing as npt


class AutocorrError(Exception):
    """Chain too short to reliably estimate the autocorrelation time."""


def _auto_window(taus: npt.NDArray, c: float) -> int:
    m = np.arange(len(taus)) < c * taus
    if np.any(m):
        return int(np.argmin(m))
    return len(taus) - 1


# Truncated-lag ACF: Sokal's window for any chain passing the tol=50 bar sits
# at <= c * n_t / tol ~ n_t / 10 lags, so the exact linear ACF is computed only
# out to lag L on long chains; when the window does not converge within L the
# estimate is redone at full length.
_ACF_MAX_LAG = 8192


def _acf_lag_cap(n_t: int) -> int:
    return _ACF_MAX_LAG if n_t >= 2 * _ACF_MAX_LAG else n_t


def split_rhat(chain: npt.NDArray) -> npt.NDArray:
    """Split-chain Gelman-Rubin R-hat per parameter (BDA3 eq. 11.4).

    ``chain``: (n_steps, n_walkers, ndim). Returns (ndim,).
    """
    chain = np.asarray(chain)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t = chain.shape[0] - (chain.shape[0] % 2)
    half = n_t // 2
    # globally centered first: kills the s2 - n*mu^2 cancellation
    c = chain[:n_t] - chain[:n_t].mean(axis=(0, 1), dtype=np.float64).astype(chain.dtype)
    n = half
    means_parts, s2_parts = [], []
    for p in (c[:half], c[half:]):
        means_parts.append(p.sum(axis=0, dtype=np.float64) / n)
        s2_parts.append(np.einsum("twd,twd->wd", p, p, dtype=np.float64))
    means = np.concatenate(means_parts, axis=0)
    s2 = np.concatenate(s2_parts, axis=0)
    variances = (s2 - n * means**2) / (n - 1)
    W = variances.mean(axis=0)
    B_over_n = means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B_over_n
    return np.sqrt(var_plus / np.where(W > 0, W, np.inf))


def integrated_time(chain: npt.NDArray, c: float = 5.0, tol: float = 50.0, quiet: bool = False) -> npt.NDArray:
    """Integrated autocorrelation time per parameter of a (n_steps, n_walkers, ndim) chain.

    Averages the walker autocorrelation functions, applies Sokal's automatic
    windowing with parameter ``c``, and raises AutocorrError when the chain is
    shorter than ``tol`` autocorrelation times (unless ``quiet``).
    """
    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t, n_w, n_d = chain.shape
    L = _acf_lag_cap(n_t)
    taus_all = _mean_acf_taus(chain, max_lag=L)
    wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
    if L < n_t and any(w == 0 for w in wins):
        taus_all = _mean_acf_taus(chain)
        wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
    tau_est = np.array([taus_all[w, d] for d, w in enumerate(wins)])

    if np.any(tol * tau_est > n_t):
        msg = (
            f"The chain is shorter than {tol} times the integrated autocorrelation time "
            f"for {np.sum(tol * tau_est > n_t)} parameter(s). Use this estimate with caution! "
            f"N/{tol} = {n_t / tol:.0f}; tau: {tau_est}"
        )
        if not quiet:
            raise AutocorrError(msg)
    return tau_est


def _mean_acf_taus(chain: npt.NDArray, max_lag: int | None = None) -> npt.NDArray:
    """Cumulative tau estimates 2*cumsum(mean_acf)-1, shape (L, n_d).

    Each centered series is scaled to unit norm, so the walker mean of the
    ACFs is the inverse transform of the walker mean of the power spectra.
    Padding to next_fast_len(n_t + L - 1) keeps the linear ACF exact at all
    lags < L.
    """
    from scipy import fft as sfft

    n_t, n_w, n_d = chain.shape
    L = n_t if max_lag is None else min(int(max_lag), n_t)
    workers = os.cpu_count() or 1
    nfft = sfft.next_fast_len(n_t + L - 1, real=True)
    x = (chain - chain.mean(axis=0)).reshape(n_t, n_w * n_d)
    norm = np.sqrt(np.einsum("tj,tj->j", x, x))
    x = x / np.where(norm == 0.0, 1.0, norm)
    f = sfft.rfft(x, n=nfft, axis=0, workers=workers)
    power = (f.real**2 + f.imag**2).reshape(-1, n_w, n_d).sum(axis=1, dtype=np.float64) / n_w
    mean_acf = sfft.irfft(power.astype(chain.dtype), n=nfft, axis=0, workers=workers)[:L]
    return 2.0 * np.cumsum(mean_acf, axis=0, dtype=np.float64) - 1.0
