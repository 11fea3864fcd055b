"""Posterior statistics and chain diagnostics: credible intervals, the MAP
estimate, emcee's FFT-based integrated autocorrelation time with Sokal
windowing (per walker too), and split-chain R-hat.

Host part carried over from ``bayesian_inference_tpu.mcmc.stats`` (numpy and
scipy). The device part (``device_mean_power``, ``device_split_rhat``,
``device_closure_stats``) runs the expensive forward transforms and moment
sums on the chain's own device with ``torch.fft``, and downloads only the
walker-averaged power spectra and the R-hats; the runners take it on CUDA.
It takes a chain or the list of its time-axis slabs, as production leaves
them.
"""

from __future__ import annotations

import os

import numpy as np
import numpy.typing as npt
import torch
from scipy import fft as sfft


def credible_interval(samples: npt.NDArray, confidence: float = 0.9, interval_type: str = "quantile"):
    """Credible interval of a 1-D sample array: 'hpd' (minimum width) or 'quantile'."""
    samples = np.asarray(samples)
    if interval_type == "hpd":
        nci = int((1 - confidence) * samples.size)
        argp = np.argpartition(samples, [nci, samples.size - nci])
        lows = np.sort(samples[argp[:nci]])
        highs = np.sort(samples[argp[-nci:]])
        i = np.argmin(highs - lows)
        return lows[i], highs[i]
    if interval_type == "quantile":
        lo = (1 - confidence) / 2
        return tuple(np.quantile(samples, [lo, 1 - lo]))
    raise ValueError(f"Unknown interval_type {interval_type}")


def map_parameters(posterior: npt.NDArray, method: str = "quantile") -> npt.NDArray:
    """MAP estimate: mean of samples inside a narrow central quantile band, per dim."""
    if method != "quantile":
        raise ValueError(f"Unknown method {method}")
    posterior = np.asarray(posterior)
    q = 0.01
    lo = np.quantile(posterior, 0.5 - q / 2, axis=0)
    hi = np.quantile(posterior, 0.5 + q / 2, axis=0)
    mask = (posterior >= lo) & (posterior <= hi)
    return np.array([posterior[mask[:, i], i].mean() for i in range(posterior.shape[1])])


class AutocorrError(Exception):
    """Chain too short to reliably estimate the autocorrelation time."""


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function_1d(x: npt.NDArray) -> npt.NDArray:
    """Normalized autocorrelation function of a 1-D series via FFT."""
    x = np.atleast_1d(np.asarray(x, float))
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    return acf / acf[0]


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


def warm_fft_plans(n_t: int) -> None:
    """Plan the host transforms of ``integrated_time`` at chain length ``n_t``
    ahead of their first use: the capped-lag and the full-length pair, and the
    power-of-two inverse of the ``device_mean_power`` path. scipy caches a
    plan per process, so the runners call this while the device runs
    production and the estimate afterwards pays its compute alone. Pure
    scipy: safe beside device work, and it changes no result."""
    x = np.zeros((n_t, 1), np.float32)
    for L in sorted({_acf_lag_cap(n_t), n_t}):
        nfft = sfft.next_fast_len(n_t + L - 1, real=True)
        sfft.irfft(sfft.rfft(x, n=nfft, axis=0), n=nfft, axis=0)
    nfft = 2 * _next_pow_two(n_t)
    sfft.irfft(np.zeros((nfft // 2 + 1, 1), np.complex64), n=nfft, axis=0)


def _tau_or_raise(tau_est: npt.NDArray, n_t: int, tol: float, quiet: bool) -> npt.NDArray:
    if np.any(tol * tau_est > n_t):
        msg = (
            f"The chain is shorter than {tol} times the integrated autocorrelation time "
            f"for {np.sum(tol * tau_est > n_t)} parameter(s). Use this estimate with caution! "
            f"N/{tol} = {n_t / tol:.0f}; tau: {tau_est}"
        )
        if not quiet:
            raise AutocorrError(msg)
    return tau_est


def integrated_time(
    chain: npt.NDArray,
    c: float = 5.0,
    tol: float = 50.0,
    quiet: bool = False,
    mean_power: tuple[npt.NDArray, int] | None = None,
) -> npt.NDArray:
    """Integrated autocorrelation time per parameter of a (n_steps, n_walkers, ndim) chain.

    Averages the walker autocorrelation functions, applies Sokal's automatic
    windowing with parameter ``c``, and raises AutocorrError when the chain is
    shorter than ``tol`` autocorrelation times (unless ``quiet``).

    ``mean_power``: a precomputed ``(power, nfft)`` walker-averaged power
    spectrum from ``device_mean_power``; only the inverse transform and the
    windowing then run here. The spectrum is full-length, so no lag cap
    applies.
    """
    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t, n_w, n_d = chain.shape
    if mean_power is not None:
        power, nfft = mean_power
        tau_est, _ = integrated_time_from_power(power, nfft, n_t, c=c, tol=tol, out_dtype=chain.dtype)
        return _tau_or_raise(tau_est, n_t, tol, quiet)
    L = _acf_lag_cap(n_t)
    taus_all = _mean_acf_taus(chain[:, None], max_lag=L)[:, 0, :]
    wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
    if L < n_t and any(w == 0 for w in wins):
        taus_all = _mean_acf_taus(chain[:, None])[:, 0, :]
        wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
    tau_est = np.array([taus_all[w, d] for d, w in enumerate(wins)])
    return _tau_or_raise(tau_est, n_t, tol, quiet)


def _mean_acf_taus(chain: npt.NDArray, max_lag: int | None = None, max_chunk_series: int = 4096) -> npt.NDArray:
    """Cumulative tau estimates 2*cumsum(mean_acf)-1, shape (L, P, n_d), of a
    (n_t, P, n_w, n_d) batch of P independent chains.

    Each centered series is scaled to unit norm, so the walker mean of the
    ACFs is the inverse transform of the walker mean of the power spectra.
    Forward transforms run a few points at a time (at most ~``max_chunk_series``
    series), which bounds the complex buffer. Padding to
    next_fast_len(n_t + L - 1) keeps the linear ACF exact at all lags < L.
    """
    n_t, P, n_w, n_d = chain.shape
    L = n_t if max_lag is None else min(int(max_lag), n_t)
    workers = os.cpu_count() or 1
    nfft = sfft.next_fast_len(n_t + L - 1, real=True)
    x = (chain - chain.mean(axis=0)).reshape(n_t, P * n_w * n_d)
    norm = np.sqrt(np.einsum("tj,tj->j", x, x))
    x = x / np.where(norm == 0.0, 1.0, norm)
    group = n_w * n_d
    pts_chunk = max(1, max_chunk_series // group)
    power = np.empty((nfft // 2 + 1, P, n_d), np.float64)
    for p0 in range(0, P, pts_chunk):
        p1 = min(P, p0 + pts_chunk)
        f = sfft.rfft(x[:, p0 * group : p1 * group], n=nfft, axis=0, workers=workers)
        power[:, p0:p1] = (f.real**2 + f.imag**2).reshape(-1, p1 - p0, n_w, n_d).sum(axis=2, dtype=np.float64)
    power /= n_w
    return _taus_from_power(power, nfft, L, chain.dtype, workers=workers)


def _taus_from_power(power: npt.NDArray, nfft: int, L: int, out_dtype, workers: int = 1) -> npt.NDArray:
    """Cumulative tau estimates from a walker-averaged power spectrum
    (nfft//2+1, P, n_d); the inverse transform runs in ``out_dtype`` (the
    chain's precision). Returns (L, P, n_d)."""
    _, P, n_d = power.shape
    mean_acf = sfft.irfft(power.reshape(-1, P * n_d).astype(out_dtype), n=nfft, axis=0, workers=workers)[:L]
    return 2.0 * np.cumsum(mean_acf, axis=0, dtype=np.float64).reshape(L, P, n_d) - 1.0


def integrated_time_from_power(
    power: npt.NDArray, nfft: int, n_t: int, c: float = 5.0, tol: float = 50.0, out_dtype=np.float32
) -> tuple[npt.NDArray, npt.NDArray]:
    """Sokal-windowed tau from a full-length walker-averaged power spectrum
    (``device_mean_power``). Returns (tau (n_d,), reliable (n_d,) bool --
    False where the chain is shorter than ``tol`` tau)."""
    taus_all = _taus_from_power(np.asarray(power)[:, None, :], nfft, n_t, out_dtype)[:, 0, :]
    tau = np.array([taus_all[_auto_window(taus_all[:, d], c), d] for d in range(taus_all.shape[1])])
    return tau, tol * tau <= n_t


def tau_vs_length_from_power(
    power: npt.NDArray, nfft: int, n_t: int, lengths, c: float = 5.0, out_dtype=np.float64
) -> npt.NDArray:
    """The tau-vs-chain-length convergence curve from one full-chain
    walker-averaged power spectrum (``device_mean_power``): one inverse
    transform, then Sokal's window per length with the searchable lag range
    capped at that length. The last point is the full-chain estimate; earlier
    points differ from re-estimating every chain prefix only by that
    estimator's extra noise. Returns (len(lengths), n_d)."""
    taus_all = _taus_from_power(np.asarray(power)[:, None, :], nfft, n_t, out_dtype)[:, 0, :]
    n_d = taus_all.shape[1]
    lengths = np.asarray(lengths, int)
    out = np.empty((len(lengths), n_d))
    for i, n in enumerate(lengths):
        L = min(int(n), n_t)
        for d in range(n_d):
            out[i, d] = taus_all[_auto_window(taus_all[:L, d], c), d]
    return out


def integrated_time_batched(chain: npt.NDArray, c: float = 5.0, tol: float = 50.0) -> tuple[npt.NDArray, npt.NDArray]:
    """Integrated autocorrelation time of a batch of independent chains.

    ``chain``: (n_t, P, n_w, n_d), P closure points diagnosed in one batched
    FFT pass. Returns (tau (P, n_d), reliable (P, n_d) bool -- False where the
    chain is shorter than ``tol`` tau, the AutocorrError condition of
    ``integrated_time``).
    """
    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    n_t, P, n_w, n_d = chain.shape
    L = _acf_lag_cap(n_t)
    flat = _mean_acf_taus(chain, max_lag=L).reshape(L, P * n_d)
    m = np.arange(L)[:, None] < c * flat
    win = np.where(m.any(axis=0), np.argmin(m, axis=0), L - 1)
    if L < n_t and np.any(win == 0):
        # some series' window lies beyond the lag cap: exact full-length redo
        flat = _mean_acf_taus(chain).reshape(n_t, P * n_d)
        m = np.arange(n_t)[:, None] < c * flat
        win = np.where(m.any(axis=0), np.argmin(m, axis=0), n_t - 1)
    tau = flat[win, np.arange(flat.shape[1])].reshape(P, n_d)
    return tau, tol * tau <= n_t


def integrated_time_per_walker(chain: npt.NDArray, c: float = 5.0, tol: float = 50.0) -> tuple[npt.NDArray, npt.NDArray]:
    """Per-walker integrated autocorrelation time (reference plot_mcmc.py:179-204,
    which loops emcee's estimator over single-walker chains): one batched FFT
    over every (walker, parameter) series, then Sokal's window per series (no
    walker average).

    Returns (tau, reliable), both (n_walkers, n_dim); ``reliable`` is False
    where the chain is shorter than ``tol`` tau.
    """
    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t, n_w, n_d = chain.shape
    x = (chain - chain.mean(axis=0)).reshape(n_t, n_w * n_d)
    workers = os.cpu_count() or 1

    def taus_and_windows(L: int):
        nfft = sfft.next_fast_len(n_t + L - 1, real=True)
        f = sfft.rfft(x, n=nfft, axis=0, workers=workers)
        np.multiply(f, np.conjugate(f), out=f)
        acf = sfft.irfft(f, n=nfft, axis=0, workers=workers)[:L]
        acf0 = acf[0]
        acf = acf / np.where(acf0 == 0.0, 1.0, acf0)
        taus_all = 2.0 * np.cumsum(acf.astype(np.float64), axis=0) - 1.0  # (L, series)
        m = np.arange(L)[:, None] < c * taus_all
        return taus_all, np.where(m.any(axis=0), np.argmin(m, axis=0), L - 1)

    L = _acf_lag_cap(n_t)
    taus_all, win = taus_and_windows(L)
    if L < n_t and np.any(win == 0):
        # some walker's window lies beyond the lag cap: exact full-length redo
        taus_all, win = taus_and_windows(n_t)
    tau = taus_all[win, np.arange(taus_all.shape[1])].reshape(n_w, n_d)
    return tau, tol * tau <= n_t


def _as_slabs(chain_pieces) -> list:
    """A chain, or a list of its time-axis slabs, as the list."""
    return list(chain_pieces) if isinstance(chain_pieces, (list, tuple)) else [chain_pieces]


def _padded_series(slabs: list, nfft: int, point: int | None = None) -> tuple[torch.Tensor, int, tuple[int, int]]:
    """The chain of the time-axis ``slabs`` (each (n, n_w, n_d), or
    (n, P, n_w, n_d) with ``point`` naming one of the P) laid into the
    transform's zero-padded input, (nfft, n_w * n_d) on the first tensor
    slab's device: filled slab by slab, so the chain is never concatenated
    into a copy of its own. Slabs may be tensors of any device or host
    arrays. Returns (buffer, n_t, (n_w, n_d))."""
    like = next((s for s in slabs if isinstance(s, torch.Tensor)), None)
    if like is None:
        like = torch.as_tensor(slabs[0])
    n_w, n_d = like.shape[-2:]
    n_t = sum(s.shape[0] for s in slabs)
    x = like.new_zeros((nfft, n_w * n_d))
    t = 0
    for s in slabs:
        piece = torch.as_tensor(s if point is None else s[:, point])
        x[t:t + piece.shape[0]] = piece.reshape(piece.shape[0], -1)
        t += piece.shape[0]
    return x, n_t, (n_w, n_d)


def _device_power(x: torch.Tensor, n_t: int, n_w: int, n_d: int) -> torch.Tensor:
    """Walker-averaged |rfft|^2 of the centered, unit-norm series in the first
    ``n_t`` rows of the zero-padded buffer ``x`` (``_padded_series``), which
    is overwritten, in the chain's precision: (nfft//2+1, n_d)."""
    v = x[:n_t]
    v -= v.mean(dim=0, keepdim=True)
    norm2 = (v * v).sum(dim=0)
    v /= torch.sqrt(torch.where(norm2 == 0.0, 1.0, norm2))
    f = torch.fft.rfft(x, dim=0)
    return (f.real**2 + f.imag**2).reshape(-1, n_w, n_d).mean(dim=1)


def _device_rhat(chain: torch.Tensor) -> torch.Tensor:
    """``split_rhat`` of one (n_t, n_w, n_d) chain in the chain's precision
    (after global centering, f32 moments are accurate to ~1e-5)."""
    n_t = chain.shape[0] - (chain.shape[0] % 2)
    half = n_t // 2
    c = chain[:n_t] - chain[:n_t].mean(dim=(0, 1), keepdim=True)
    parts = (c[:half], c[half:])
    means = torch.cat([p.mean(dim=0) for p in parts])
    s2 = torch.cat([(p * p).sum(dim=0) for p in parts])
    variances = (s2 - half * means**2) / (half - 1)
    W = variances.mean(dim=0)
    B_over_n = means.var(dim=0, correction=1)
    var_plus = (half - 1) / half * W + B_over_n
    return torch.sqrt(var_plus / torch.where(W > 0, W, torch.inf))


def _n_steps(slabs: list) -> int:
    return sum(s.shape[0] for s in slabs)


def device_mean_power(chain_pieces) -> tuple[np.ndarray, int]:
    """Walker-averaged ACF power spectrum of a (n_t, n_w, n_d) chain, or of
    the list of its time-axis slabs, computed on the chain's device; only the
    (nfft//2+1, n_d) spectrum is downloaded. Pass the result to
    ``integrated_time(..., mean_power=...)``. Full-length transform:
    nfft = 2 * next_pow_two(n_t), emcee's choice. The slabs go straight into
    the transform's padded input; the result does not depend on where the
    chain is cut."""
    slabs = _as_slabs(chain_pieces)
    nfft = 2 * _next_pow_two(_n_steps(slabs))
    x, n_t, (n_w, n_d) = _padded_series(slabs, nfft)
    return _device_power(x, n_t, n_w, n_d).cpu().numpy(), nfft


def device_split_rhat(chain_pieces) -> np.ndarray:
    """``split_rhat`` of a chain, or of the list of its time-axis slabs,
    computed on the chain's device; downloads (n_d,)."""
    slabs = _as_slabs(chain_pieces)
    n_t = _n_steps(slabs)
    x, _, (n_w, n_d) = _padded_series(slabs, n_t)
    return _device_rhat(x.reshape(n_t, n_w, n_d)).cpu().numpy()


def device_closure_stats(chain_pieces) -> tuple[np.ndarray, int, np.ndarray]:
    """Per-point power spectra and split-R-hats of a batched closure chain
    (n_t, P, n_w, n_d), or of the list of its time-axis slabs, on its device,
    one point at a time: a point's series go slab by slab into the
    transform's padded input, which both statistics read, so the buffers stay
    one point's size and the batch is never concatenated. Returns
    (power (P, nfft//2+1, n_d), nfft, rhat (P, n_d)); pass ``(power[p], nfft)``
    to ``integrated_time_from_power``."""
    slabs = _as_slabs(chain_pieces)
    nfft = 2 * _next_pow_two(_n_steps(slabs))
    powers, rhats = [], []
    for p in range(slabs[0].shape[1]):
        x, n_t, (n_w, n_d) = _padded_series(slabs, nfft, point=p)
        rhats.append(_device_rhat(x[:n_t].reshape(n_t, n_w, n_d)))
        powers.append(_device_power(x, n_t, n_w, n_d))
    return torch.stack(powers).cpu().numpy(), nfft, torch.stack(rhats).cpu().numpy()
