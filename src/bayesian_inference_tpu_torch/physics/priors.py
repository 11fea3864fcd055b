"""Prior sampling for qhat parameterizations.

Uniform box prior, except parameters whose names contain 'c_' are sampled
log-uniformly (reference plot_qhat.py:298-325). Carried over from
``bayesian_inference_tpu.physics.priors`` unchanged.
"""

from __future__ import annotations

import numpy as np


def generate_prior_samples(
    names: list[str],
    parameter_min,
    parameter_max,
    n_samples: int = 100,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """(n_samples, n_params) prior samples; log-uniform for 'c_' parameters."""
    if rng is None:
        rng = np.random.default_rng()
    lo = np.array(parameter_min, dtype=float)
    hi = np.array(parameter_max, dtype=float)
    is_log = np.array(["c_" in name for name in names])
    # guard: only log-transform the log-uniform dims (others may contain 0)
    lo = np.where(is_log, np.log(np.where(is_log, lo, 1.0)), lo)
    hi = np.where(is_log, np.log(np.where(is_log, hi, 1.0)), hi)
    samples = rng.uniform(lo, hi, (n_samples, len(names)))
    samples[:, is_log] = np.exp(samples[:, is_log])
    return samples
