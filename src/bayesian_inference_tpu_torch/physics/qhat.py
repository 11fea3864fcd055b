"""Closed-form qhat/T^3(theta; E, T) for the exponential parameterization.

Math matches reference plot_qhat.py:261-295 (JetScape GeneralQhatFunction with
HTL running coupling and Debye mass), including its scalar special cases for
scale_net < 1. Vectorized over posterior samples with numpy. Carried over
from ``bayesian_inference_tpu.physics.qhat`` unchanged.
"""

from __future__ import annotations

import numpy as np


def qhat(posterior_samples, parameterization: str = "exponential", T: float = 0.0, E: float = 0.0):
    """qhat/T^3 evaluated at fixed (E, T) for each posterior sample.

    :param posterior_samples: (n_samples, n_params) or (n_params,)
    :return: (n_samples,) array of qhat/T^3 (dimensionless, GeV->fm converted)
    """
    samples = np.asarray(posterior_samples)
    if samples.ndim == 1:
        samples = samples[None, :]

    if parameterization != "exponential":
        raise NotImplementedError(f"qhat not implemented for parameterization={parameterization}")

    alpha_s_fix = samples[:, 0]
    active_flavor = 3
    C_a = 3.0  # JetScapeConstants

    debye_mass_square = alpha_s_fix * 4 * np.pi * T**2 * (6.0 + active_flavor) / 6.0
    scale_net = max(2 * E * T, 1.0)

    square_lambda_QCD_HTL = np.exp(-12.0 * np.pi / ((33 - 2 * active_flavor) * scale_net))
    running_alpha_s = 12.0 * np.pi / ((33.0 - 2.0 * active_flavor) * np.log(scale_net / square_lambda_QCD_HTL))
    if scale_net < 1.0:  # unreachable after the max(), kept for formula parity
        running_alpha_s = scale_net
    answer = (C_a * 50.4864 / np.pi) * running_alpha_s * alpha_s_fix * np.abs(
        np.log(scale_net / debye_mass_square)
    )
    return answer * 0.19732698  # 1/GeV -> fm
