"""Logging, progress and profiling helpers (carried over from ``bayesian_inference_tpu.utils``)."""

from bayesian_inference_tpu_torch.utils.helpers import setup_logging

__all__ = ["setup_logging"]
