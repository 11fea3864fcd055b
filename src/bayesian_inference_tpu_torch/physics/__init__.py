"""q-hat physics and prior sampling (host numpy, carried over from
``bayesian_inference_tpu.physics``)."""

from bayesian_inference_tpu_torch.physics.qhat import qhat
from bayesian_inference_tpu_torch.physics.priors import generate_prior_samples

__all__ = ["qhat", "generate_prior_samples"]
