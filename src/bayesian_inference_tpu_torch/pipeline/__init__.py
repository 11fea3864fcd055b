"""Pipeline configuration (carried over from ``bayesian_inference_tpu.pipeline``)."""
