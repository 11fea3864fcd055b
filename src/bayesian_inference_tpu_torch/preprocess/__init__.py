"""Input-data preprocessing (carried over from ``bayesian_inference_tpu.preprocess``)."""

from bayesian_inference_tpu_torch.preprocess.outliers import preprocess, smooth_statistical_outliers_in_predictions

__all__ = ["preprocess", "smooth_statistical_outliers_in_predictions"]
