"""Multi-card runs: the 1-D device mesh and what is split over it."""

from bayesian_inference_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    make_sharded_log_prob,
    replicate,
    shard_leading_axis,
)

__all__ = ["Mesh", "get_mesh", "make_sharded_log_prob", "replicate", "shard_leading_axis"]
