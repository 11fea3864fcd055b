"""Shared helpers of the PyTorch port's parity tests (``tests/test_torch_*.py``).

The JAX package is the reference. Each test makes its inputs with numpy from a
seed and hands the same arrays to the JAX function (CPU, float64, as
conftest.py configures JAX) and to its counterpart in
``bayesian_inference_tpu_torch`` (CPU, float64). On CPU tensors the port runs
the plain PyTorch versions of its CUDA kernels; the kernels themselves are
held against those plain versions on the card (``test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import torch

# Several pytest-xdist workers share the host: one intra-op thread each.
torch.set_num_threads(1)


def t64(x) -> torch.Tensor:
    """A float64 CPU tensor holding a copy of ``x`` (numpy or JAX array)."""
    return torch.tensor(np.array(x), dtype=torch.float64)


def to_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
