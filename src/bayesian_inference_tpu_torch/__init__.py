"""PyTorch + CUDA port of ``bayesian_inference_tpu``.

The same pipeline as the JAX package (PCA, one Gaussian process per principal
component, the emulated Gaussian likelihood, the affine-invariant stretch-move
sampler), written as plain functions on torch tensors. The two kernels of the
fit-then-sample path are hand-written CUDA C++ for Hopper (``csrc/``); every
other device op is plain PyTorch. Module paths and names follow the JAX
package so that each function's counterpart is easy to find.

Dtypes: float64 on the CPU (the parity tests), float32 on CUDA.
"""

__version__ = "0.1.0"

import torch as _torch

# The likelihood and the GP fit need full float32 matrix products: a
# single-pass reduced-precision product (TF32 here, bf16 on the TPU) puts
# ~1e-3 relative noise into the covariance assembly, which flips marginally
# positive-definite blocks negative and roughens the log-posterior surface.
# Same contract as the JAX package's jax_default_matmul_precision setting.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
