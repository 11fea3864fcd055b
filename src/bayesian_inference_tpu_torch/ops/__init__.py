"""Device ops: GP kernels, the blocked Cholesky inverse (kernel K3) and the
fused block-MVN log-likelihood (kernel K1). Kernel sources are in ``csrc/``."""
