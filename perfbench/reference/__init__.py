"""The benchmark's plain float64 reference: the emulated Gaussian likelihood,
the stretch move and the chain statistics, worked out again from the table
files and the configuration file alone.

Plain numpy and torch. It imports neither JAX nor the JAX package nor
anything of the port (``bayesian_inference_tpu_torch``), and it takes none of
the program's derived arrays: it reads the program's outputs (fitted
hyperparameters, chains, log-probabilities, statistics) only to judge them.
"""
