"""The harness of the port's benchmark: cells, set-up, the measured window,
the trace's reduction and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, per-layer metric or
kernel lives in files of its own under ``perfbench/`` (``configs/``,
``traffic/``, ``limits/``, ``metrics/``, ``roofline/``), found by the names
in ``BENCHMARK.json``. The harness imports torch and the port
(``bayesian_inference_tpu_torch``), never JAX or the JAX package.
"""
