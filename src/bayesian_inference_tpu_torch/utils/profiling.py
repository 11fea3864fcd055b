"""Profiling / tracing hooks: a ``torch.profiler`` trace of a run and named
regions inside it (counterpart of ``bayesian_inference_tpu.utils.profiling``).

Usage:
    biq-steer-torch -c config.yaml --profile output/trace
or programmatically:
    with device_trace("output/trace"):
        run_mcmc(...)
The trace is a Chrome trace (``trace.json``); it opens in Perfetto or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """``torch.profiler`` trace around a block, host and (when present) CUDA
    activity, written to ``trace_dir/trace.json``; a no-op when trace_dir is
    None."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info(f"Writing device trace to {trace_dir}")
    t0 = time.perf_counter()
    # One profiling cycle; acc_events keeps some torch versions from warning
    # that events of earlier cycles are dropped.
    with torch.profiler.profile(activities=activities, acc_events=True) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    logger.info(f"[trace] {time.perf_counter() - t0:.3f}s traced -> {os.path.join(trace_dir, TRACE_FILE)}")


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in the trace (and as an NVTX range on
    CUDA) and logs wall-clock."""
    t0 = time.perf_counter()
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    logger.info(f"[trace:{name}] {time.perf_counter() - t0:.3f}s")
