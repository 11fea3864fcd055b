"""The device trace of a traced run: ``torch.profiler`` over one stretch of
the window, reduced to kernel time by name, the device's busy time (the union
of its operations' intervals), and its idle gaps labelled by the harness's
span that was open on the host.

The window's units run on a worker thread; the main thread starts the
profiler before the first unit and stops it when that unit ends or
``trace_seconds`` have passed, whichever is first, so a long unit is traced
over a bounded stretch. The profiler's CUDA activity covers every thread; it
records no host operators of the worker. Spans come from the harness around
its calls into the program, never from inside the program.
"""

from __future__ import annotations

import threading
import time

import torch


class Spans:
    """Host spans (name, start, end) on the ``time.perf_counter_ns`` clock."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def span(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t = time.perf_counter_ns()

            def __exit__(self, *exc):
                with spans._lock:
                    spans.items.append((name, self.t, time.perf_counter_ns()))

        return _Span()

    def label(self, t_ns: int) -> str:
        """The innermost span open at ``t_ns``, or "harness"."""
        best = None
        for name, a, b in self.items:
            if a <= t_ns < b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return best[0] if best else "harness"


class Tracer:
    def __init__(self):
        self.prof = None
        self.offset_ns = 0  # profiler clock - perf_counter_ns
        self.t0 = self.t1 = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function("perfbench.clock"):
            self._sync = time.perf_counter_ns()
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def summary(self, spans: Spans, whole: bool, n_gaps: int = 10, n_ops: int = 10) -> dict:
        """busy_s, window_s, kernel seconds and launches by name, the longest
        idle gaps by host span, and the operations that took most time. The
        stretch runs from the first unit's first span to the trace's end, or
        to that unit's end where it was traced ``whole``."""
        events = self.prof.profiler.kineto_results.events()
        device, clock = [], None
        for e in events:
            if e.name() == "perfbench.clock" and clock is None:
                clock = e.start_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        if clock is not None:
            self.offset_ns = clock - self._sync
        first = [(a, b) for name, a, b in spans.items if name.startswith("unit0.")]
        t0 = max(self.t0, min((a for a, _ in first), default=self.t0))
        t1 = min(self.t1, max((b for _, b in first), default=self.t1)) if whole else self.t1
        lo, hi = t0 + self.offset_ns, t1 + self.offset_ns
        device = sorted((max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi)
        by_name: dict[str, list] = {}
        busy, gaps, cur_a, cur_b = 0, [], None, None
        last_end = lo
        for a, b, name in device:
            entry = by_name.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += b - a
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if a > last_end:
                    gaps.append((a - last_end, last_end))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            last_end = max(last_end, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        if hi > last_end:
            gaps.append((hi - last_end, last_end))
        gaps.sort(reverse=True)
        by_gap: dict[str, float] = {}
        for length, start in gaps:
            label = spans.label(start - self.offset_ns)
            by_gap[label] = by_gap.get(label, 0.0) + length / 1e9
        longest = [[spans.label(start - self.offset_ns), length / 1e9] for length, start in gaps[:n_gaps]]
        ops = sorted(((n, v[1] / 1e9) for n, v in by_name.items()), key=lambda x: -x[1])[:n_ops]
        return {
            "window_s": (hi - lo) / 1e9,
            "busy_s": busy / 1e9,
            "kernels": {n: {"launches": v[0], "seconds": v[1] / 1e9} for n, v in by_name.items()},
            "idle_by_span": by_gap,
            "breakdown": {"device_ops": [[n, s] for n, s in ops], "idle_gaps": longest},
        }


def kernel_time(summary: dict, names) -> tuple[int, float]:
    """(launches of the first name, seconds of all of them) from the trace,
    matching device operation names that contain each name."""
    launches, seconds = 0, 0.0
    for op, v in summary["kernels"].items():
        for i, name in enumerate(names):
            if name in op:
                seconds += v["seconds"]
                if i == 0:
                    launches += v["launches"]
                break
    return launches, seconds


def run_traced(work, trace_seconds: float, first_done: threading.Event, resume: threading.Event):
    """Run ``work()`` (the window) on a worker thread; trace from its start
    until ``first_done`` is set or ``trace_seconds`` pass, then set
    ``resume`` (the window waits for it after its first unit, so that a
    whole unit is traced alone). Returns (the tracer, whether the first unit
    was traced whole) once the work has ended; the worker's exception, if
    any, is raised."""
    tracer = Tracer()
    failure: list[BaseException] = []

    def body():
        try:
            work()
        except BaseException as e:  # noqa: BLE001 -- re-raised on the main thread
            failure.append(e)
            first_done.set()
            resume.set()

    tracer.start()
    worker = threading.Thread(target=body, name="perfbench-window")
    worker.start()
    whole = first_done.wait(timeout=trace_seconds)
    tracer.stop()
    resume.set()
    worker.join()
    if failure:
        raise failure[0]
    return tracer, whole

