"""The port's spans and counters, and a ``torch.profiler`` trace of a run
(counterpart of ``bayesian_inference_tpu.utils.profiling``).

``annotate(name)`` is the one span. Each records its name, start, end (on the
``time.perf_counter_ns`` clock), parent and the id of its root call, shows up
in a profiler trace (``record_function``) and as an NVTX range on CUDA. A
root call is the outermost span open on its thread: one ``fit_emulators``,
``run_mcmc`` or ``run_closure_batch`` call, or under the steer one stage.
Each thread keeps its own stack of open spans; a finished root call goes,
under a lock, into a bounded history (``history()``, the last
``HISTORY_ROOTS``).

Counters belong to a root call. At its entry and exit the recorder reads the
module counters that registered with ``counter_source`` (kernel launches by
kernel, sampler and fit programs built, graph replays) and keeps their
differences; ``count`` adds to the open root call directly (a step graph's
nodes, at its capture). No span and no counter is touched per step or per
replay, so the recorder is always on.

Usage:
    biq-steer-torch -c config.yaml --profile output/trace
or programmatically:
    with device_trace("output/trace"):
        run_mcmc(...)
The trace is a Chrome trace (``trace.json``); it opens in Perfetto or
chrome://tracing. Beside it ``idle_by_span.json`` lists the device's idle
gaps over the trace, each put down to the innermost span open on the host
when it began and cut where that span changes (``idle_gaps``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import heapq
import itertools
import json
import logging
import os
import threading
import time
from typing import Callable, Iterable

import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
IDLE_FILE = "idle_by_span.json"
HISTORY_ROOTS = 1024
CLOCK_MARKER = "biq.clock"
NO_SPAN = "(no span)"

_local = threading.local()
_lock = threading.Lock()
_history: collections.deque = collections.deque(maxlen=HISTORY_ROOTS)
_open: dict[int, "_Root"] = {}  # thread ident -> its open root call
_ids = itertools.count()
_sources: list[Callable[[], dict[str, int]]] = []
_nvtx: bool | None = None


def counter_source(fn: Callable[[], dict[str, int]]) -> Callable[[], dict[str, int]]:
    """Register ``fn`` (-> {counter name: running total}) as a module
    counter that every root call takes the difference of."""
    _sources.append(fn)
    return fn


def _counters() -> dict[str, int]:
    out: dict[str, int] = {}
    for fn in _sources:
        out.update(fn())
    return out


class _Root:
    __slots__ = ("id", "thread", "spans", "counters", "before")

    def __init__(self, name: str, t0: int):
        self.id = next(_ids)
        self.thread = threading.current_thread().name
        self.spans = [[name, t0, 0, -1]]  # [name, start_ns, end_ns (0 while open), parent index]
        self.counters: collections.Counter = collections.Counter()
        self.before = _counters()

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.spans[0][0], "thread": self.thread,
                "start_ns": self.spans[0][1], "end_ns": self.spans[0][2],
                "spans": [{"name": n, "start_ns": a, "end_ns": b, "parent": p} for n, a, b, p in self.spans],
                "counters": dict(self.counters)}


def _use_nvtx() -> bool:
    global _nvtx
    if _nvtx is None:
        _nvtx = torch.cuda.is_available()
    return _nvtx


class annotate(contextlib.ContextDecorator):
    """A named span of the program (a context manager, or a decorator of a
    function whose every call is one span)."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        return annotate(self.name)

    def __enter__(self):
        t0 = time.perf_counter_ns()
        root = getattr(_local, "root", None)
        if root is None:
            root = _Root(self.name, t0)
            _local.root, _local.stack = root, [0]
            self._index = 0
            with _lock:
                _open[threading.get_ident()] = root
        else:
            self._index = len(root.spans)
            root.spans.append([self.name, t0, 0, _local.stack[-1]])
            _local.stack.append(self._index)
        self._root = root
        if _use_nvtx():
            torch.cuda.nvtx.range_push(self.name)
        self._rf = None
        if torch._C._autograd._profiler_enabled():  # a trace is being taken: the span goes into it
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if _use_nvtx():
            torch.cuda.nvtx.range_pop()
        root, span = self._root, self._root.spans[self._index]
        span[2] = time.perf_counter_ns()
        _local.stack.pop()
        if self._index == 0:
            after = _counters()
            for k, v in after.items():
                if v != root.before.get(k, 0):
                    root.counters[k] += v - root.before.get(k, 0)
            root.before = None
            _local.root = None
            with _lock:
                _open.pop(threading.get_ident(), None)
                _history.append(root)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("[trace:%s] %.3fs", self.name, (span[2] - span[1]) / 1e9)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the root call open on this thread
    (nothing without one)."""
    root = getattr(_local, "root", None)
    if root is not None:
        root.counters[name] += n


def child_seconds(names: dict[str, str]) -> dict[str, float]:
    """Seconds of the finished children of the innermost span open on this
    thread, summed by name: {key: seconds} for each span name -> key of
    ``names`` that has a child, in ``names``' order."""
    root = getattr(_local, "root", None)
    if root is None:
        return {}
    parent = _local.stack[-1]
    total: dict[str, int] = {}
    for name, a, b, p in root.spans:
        if p == parent and b and name in names:
            total[name] = total.get(name, 0) + b - a
    return {names[n]: total[n] / 1e9 for n in names if n in total}


def history() -> list[dict]:
    """The finished root calls, oldest first (the last ``HISTORY_ROOTS``):
    each {"id", "name", "thread", "start_ns", "end_ns", "spans" (the root
    call's own span first; each with "name", "start_ns", "end_ns" and
    "parent", its parent's index), "counters"}."""
    with _lock:
        roots = list(_history)
    return [r.as_dict() for r in roots]


def clear_history() -> None:
    with _lock:
        _history.clear()


def drain(device) -> None:
    """Wait for ``device``'s queued work (nothing on the CPU): a span that
    covers device work ends with it done."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _open_spans(t1: int) -> list[list]:
    """Every span of the history and of the open root calls, each as
    [path, start_ns, end_ns]; an open span ends at ``t1``."""
    with _lock:
        roots = list(_history) + list(_open.values())
    out = []
    for root in roots:
        paths: list[str] = []
        for name, a, b, p in list(root.spans):
            paths.append(name if p < 0 else f"{paths[p]}/{name}")
            out.append([paths[-1], a, b or t1])
    return out


# --------------------------------------------------------------------------------------
# Graph nodes
# --------------------------------------------------------------------------------------

_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> dict[str, int]:
    """The nodes of a captured, not yet instantiated CUDA graph
    (``keep_graph=True``), by type (kernel, memcpy, memset, other), read
    through libcuda (``cuGraphGetNodes``)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    for node in nodes:
        kind = ctypes.c_int(-1)
        if libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[_GRAPH_NODE_TYPES.get(kind.value, "other")] += 1
    return kinds


# --------------------------------------------------------------------------------------
# The device trace
# --------------------------------------------------------------------------------------

def _innermost(spans: Iterable[list]) -> tuple[list[int], list[str]]:
    """The host timeline as segments: (segment starts, the label of the
    shortest span covering each segment, NO_SPAN where none does)."""
    spans = sorted((s for s in spans if s[2] > s[1]), key=lambda s: s[1])
    bounds = sorted({t for _, a, b in spans for t in (a, b)})
    active: list[tuple[int, int]] = []  # (length, index), shortest first; an ended span leaves when it surfaces
    labels, j = [], 0
    for t in bounds:
        while j < len(spans) and spans[j][1] <= t:
            heapq.heappush(active, (spans[j][2] - spans[j][1], j))
            j += 1
        while active and spans[active[0][1]][2] <= t:
            heapq.heappop(active)
        labels.append(spans[active[0][1]][0] if active else NO_SPAN)
    return bounds, labels


def idle_gaps(device: Iterable[tuple[int, int]], spans: Iterable[list], t0: int, t1: int,
              longest: int = 50) -> dict:
    """The device's idle gaps over [t0, t1), each put down to the innermost
    host span open when it began. A gap that runs on past a boundary of the
    host's spans is cut there: each piece goes to the innermost span open
    over it, so the idle time of a span is the time the device idled while
    the host was in it.

    ``device``: the device's operations as (start_ns, end_ns); ``spans``: the
    host's spans as [label, start_ns, end_ns]; all on one clock. Returns
    ``window_s``, ``busy_s`` (the union of the operations), ``idle_s``,
    ``n_gaps`` (the device's gaps, uncut), ``by_span`` ({label: idle
    seconds}, largest first) and ``longest`` (the longest pieces:
    ``start_s`` from t0, ``seconds``, ``span``)."""
    ops = sorted((max(a, t0), min(b, t1)) for a, b in device if b > t0 and a < t1)
    gaps, busy, end = [], 0, t0
    for a, b in ops:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((end, t1))
    bounds, labels = _innermost(spans)
    by_span: dict[str, int] = {}
    pieces = []
    for a, b in gaps:
        i = bisect.bisect_right(bounds, a) - 1
        while a < b:
            cut = min(b, bounds[i + 1]) if i + 1 < len(bounds) else b
            name = labels[i] if i >= 0 else NO_SPAN
            by_span[name] = by_span.get(name, 0) + cut - a
            pieces.append((cut - a, a, name))
            a, i = cut, i + 1
    pieces.sort(key=lambda g: -g[0])
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy / 1e9,
        "idle_s": sum(b - a for a, b in gaps) / 1e9,
        "n_gaps": len(gaps),
        "by_span": {k: v / 1e9 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
        "longest": [{"start_s": (s - t0) / 1e9, "seconds": n / 1e9, "span": name} for n, s, name in pieces[:longest]],
    }


def _device_intervals(prof, sync_ns: int) -> tuple[list[tuple[int, int]], int]:
    """The device operations of a finished profile on the perf_counter_ns
    clock, through the clock marker recorded at ``sync_ns``. A span's range
    on the device's timeline (a user annotation, from the first to the last
    kernel launched inside it) is no operation."""
    device, offset = [], None
    for e in prof.profiler.kineto_results.events():
        if offset is None and e.name() == CLOCK_MARKER:
            offset = e.start_ns() - sync_ns
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    offset = offset or 0
    return [(a - offset, b - offset) for a, b in device], offset


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """``torch.profiler`` trace around a block, host and (when present) CUDA
    activity, written to ``trace_dir/trace.json``, and the device's idle
    gaps by program span to ``trace_dir/idle_by_span.json``; a no-op when
    trace_dir is None."""
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
        with torch.profiler.record_function(CLOCK_MARKER):
            sync_ns = time.perf_counter_ns()
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            end_ns = time.perf_counter_ns()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    device, offset = _device_intervals(prof, sync_ns)
    idle = idle_gaps(device, _open_spans(end_ns), sync_ns, end_ns)
    idle["clock_offset_ns"] = offset
    with open(os.path.join(trace_dir, IDLE_FILE), "w") as f:
        json.dump(idle, f, indent=1)
    logger.info(f"[trace] {time.perf_counter() - t0:.3f}s traced -> {os.path.join(trace_dir, TRACE_FILE)}; device "
                f"idle {idle['idle_s']:.3f} of {idle['window_s']:.3f}s -> {os.path.join(trace_dir, IDLE_FILE)}")
