"""The per-layer metrics that read the program's own spans and counters
(``pbench/program_spans.py``): each returns None where the program has no
recorder (or one without a history), the right value on a synthetic history,
and a value from the port's recorder after a tiny run on the CPU."""

from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import cell as cell_mod  # noqa: E402
from pbench import program_spans  # noqa: E402

READERS = ("runner_host_s.analysis", "runner_host_s.closure", "captures_per_unit.analysis",
           "captures_per_unit.closure", "captures_per_unit.fit", "fit_prepare_s.fit", "fit_iterations_per_s.fit",
           "step_graph_nodes.analysis")
S = 1_000_000_000  # ns per second


def call(name, start, end, spans=(), counters=None):
    """A root call as the recorder's ``history()`` gives it: spans as
    (name, start, end) in seconds, all children of the root."""
    return {"id": 0, "name": name, "thread": "t", "start_ns": int(start * S), "end_ns": int(end * S),
            "spans": [{"name": name, "start_ns": int(start * S), "end_ns": int(end * S), "parent": -1}]
            + [{"name": n, "start_ns": int(a * S), "end_ns": int(b * S), "parent": 0} for n, a, b in spans],
            "counters": dict(counters or {})}


def ctx_of(*indices):
    return {"units": [{"index": i} for i in indices]}


@pytest.fixture
def recorder(monkeypatch):
    """Install a recorder whose history is the list this returns."""
    calls: list[dict] = []
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, types.SimpleNamespace(history=lambda: list(calls)))
    return calls


@pytest.mark.parametrize("name", READERS)
def test_reader_returns_none_without_a_recorder(name, monkeypatch):
    reader = cell_mod.metric_reader(name)
    monkeypatch.delitem(sys.modules, program_spans.RECORDER, raising=False)
    assert reader.read(ctx_of(0, 1)) is None
    # The parent's recorder: a profiling module with no history.
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, types.SimpleNamespace(annotate=None))
    assert reader.read(ctx_of(0, 1)) is None

    def broken():
        raise RuntimeError("no history")

    monkeypatch.setitem(sys.modules, program_spans.RECORDER, types.SimpleNamespace(history=broken))
    assert reader.read(ctx_of(0, 1)) is None


def test_window_calls_are_the_last_of_their_name(recorder):
    recorder += [call("run_mcmc", 0, 1), call("fit_emulators", 1, 2), call("run_mcmc", 2, 4),
                 call("run_mcmc", 4, 7), call("run_mcmc", 7, 11)]
    # Three units in the window, the first traced and left out of the context.
    got = program_spans.window_calls(ctx_of(1, 2), "run_mcmc")
    assert sorted(got) == [1, 2]
    assert program_spans.seconds(got[1]) == 3 and program_spans.seconds(got[2]) == 4
    assert program_spans.window_calls(ctx_of(0, 1, 2, 3, 4), "run_mcmc") is None  # fewer calls than units


def test_runner_host_seconds(recorder):
    spans = [("likelihood_build", 0.0, 0.1), ("burn", 0.1, 0.5), ("burn.phase1", 0.1, 0.2),
             ("burn.resample", 0.2, 0.3), ("burn.phase2", 0.3, 0.5), ("production", 0.5, 9.5),
             ("chunk", 0.5, 9.0), ("download", 9.0, 9.5), ("statistics", 9.5, 9.9)]
    recorder += [call("run_mcmc", 0, 10, spans), call("run_closure_batch", 10, 20, [(n, a + 10, b + 10)
                                                                                   for n, a, b in spans])]
    host = 10 - (0.1 + 0.2 + 8.5)
    for name in ("runner_host_s.analysis", "runner_host_s.closure"):
        assert cell_mod.metric_reader(name).read(ctx_of(0)) == pytest.approx(host)


def test_captures_per_unit(recorder):
    recorder += [call("fit_emulators", 0, 1, counters={"captures.fit": 2}),
                 call("run_mcmc", 1, 2, counters={"captures.sampler": 1, "launches.gp_predict": 9}),
                 call("fit_emulators", 2, 3), call("run_mcmc", 3, 4, counters={"captures.sampler": 1}),
                 call("run_closure_batch", 4, 5, counters={"captures.sampler": 1}),
                 call("run_closure_batch", 5, 6, counters={"captures.sampler": 1, "captures.fit": 2})]
    assert cell_mod.metric_reader("captures_per_unit.analysis").read(ctx_of(0, 1)) == 2.0
    assert cell_mod.metric_reader("captures_per_unit.analysis").read(ctx_of(1)) == 1.0
    assert cell_mod.metric_reader("captures_per_unit.closure").read(ctx_of(0, 1)) == 2.0
    assert cell_mod.metric_reader("captures_per_unit.fit").read(ctx_of(1)) == 0.0


def test_fit_readers(recorder):
    stages = [("fit.prepare", 0.0, 0.05), ("fit.prepare", 0.05, 0.08), ("fit_gps", 0.1, 0.3),
              ("fit.stage", 0.1, 0.15), ("fit.stage", 0.15, 0.25)]
    recorder += [call("fit_emulators", 0, 0.3, stages, {"replays.fit": 60}),
                 call("fit_emulators", 1, 1.3, [(n, a + 1, b + 1) for n, a, b in stages], {"replays.fit": 60})]
    assert cell_mod.metric_reader("fit_prepare_s.fit").read(ctx_of(0, 1)) == pytest.approx(0.08)
    assert cell_mod.metric_reader("fit_iterations_per_s.fit").read(ctx_of(1)) == pytest.approx(60 / 0.15)
    recorder[-1]["counters"] = {}
    assert cell_mod.metric_reader("fit_iterations_per_s.fit").read(ctx_of(1)) is None  # nothing replayed


def test_step_graph_nodes_reads_the_newest_capture(recorder):
    nodes = {"graph_nodes.sampler.kernel": 24, "graph_nodes.sampler.memcpy": 2, "graph_nodes.sampler.memset": 1,
             "graph_nodes.sampler.other": 5}
    recorder += [call("capture.sampler", 0, 1, counters={k: 2 * v for k, v in nodes.items()}),
                 call("capture.sampler", 1, 2, counters=nodes), call("run_mcmc", 2, 3)]
    assert cell_mod.metric_reader("step_graph_nodes.analysis").read(ctx_of(0)) == 27
    recorder[:] = [call("run_mcmc", 2, 3)]
    assert cell_mod.metric_reader("step_graph_nodes.analysis").read(ctx_of(0)) is None


def test_the_port_recorder_feeds_the_fit_readers(tmp_path):
    """A tiny refit window of two units on the CPU (float64, no graphs):
    the readers find the window's ``fit_emulators`` calls in the port's own
    history."""
    import torch

    from pbench import harness

    class TwoUnits(harness.Run):
        def starts(self, i: int, elapsed: float) -> bool:
            return i < 2

    torch.set_num_threads(4)
    cell = cell_mod.load_cell("substructure_block.refit")
    cell.config = dict(cell.config, n_restarts=1, opt_iters=5)
    run = TwoUnits(cell, 2**31 + 77, 1e-3, False, device="cpu", work_dir=tmp_path / "work")
    try:
        run.measure()
        ctx = run.context()
        assert [u["index"] for u in ctx["units"]] == [0, 1]
        calls = program_spans.window_calls(ctx, "fit_emulators")
        assert sorted(calls) == [0, 1]
        names = [s["name"] for s in calls[1]["spans"]]
        assert names.count("fit.prepare") == 3 and "fit_gps" in names and "fit.artifacts" in names
        assert cell_mod.metric_reader("fit_prepare_s.fit").read(ctx) > 0
        assert cell_mod.metric_reader("captures_per_unit.fit").read(ctx) == 0.0  # set-up built the fit programs
        assert cell_mod.metric_reader("fit_iterations_per_s.fit").read(ctx) is None  # no graph replays on the CPU
    finally:
        run.cleanup()
