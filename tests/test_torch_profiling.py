"""The port's recorder (``utils/profiling``): spans nest and lie inside their
parents, each thread keeps its own stack, the history of root calls is
bounded, counters belong to their root call; the runners and the fit open
their spans once each and read ``timings`` off them; and the device's idle
gaps are put down to the innermost span open on the host."""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from config_factory import make_analysis_yaml

from bayesian_inference_tpu_torch.mcmc import runner as trunner
from bayesian_inference_tpu_torch.models import emulator as temulator
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs
from bayesian_inference_tpu_torch.utils import profiling

N_WALKERS, N_BURN, N_STEPS = 8, 8, 20


def _last(name):
    return [c for c in profiling.history() if c["name"] == name][-1]


def _names(call):
    return [s["name"] for s in call["spans"]]


def test_spans_nest_and_each_child_lies_inside_its_parent():
    with profiling.annotate("t_root"):
        with profiling.annotate("a"):
            with profiling.annotate("a1"):
                time.sleep(0.001)
            with profiling.annotate("a2"):
                pass
        with profiling.annotate("b"):
            pass
    call = _last("t_root")
    spans = call["spans"]
    assert _names(call) == ["t_root", "a", "a1", "a2", "b"]
    assert [s["parent"] for s in spans] == [-1, 0, 1, 1, 0]
    for s in spans[1:]:
        parent = spans[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert spans[2]["end_ns"] <= spans[3]["start_ns"]  # siblings in order
    assert call["start_ns"] == spans[0]["start_ns"] and call["end_ns"] == spans[0]["end_ns"]


def test_a_decorated_function_is_one_span_per_call():
    @profiling.annotate("t_decorated")
    def f(x):
        with profiling.annotate("inside"):
            return x + 1

    assert f(1) == 2 and f(2) == 3
    calls = [c for c in profiling.history() if c["name"] == "t_decorated"][-2:]
    assert [_names(c) for c in calls] == [["t_decorated", "inside"]] * 2
    assert calls[0]["id"] != calls[1]["id"]


def test_each_thread_keeps_its_own_stack():
    """A span opened on a worker thread while the main thread has one open
    is a root call of its own, not a child of the main thread's."""
    started, release = threading.Event(), threading.Event()

    def worker():
        with profiling.annotate("t_worker"):
            started.set()
            with profiling.annotate("w_child"):
                release.wait(5)

    with profiling.annotate("t_main"):
        t = threading.Thread(target=worker, name="t-worker")
        t.start()
        started.wait(5)
        with profiling.annotate("m_child"):
            release.set()
        t.join()
    main, work = _last("t_main"), _last("t_worker")
    assert _names(main) == ["t_main", "m_child"] and _names(work) == ["t_worker", "w_child"]
    assert work["thread"] == "t-worker" and main["id"] != work["id"]


def test_threads_record_their_root_calls_whole_under_contention():
    """More threads than cores, switching often, each opening root calls
    with children: every root call reaches the history with its own spans
    only."""
    import sys

    n_threads, n_calls = 16, 40
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_calls):
                with profiling.annotate(f"t_stress{k}"):
                    with profiling.annotate(f"s{k}.{i}"):
                        with profiling.annotate(f"s{k}.{i}.inner"):
                            pass
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    calls = [c for c in profiling.history() if c["name"].startswith("t_stress")]
    assert len(calls) == n_threads * n_calls
    for c in calls:
        k = c["name"][len("t_stress"):]
        names = _names(c)
        assert len(names) == 3 and names[1].startswith(f"s{k}.") and names[2] == names[1] + ".inner"
        assert [s["parent"] for s in c["spans"]] == [-1, 0, 1]


def test_the_history_is_bounded():
    for i in range(profiling.HISTORY_ROOTS + 5):
        with profiling.annotate(f"t_bound{i}"):
            pass
    names = [c["name"] for c in profiling.history()]
    assert len(names) == profiling.HISTORY_ROOTS
    assert names[-1] == f"t_bound{profiling.HISTORY_ROOTS + 4}" and names[0] == "t_bound5"


def test_counters_are_scoped_to_their_root_call(monkeypatch):
    state = {"n": 0}
    monkeypatch.setattr(profiling, "_sources", [*profiling._sources, lambda: {"t.module": state["n"]}])
    state["n"] = 10  # before any root call: belongs to none
    with profiling.annotate("t_count_a"):
        with profiling.annotate("child"):
            state["n"] += 3
        profiling.count("t.direct", 2)
    with profiling.annotate("t_count_b"):
        pass
    state["n"] += 1  # after: belongs to none
    profiling.count("t.direct", 7)  # no root call open: dropped
    a, b = _last("t_count_a"), _last("t_count_b")
    assert a["counters"] == {"t.module": 3, "t.direct": 2}
    assert b["counters"] == {}


def test_child_seconds_sum_the_open_span_s_children():
    with profiling.annotate("t_children"):
        for _ in range(2):
            with profiling.annotate("x"):
                time.sleep(0.002)
        with profiling.annotate("y"):
            with profiling.annotate("x"):  # a grandchild: not counted
                time.sleep(0.002)
        got = profiling.child_seconds({"x": "ex", "y": "why", "z": "zed"})
    spans = _last("t_children")["spans"]
    assert list(got) == ["ex", "why"]
    assert got["ex"] == pytest.approx(sum(s["end_ns"] - s["start_ns"] for s in spans[1:3]) / 1e9)
    assert got["ex"] >= 0.004 and got["why"] >= 0.002


def _span(name, a, b):
    """A host span of [a, b) milliseconds, in nanoseconds."""
    return [name, a * 1_000_000, b * 1_000_000]


def _ops(*intervals):
    return [(a * 1_000_000, b * 1_000_000) for a, b in intervals]


def test_idle_gaps_go_to_the_innermost_open_span():
    """Synthetic device intervals over a host timeline of nested spans
    (milliseconds): each gap goes to the shortest span open at its start, and
    is cut where the host's innermost span changes."""
    spans = [_span("root", 1000, 10000), _span("root/burn", 2000, 4000), _span("root/burn/resample", 3000, 4000),
             _span("root/production", 4000, 9000), _span("other", 9500, 12000)]
    device = _ops((500, 1500), (1200, 2500), (3500, 6000), (5500, 8900), (9600, 9700), (11000, 20000))
    out = profiling.idle_gaps(device, spans, 0, 12_000_000_000, longest=3)
    assert out["window_s"] == 12
    assert out["busy_s"] == pytest.approx(1.0 + 1.0 + 2.5 + 2.9 + 0.1 + 1.0)  # overlaps merged, the last clipped
    assert out["n_gaps"] == 4
    assert out["idle_s"] == pytest.approx(12 - out["busy_s"])
    assert out["by_span"] == pytest.approx({"(no span)": 0.5, "root/burn": 0.5, "root/burn/resample": 0.5,
                                            "root/production": 0.1, "root": 0.5, "other": 1.4})
    assert next(iter(out["by_span"])) == "other"
    assert [(g["span"], g["start_s"]) for g in out["longest"]] == [("other", 10.0), ("(no span)", 0.0),
                                                                    ("root/burn", 2.5)]
    assert [g["seconds"] for g in out["longest"]] == pytest.approx([1.0, 0.5, 0.5])


def test_idle_gaps_of_an_idle_device_and_of_overlapping_spans():
    out = profiling.idle_gaps([], [_span("a", 0, 2000), _span("a/b", 500, 1000)], 700_000_000, 3_000_000_000)
    assert out["busy_s"] == 0 and out["n_gaps"] == 1 and out["idle_s"] == pytest.approx(2.3)
    assert out["by_span"] == pytest.approx({"a/b": 0.3, "a": 1.0, "(no span)": 1.0})
    # A span of another thread overlapping without nesting: the shorter wins while it is open.
    out = profiling.idle_gaps(_ops((1000, 1100)), [_span("long", 0, 10000), _span("short", 1050, 2000)],
                              0, 3_000_000_000)
    assert out["by_span"] == pytest.approx({"long": 2.0, "short": 0.9})


def test_device_trace_writes_idle_by_span(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("t_traced"):
            with profiling.annotate("t_inner"):
                time.sleep(0.01)
    idle = json.loads((tmp_path / "trace" / profiling.IDLE_FILE).read_text())
    assert (tmp_path / "trace" / profiling.TRACE_FILE).exists()
    assert set(idle) >= {"window_s", "busy_s", "idle_s", "n_gaps", "by_span", "longest"}
    assert idle["window_s"] >= 0.01 and idle["idle_s"] == pytest.approx(idle["window_s"] - idle["busy_s"])


# --------------------------------------------------------------------------------------
# The program's spans
# --------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The fixture analysis (2 + 2 PCs), fitted on the CPU in memory."""
    tmp = tmp_path_factory.mktemp("torch_profiling")
    path, name, param = make_analysis_yaml(tmp, n_walkers=N_WALKERS, n_burn_steps=N_BURN,
                                           n_sampling_steps=N_STEPS, n_restarts=1)
    ac = tconfigs.load_yaml(path)["analyses"][name]
    kw = dict(analysis_name=name, parameterization=param, analysis_config=ac, config_file=str(path))
    emu = tconfigs.EmulationConfig.from_config_file(**kw)
    artifacts = temulator.fit_emulators(emu, seed=0, n_opt_iters=5, device="cpu", write=False)
    return SimpleNamespace(emu=emu, artifacts=artifacts, fit=_last("fit_emulators"),
                           mcmc=tconfigs.MCMCConfig(**kw))


def test_fit_emulators_opens_its_spans(tiny):
    names = _names(tiny.fit)
    assert names[0] == "fit_emulators"
    assert names.count("fit.prepare") == 2  # one per group
    for name in ("fit_gps", "fit.stage", "fit.artifacts"):
        assert names.count(name) == 1, name
    spans = tiny.fit["spans"]
    stage = spans[names.index("fit.stage")]
    assert spans[stage["parent"]]["name"] == "fit_gps"


RUN_MCMC_SPANS = ("likelihood_build", "programs", "capture.sampler", "burn", "burn.phase1", "burn.resample",
                  "burn.phase2", "production", "chunk", "download", "statistics", "statistics.host", "write")
CLOSURE_SPANS = ("build", "likelihood_build", "programs", "burn", "burn.phase1", "burn.resample", "burn.capture",
                 "burn.phase2", "production", "chunk", "download", "statistics", "statistics.host", "outputs")


def test_run_mcmc_opens_each_span_once_and_reads_timings_off_them(tiny):
    out = trunner.run_mcmc(tiny.mcmc, seed=1, device="cpu", emulation_results=tiny.artifacts, write=False)
    call = _last("run_mcmc")
    names = _names(call)
    for name in RUN_MCMC_SPANS:
        assert names.count(name) == 1, name
    assert list(out["timings"]) == ["burn", "production", "autocorr", "write"]
    by_name = {s["name"]: (s["end_ns"] - s["start_ns"]) / 1e9 for s in call["spans"]}
    assert out["timings"]["burn"] == by_name["burn"] and out["timings"]["autocorr"] == by_name["statistics"]
    assert call["counters"]["captures.sampler"] == 1  # built inline: no prewarmed handle


def test_run_closure_batch_opens_each_span_once(tiny):
    out = trunner.run_closure_batch(tiny.mcmc, [0, 1], seed=1, device="cpu", emulation_results=tiny.artifacts,
                                    write=False)
    call = _last("run_closure_batch")
    names = _names(call)
    for name in CLOSURE_SPANS:
        assert names.count(name) == 1, name
    assert names.count("capture.sampler") == 2  # the batch's programs, and phase 2's in every batch
    assert list(out[0]["timings"]) == ["build", "burn", "production", "autocorr", "write"]
    assert out[0]["timings"] is out[1]["timings"]
    assert call["counters"]["captures.sampler"] == 2


def test_no_span_is_opened_per_step(tiny, monkeypatch):
    """A run of twice the steps opens the same spans."""
    def spans_of(n_steps):
        monkeypatch.setattr(tiny.mcmc, "n_sampling_steps", n_steps)
        trunner.run_mcmc(tiny.mcmc, seed=2, device="cpu", emulation_results=tiny.artifacts, write=False)
        return _names(_last("run_mcmc"))

    assert spans_of(N_STEPS) == spans_of(2 * N_STEPS)
