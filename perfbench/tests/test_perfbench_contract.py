"""``BENCHMARK.json`` and the files it names: every configuration, traffic,
limits and metric file loads and is referenced, names and units use only the
allowed characters, and every cell reports what it has to."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    # a full check with 24 cells: 2 + 14 x 24 runs, each run_seconds + 60, 2 x 90 s a cell, 1,200 spare
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_text(bench):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]]
                 + [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]
                 + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for p in bench["paths"]:
        assert PATH.match(p)
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        assert PATH.match(str(f.relative_to(ROOT))), f


def test_every_file_is_referenced_and_loads(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used_configs, used_traffic = set(), set()
    for w in bench["workloads"]:
        cfg = configs[w["config"]]
        used_configs.add(cfg["name"])
        used_traffic.add(w["traffic"])
        with open(ROOT / cfg["file"]) as f:
            assert json.load(f)["name"] == cfg["name"]
        with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
            assert json.load(f)["unit"] in ("analysis", "closure", "refit")
        with open(BENCH / "limits" / f"{w['name']}.json") as f:
            assert json.load(f)["numbers"]
    assert used_configs == set(configs)
    assert {p.stem for p in (BENCH / "traffic").glob("*.json")} == used_traffic
    assert {p.stem for p in (BENCH / "configs").glob("*.json")} == {Path(c["file"]).stem for c in configs.values()}
    assert {p.stem for p in (BENCH / "limits").glob("*.json")} == {w["name"] for w in bench["workloads"]}
    metrics = {m["name"] for m in bench["per_layer"]}
    assert {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")} == metrics
    import importlib.util

    for name in metrics:
        spec = importlib.util.spec_from_file_location("m", BENCH / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)


def test_every_cell_reports_what_it_has_to(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        reported = {m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        layer = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and all(m["moves"] in reported for m in layer), w["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["source"] == "device_trace"
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def plain_name(label: str) -> str:
    """A parameter's name without its LaTeX, superscript, underscores and
    case, so that the yaml's ``$\\alpha_S^{\\rm{fix}}$`` and a configuration's
    ``alpha_s`` both read ``alphas``."""
    return re.sub(r"[$\\{}_]", "", label.split("^")[0]).lower()


@pytest.fixture(scope="module")
def yaml_analyses() -> dict:
    import yaml

    with open(ROOT / "config" / "jet_substructure.yaml") as f:
        return yaml.safe_load(f)["analyses"]


def test_configs_state_what_they_are(bench, yaml_analyses):
    """Each configuration is held to the yaml analysis it names: the values
    it shares with it are the yaml's, and every key it changes is listed in
    ``reduced`` and stated in ``assumed``."""
    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["assumed"] and cfg["source"] == c["source"]
        assert cfg["likelihood_mode"] in ("block", "lowrank")
        assert cfg["analysis"] in yaml_analyses and cfg["analysis"] in cfg["source"], c["name"]
        ref = yaml_analyses[cfg["analysis"]]
        pars, groups = ref["parameterization"][cfg["parameterization"]], ref["parameters"]["emulators"]
        assert cfg["parameterization"] in ref["parameterizations"]
        assert [plain_name(n) for n in cfg["parameter_names"]] == [plain_name(n) for n in pars["names"]], c["name"]
        assert (cfg["prior_min"], cfg["prior_max"]) == (pars["min"], pars["max"]), c["name"]
        for key in ("sqrts_list", "centrality_range", "validation_indices"):
            assert cfg[key] == ref[key], (c["name"], key)
        assert cfg["n_walkers"] == ref["parameters"]["mcmc"]["n_walkers"], c["name"]
        k = cfg["kernel"]
        for gname, g in groups.items():
            kernels = g["kernels"]
            assert (list(k["active"]), k["nu"], list(k["length_scale_bounds_factor"])) == (
                kernels["active"], kernels["matern"]["nu"], kernels["matern"]["length_scale_bounds_factor"]), gname
            assert (k["noise_level"], list(k["noise_level_bounds"])) == (
                kernels["noise"]["args"]["noise_level"], kernels["noise"]["args"]["noise_level_bounds"]), gname
            assert cfg["n_restarts"] == g["GPR"]["n_restarts"], gname
        assert [g["n_pc"] for g in cfg["emulators"].values()] == [g["n_pc"] for g in groups.values()], c["name"]
        if "cuts" not in cfg["reduced"]:
            assert cfg.get("cuts", {}) == ref.get("cuts", {}), c["name"]
        if "emulators" not in cfg["reduced"]:
            assert list(cfg["emulators"]) == list(groups), c["name"]
            for gname, g in groups.items():
                assert cfg["emulators"][gname]["observable_list"] == g["observable_list"], (c["name"], gname)
                assert cfg["emulators"][gname].get("observable_exclude_list", []) == \
                    g.get("observable_exclude_list", []), (c["name"], gname)
        # every key in reduced is named, before the colon, by an entry of
        # assumed (a changed group of emulators by its group's name)
        heads = [re.split(r"\W+", a.split(":")[0]) for a in cfg["assumed"]]
        for key in cfg["reduced"]:
            names = {key, *(cfg["emulators"] if key == "emulators" else ())}
            assert any(names & set(h) for h in heads), (c["name"], key)
