"""The port's measurement entry points, ``bench_torch.py`` and
``scripts/bench_closure_torch.py``, on the CPU: the fixture's ``.npz`` export
against ``observables.h5``, the configuration dict against the YAML that
``bench.py`` writes, a tiny run of each bench (the JSON line's keys, the
gates, no JAX, h5py or yaml imported), a failed gate, the FLOP counts
against the JAX package's, and no fallback to the CPU."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
import yaml

from bayesian_inference_tpu.mcmc import programs as jprograms
from bayesian_inference_tpu.pipeline import configs as jconfigs
from bayesian_inference_tpu.utils import flops as jflops
from bayesian_inference_tpu_torch.io import hdf5 as thdf5
from bayesian_inference_tpu_torch.mcmc import programs as tprograms

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench_torch  # noqa: E402

# bench.py's JSON line (bench.py:480-497) less the TPU link's keys and the
# TPU target, and the keys of the profile nested under its name.
BENCH_KEYS = {"metric", "value", "unit", "profile", "n_observables", "n_features", "min", "reps", "phases",
              "flops", "likelihood_mode"}
DROPPED = {"vs_baseline", "chain_transfer", "link_MBps", "hedges_fired"}
NESTED_KEYS = {"value", "min", "reps", "phases", "flops", "n_observables", "n_features"}
FLOPS_KEYS = {"per_step", "fit_total", "steps_per_s", "mcmc_tflops", "fit_tflops", "tflops_achieved",
              "peak_tflops_fp32", "mfu"}
# scripts/bench_closure.py's line (:114-132) less chain_transfer, with the
# device budget in place of hbm_budget_MB.
CLOSURE_KEYS = {"metric", "value", "unit", "likelihood_mode", "n_points", "n_walkers", "n_steps", "point_steps_per_s",
                "full_batch_slab_GB", "dispatch_chunk", "closure_device_budget_bytes", "peak_allocated_bytes",
                "device"}
PHASES = {"fit", "burn", "production", "autocorr", "write"}
# The tiny CPU run: 8 walkers, 20 + 50 steps, 1 restart, 3 iterations, 2
# reps, 2 closure points.
TINY = {"BENCH_DEVICE": "cpu", "BENCH_WALKERS": "8", "BENCH_BURN": "20", "BENCH_STEPS": "50", "BENCH_RESTARTS": "1",
        "BENCH_OPT_ITERS": "3", "BENCH_REPS": "2", "BENCH_CLOSURE_WALKERS": "8", "BENCH_CLOSURE_STEPS": "50",
        "BENCH_CLOSURE_POINTS": "2", "BENCH_CLOSURE_CHUNK": "20"}
FORBIDDEN = ("jax", "jaxlib", "bayesian_inference_tpu", "h5py", "yaml")


def _bench_env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    return {**env, **extra}


def test_fixture_npz_is_the_h5_read():
    """observables_fixture.npz loads to the dict the port's io/hdf5 reads from
    observables.h5, leaf for leaf and bit for bit; every leaf is float64."""
    ref = thdf5.read_dict_from_h5(str(bench_torch.FIXTURE_H5.parent), bench_torch.FIXTURE_H5.name, verbose=False)
    got = bench_torch.fixture_observables()
    flat_ref, flat_got = bench_torch.flatten(ref), bench_torch.flatten(got)
    assert sorted(flat_got) == sorted(flat_ref) and len(flat_ref) > 100
    assert list(got["Prediction"]) == list(ref["Prediction"])
    for key, value in flat_ref.items():
        assert flat_got[key].dtype == value.dtype == np.float64, key
        assert flat_got[key].shape == value.shape and flat_got[key].tobytes() == value.tobytes(), key


def test_export_fixture_round_trip(tmp_path):
    """export_fixture writes what fixture_observables reads back."""
    out = tmp_path / "fixture.npz"
    flat = bench_torch.export_fixture(out=out)
    back = bench_torch.flatten(bench_torch.fixture_observables(out))
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], v) for k, v in flat.items())


@pytest.mark.parametrize("env", [{}, {"BENCH_WALKERS": "200", "BENCH_RESTARTS": "4", "BENCH_STEPS": "1234",
                                      "BENCH_BURN": "300", "BENCH_LIKELIHOOD_MODE": "lowrank"}],
                         ids=["defaults", "knobs"])
def test_config_is_bench_py_yaml(tmp_path, env):
    """bench_torch's config dict for both profiles equals the YAML that
    bench.py's _make_config writes under the same knobs; bench.py runs in a
    subprocess, so that its import-time jax.config and logging set-up stay
    out of this worker."""
    table_dir = str(tmp_path / "tables")
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import bench\n"
        "wd, table_dir, mode = Path(sys.argv[1]), sys.argv[2], sys.argv[3]\n"
        "for name in ('fixture', 'production'):\n"
        "    (wd / name).mkdir()\n"
        "print(bench._make_config(wd / 'fixture', bench.FIXTURE_GROUPS, likelihood_mode=mode)[0])\n"
        "print(bench._make_config(wd / 'production', bench.PRODUCTION_GROUPS, table_dir, [17, 43],"
        " likelihood_mode=mode)[0])\n"
    )
    mode = env.get("BENCH_LIKELIHOOD_MODE", "")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path), table_dir, mode], cwd=REPO,
                          env={**_bench_env(env), "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fixture_yaml, production_yaml = proc.stdout.split()
    s = bench_torch.Settings.from_env(env)
    fixture = bench_torch.make_config(tmp_path / "fixture", bench_torch.FIXTURE_GROUPS, s)
    production = bench_torch.make_config(tmp_path / "production", bench_torch.PRODUCTION_GROUPS, s, table_dir,
                                         bench_torch.PRODUCTION_EXCLUDE)
    assert fixture == yaml.safe_load(Path(fixture_yaml).read_text())
    assert production == yaml.safe_load(Path(production_yaml).read_text())
    mcmc = production["analyses"]["bench"]["parameters"]["mcmc"]
    assert (mcmc["n_walkers"], mcmc.get("likelihood_mode", "block")) == (s.walkers, s.likelihood_mode)


# Runs both benches' main() in one fresh process and reports what it imported.
DRIVER = """
import importlib.util, json, sys
from pathlib import Path
repo, work = Path(sys.argv[1]), Path(sys.argv[2])
sys.path[:0] = [str(repo), str(repo / 'src')]
import torch
torch.set_num_threads(1)
import bench_torch
bench_torch.WORK_DIR = work
spec = importlib.util.spec_from_file_location('bench_closure_torch', repo / 'scripts' / 'bench_closure_torch.py')
closure = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = closure
spec.loader.exec_module(closure)
import chip_smoke
rc = bench_torch.main([]) or closure.main()
print(json.dumps(sorted(n for n in sys.modules if n.split('.')[0] in {forbidden})))
sys.exit(rc)
"""


def test_tiny_runs_of_both_benches(tmp_path):
    """A tiny CPU run of each bench, both profiles, both closure points: one
    JSON line each, with bench.py's (bench_closure.py's) keys less the
    dropped ones, every gate passed; neither bench nor chip_smoke.py imports
    JAX, the JAX package, h5py or yaml; nothing is written outside the work
    directory."""
    records = sorted(REPO.glob("CLOSURE_BENCH*.json"))
    before = {p: p.read_bytes() for p in records}
    proc = subprocess.run([sys.executable, "-c", DRIVER.format(forbidden=FORBIDDEN), str(REPO), str(tmp_path)],
                          cwd=tmp_path, env=_bench_env(TINY), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-5000:]
    bench_line, closure_line, imported = (json.loads(line) for line in proc.stdout.strip().splitlines())
    assert imported == []

    assert BENCH_KEYS <= set(bench_line) and not DROPPED & set(bench_line)
    assert bench_line["metric"] == bench_torch.METRIC and bench_line["profile"] == "production"
    assert NESTED_KEYS <= set(bench_line["fixture"]) and not DROPPED & set(bench_line["fixture"])
    for res in (bench_line, bench_line["fixture"]):
        assert set(res["flops"]) == FLOPS_KEYS and res["flops"]["mfu"] is None  # no peak on the CPU
        assert set(res["phases"]) == PHASES and len(res["reps"]) == 2
        assert res["value"] == np.median(res["reps"]) and res["min"] == min(res["reps"])
        assert res["likelihood_check_rel"] <= bench_torch.LOGP_TOL
        for rep in res["rep_details"]:
            assert rep["programs_built"] == {"fit": 0, "sampler": 0}
            assert bench_torch.ACCEPTANCE_RANGE[0] < rep["acceptance"] < bench_torch.ACCEPTANCE_RANGE[1]
    assert (bench_line["n_observables"], bench_line["n_features"], bench_line["n_design"]) == (144, 1644, 195)
    assert (bench_line["fixture"]["n_observables"], bench_line["fixture"]["n_features"]) == (16, 215)
    assert bench_line["device"] == "cpu" and bench_line["card"] is None

    assert CLOSURE_KEYS <= set(closure_line) and "chain_transfer" not in closure_line
    assert (closure_line["n_points"], closure_line["n_walkers"], closure_line["n_steps"]) == (2, 8, 50)
    assert closure_line["point_steps_per_s"] == 2 * 50 / closure_line["value"]
    # The header, then one record per dispatch chunk of 20 steps.
    assert closure_line["checkpoint"]["appends"] == 1 + 3 and closure_line["checkpoint"]["bytes"] > 0
    assert closure_line["programs_built"] == {"fit": 0, "sampler": 1}  # burn-in phase 2's, built inline
    assert {p: p.read_bytes() for p in sorted(REPO.glob("CLOSURE_BENCH*.json"))} == before
    written = {p.name for p in tmp_path.iterdir()}
    assert "bench_torch_production_tables" in written
    assert written <= {"bench_torch_fixture", "bench_torch_production", "bench_torch_production_tables",
                       "bench_torch_closure_block"}


def test_failed_gate_prints_no_line(monkeypatch, capsys):
    """A gate that fails raises out of main(): no result line is printed."""
    for key, value in {**TINY, "BENCH_PROFILE": "fixture", "BENCH_REPS": "1"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(bench_torch, "ACCEPTANCE_RANGE", (0.95, 1.0))
    with pytest.raises(bench_torch.GateFailed, match="mean acceptance"):
        bench_torch.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mode", ["block", "lowrank"])
@pytest.mark.parametrize("walkers", [100, 200])
def test_flop_counts_equal_jax(tmp_path, mode, walkers):
    """bench_torch's FLOP counts (per step from the likelihood's shapes, per
    fit from the schedule) equal the JAX package's utils/flops.py counts for
    the same shapes: the fixture profile's placeholder likelihood, built by
    each package from the same configuration."""
    s = bench_torch.Settings(walkers=walkers, likelihood_mode=mode)
    config = bench_torch.make_config(tmp_path, bench_torch.FIXTURE_GROUPS, s)
    observables = bench_torch.fixture_observables()
    temu, tmcmc = bench_torch.run_configs(config)
    box = tmcmc.parameterization_spec()
    lo, hi = np.asarray(box["min"], float), np.asarray(box["max"], float)
    tspec = tprograms.likelihood_shape_spec(temu, lo, hi, mode=mode, device="cpu", observables=observables)
    groups = list(temu.emulation_groups_config.values())
    k = sum(g.n_pc for g in groups)
    n_design = observables["Design"].shape[0]
    fit_spec = groups[0].fit_spec(n_iters=s.opt_iters)
    step, fit = bench_torch.flop_counts(tspec, s, n_design, lo.size, k, fit_spec)

    path = tmp_path / "bench.yaml"
    path.write_text(yaml.safe_dump(config))
    run_dir = Path(temu.output_dir)
    run_dir.mkdir(parents=True)
    (run_dir / "observables.h5").write_bytes(bench_torch.FIXTURE_H5.read_bytes())
    analysis = config["analyses"][bench_torch.ANALYSIS]
    jemu = jconfigs.EmulationConfig.from_config_file(bench_torch.ANALYSIS, bench_torch.PARAMETERIZATION, str(path),
                                                     analysis)
    jspec = jprograms.likelihood_shape_spec(jemu, lo, hi, mode=mode)
    assert step == jflops.mcmc_step_flops(jspec, walkers) > 0
    assert fit == jflops.fit_total_flops(N=n_design, d=lo.size, k_pcs=k, n_restarts=s.restarts, n_iters=s.opt_iters,
                                         halving_iters=15, halving_keep=3) > 0
    assert (fit_spec.halving_iters, fit_spec.halving_keep) == (15, 3)


def test_bench_device_defaults_to_the_card(monkeypatch):
    """With BENCH_DEVICE unset both benches ask for the card and raise here,
    before any work: nothing falls back to the CPU."""
    for key in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(key)
    assert bench_torch.Settings.from_env().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    spec = importlib.util.spec_from_file_location("bench_closure_torch", REPO / "scripts" / "bench_closure_torch.py")
    closure = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, closure)
    spec.loader.exec_module(closure)
    for main in (lambda: bench_torch.main([]), closure.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
