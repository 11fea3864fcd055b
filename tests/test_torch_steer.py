"""The port's steer entry point and the runners' checkpoint/resume, on the
bundled fixture: resume bit-equal to an uninterrupted run at the same
cadence (run_mcmc in both likelihood modes, the closure batch), a foreign or
torn checkpoint, the steer's artifacts and plots against the JAX steer's on
the same tiny config, its in-memory mode (also with groups already fitted on
disk), its refusals, and the profiling hooks."""

import importlib.util
import json
import os
import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
import yaml
from config_factory import make_analysis_yaml

from bayesian_inference_tpu_torch.io import hdf5 as thdf5
from bayesian_inference_tpu_torch.mcmc import runner as trunner
from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms
from bayesian_inference_tpu_torch.models import emulator as temulator
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs
from bayesian_inference_tpu_torch.pipeline import steer as tsteer
from bayesian_inference_tpu_torch.utils import profiling

N_WALKERS, N_BURN, N_STEPS, CADENCE = 12, 16, 40, 10  # four production chunks


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """The fixture analysis (2 + 2 PCs) fitted by the port, emulators in memory."""
    tmp = tmp_path_factory.mktemp("torch_resume")
    path, name, param = make_analysis_yaml(tmp, n_walkers=N_WALKERS, n_burn_steps=N_BURN,
                                           n_sampling_steps=N_STEPS, n_restarts=1)
    ac = tconfigs.load_yaml(path)["analyses"][name]
    kw = dict(analysis_name=name, parameterization=param, analysis_config=ac, config_file=str(path))
    emu = tconfigs.EmulationConfig.from_config_file(**kw)
    artifacts = temulator.fit_emulators(emu, seed=0, n_opt_iters=20, device="cpu", write=False)
    return SimpleNamespace(config=tconfigs.MCMCConfig(**kw), artifacts=artifacts)


def _interrupt_after(monkeypatch, n_calls):
    """Make the sampler programs' ``chunk`` (every burn-in phase and
    production chunk of both runners) raise on its call after ``n_calls``
    calls, as a run killed during that chunk would stop."""
    inner = SamplerPrograms.chunk
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(1)
        if len(calls) > n_calls:
            raise KeyboardInterrupt("interrupted")
        return inner(*args, **kwargs)

    monkeypatch.setattr(SamplerPrograms, "chunk", wrapper)


def _tear_last_record(path):
    """Cut the checkpoint's last record short, as a crash while writing it would."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)


@pytest.mark.parametrize("mode,torn", [("block", False), ("lowrank", True)])
def test_run_mcmc_resume_is_bit_exact(fitted, monkeypatch, mode, torn):
    """A run interrupted during its third production chunk (after two
    checkpoint records) and run again resumes without burn-in and equals the
    uninterrupted run at the same cadence: chain, log-probs, acceptance,
    burn-in log-probs and R-hat. With the last record torn it resumes from
    the one before. The checkpoint is gone once a run completes."""
    r = fitted
    kw = dict(seed=1, device="cpu", emulation_results=r.artifacts, write=False, mode=mode, checkpoint_every=CADENCE)
    path = trunner._checkpoint_path(r.config)
    whole = trunner.run_mcmc(r.config, **kw)
    assert not os.path.exists(path)

    _interrupt_after(monkeypatch, 2 + 2)  # two burn-in phases, two production chunks
    with pytest.raises(KeyboardInterrupt):
        trunner.run_mcmc(r.config, **kw)
    monkeypatch.undo()
    with open(path, "rb") as f:
        header = pickle.load(f)
        records = [pickle.load(f), pickle.load(f)]
    assert (header["n_total"], header["seed"], header["mode"]) == (N_STEPS, 1, mode)
    assert [rec["steps_done"] for rec in records] == [CADENCE, 2 * CADENCE]
    if torn:
        _tear_last_record(path)

    calls = []
    inner = SamplerPrograms.chunk
    monkeypatch.setattr(SamplerPrograms, "chunk", lambda *a, **k: calls.append(a[3]) or inner(*a, **k))
    resumed = trunner.run_mcmc(r.config, **kw)
    assert calls == [CADENCE] * (3 if torn else 2)  # production chunks only: no burn-in
    assert not os.path.exists(path)
    for key in ("chain", "log_prob", "acceptance_fraction", "burn_log_prob", "split_rhat"):
        np.testing.assert_array_equal(resumed[key], whole[key], err_msg=key)


def test_closure_batch_resume_is_bit_exact(fitted, monkeypatch):
    """The closure batch over two validation points, interrupted during its
    third chunk and resumed, equals the uninterrupted batch point by point;
    the header pins the point indices and each record holds one generator
    state per point."""
    r = fitted
    kw = dict(seed=0, device="cpu", emulation_results=r.artifacts, write=False, checkpoint_every=CADENCE)
    path = trunner._closure_checkpoint_path(r.config)
    whole = trunner.run_closure_batch(r.config, (0, 2), **kw)
    assert not os.path.exists(path)
    _interrupt_after(monkeypatch, 2 + 2)
    with pytest.raises(KeyboardInterrupt):
        trunner.run_closure_batch(r.config, (0, 2), **kw)
    monkeypatch.undo()
    with open(path, "rb") as f:
        header, record = pickle.load(f), pickle.load(f)
    assert header["indices"] == [0, 2] and len(record["generator_states"]) == 2
    resumed = trunner.run_closure_batch(r.config, (0, 2), **kw)
    assert not os.path.exists(path)
    for i in (0, 2):
        for key in ("chain", "log_prob", "acceptance_fraction", "split_rhat"):
            np.testing.assert_array_equal(resumed[i][key], whole[i][key], err_msg=f"{i}/{key}")


def test_foreign_checkpoint_restarts_fresh(fitted, monkeypatch, caplog):
    """A checkpoint left by a run with another seed is not resumed from: the
    run warns, starts fresh and equals a run that found no checkpoint."""
    r = fitted
    kw = dict(device="cpu", emulation_results=r.artifacts, write=False, checkpoint_every=CADENCE)
    _interrupt_after(monkeypatch, 2 + 1)
    with pytest.raises(KeyboardInterrupt):
        trunner.run_mcmc(r.config, seed=5, **kw)
    monkeypatch.undo()
    assert os.path.exists(trunner._checkpoint_path(r.config))
    with caplog.at_level("WARNING", logger=trunner.__name__):
        other = trunner.run_mcmc(r.config, seed=6, **kw)
    assert "belongs to another run (seed: 5 != 6)" in caplog.text
    fresh = trunner.run_mcmc(r.config, seed=6, **kw)
    np.testing.assert_array_equal(other["chain"], fresh["chain"])
    np.testing.assert_array_equal(other["burn_log_prob"], fresh["burn_log_prob"])


def _steer_yaml(tmp_path, plots: bool = False):
    """A tiny steer config over the fixture: preprocessing (downstream stages
    read observables_preprocessed.h5), two groups one of which asks for CV,
    MCMC with a checkpoint cadence, and the closure batch over two points.
    With ``plots``, every plot toggle is on, and the input-data correlation
    study renders one grid (its render cost grows with the bins squared)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    groups = {"group_ch": {"n_pc": 2, "observable_list": ["pt_ch_"], "cross_validation": True,
                           "cross_validation_k": 2},
              "group_pi": {"n_pc": 2, "observable_list": ["pt_pi"]}}
    path, name, _ = make_analysis_yaml(tmp_path, groups=groups, n_walkers=8, n_burn_steps=8,
                                       n_sampling_steps=16, n_restarts=1, copy_observables=False)
    cfg = yaml.safe_load(path.read_text())
    cfg.update(preprocess_input_data=True, run_closure_tests=True,
               observables_filename="observables_preprocessed.h5")
    cfg["analyses"][name]["validation_indices"] = [200, 202]
    cfg["analyses"][name]["parameters"]["mcmc"]["checkpoint_every"] = 6
    if plots:
        cfg["plot"] = {key: True for key in cfg["plot"]}
        cfg.update(plot_correlations_full=False, plot_correlations_max_rendered=1)
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def _artifacts(output_dir: Path) -> dict[str, list[str]]:
    """{relative file path: its h5 keys (group and dataset paths), or the
    top-level keys of a pickled dict}."""
    import h5py

    out = {}
    for p in sorted(output_dir.rglob("*")):
        if not p.is_file():
            continue
        keys = []
        if p.suffix == ".h5":
            with h5py.File(p, "r") as f:
                f.visit(keys.append)
        elif p.name.startswith("emulation"):
            with open(p, "rb") as f:
                keys = list(pickle.load(f))
        out[str(p.relative_to(output_dir))] = sorted(keys)
    return out


def test_steer_writes_the_artifacts_of_the_jax_steer(tmp_path):
    """The port's CLI (``--device cpu --x64``) and the JAX steer on the same
    tiny config, every plot toggle on: the same files under output_dir (the
    plots' PDFs among them), with the same h5 keys and emulator artifact
    keys; no checkpoint left behind. The same config run in memory (config
    dict, write=False, plots off) writes no artifact and gives the same
    chain as the run through files."""
    from bayesian_inference_tpu.pipeline.steer import SteerAnalysis as JaxSteer

    path, cfg = _steer_yaml(tmp_path / "torch", plots=True)
    tsteer.main(["-c", str(path), "--device", "cpu", "--x64"])
    jpath, _ = _steer_yaml(tmp_path / "jax", plots=True)
    JaxSteer(config_file=str(jpath)).run_analysis()

    ours = _artifacts(tmp_path / "torch" / "output")
    ref = _artifacts(tmp_path / "jax" / "output")
    assert list(ours) == list(ref)
    assert ours == ref
    run = "analysis_test_exponential"
    assert f"{run}/cross_validation_group_ch.h5" in ours and f"{run}/closure/results/1/mcmc.h5" in ours
    assert not [p for p in ours if "checkpoint" in p]
    for plot_dir in ("plot_input_data", "plot_emulation", "plot_mcmc", "plot_qhat", "plot_closure"):
        assert [p for p in ours if p.startswith(f"{run}/{plot_dir}/") and p.endswith(".pdf")], plot_dir
    assert "qhat_across_analyses.pdf" in ours

    mem_dir = tmp_path / "memory"
    mem_cfg = {**cfg, "output_dir": str(mem_dir / "output"), "plot": {key: False for key in cfg["plot"]}}
    results = tsteer.SteerAnalysis(config=mem_cfg, device="cpu", write=False).run_analysis()
    result = results[run]
    assert sorted(result["timings"]) == ["closure", "cross_validation", "fit_emulators", "mcmc", "preprocess"]
    assert sorted(result["closure"]) == [0, 1] and "chain" not in result["closure"][0]
    written = sorted(str(p.relative_to(mem_dir)) for p in mem_dir.rglob("*") if p.is_file())
    assert written == [f"output/{run}/observables.h5"]  # the staged input only
    stored = thdf5.read_dict_from_h5(str(tmp_path / "torch" / "output" / run), "mcmc.h5", verbose=False)
    np.testing.assert_array_equal(result["mcmc"]["chain"], stored["chain"])


@pytest.mark.parametrize("refusal", ["no matplotlib", "write=False"])
def test_plot_toggles_raise_before_any_stage(tmp_path, monkeypatch, refusal):
    """A plot toggle on is refused at construction, before any stage runs
    and before the output directory is made, where matplotlib cannot be
    imported (the card's machine) and with write=False (the plots read the
    artifacts from disk); the message names the toggles that are on."""
    path, cfg = _steer_yaml(tmp_path)
    cfg["plot"]["mcmc"] = True
    if refusal == "no matplotlib":
        find_spec = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib"
                            else find_spec(name, *a))
        with pytest.raises(RuntimeError, match=r"plot toggles \['mcmc'\] are on, but matplotlib cannot be imported"):
            tsteer.SteerAnalysis(config=cfg, device="cpu")
    else:
        with pytest.raises(ValueError, match=r"plot toggles \['mcmc'\] are on with write=False"):
            tsteer.SteerAnalysis(config=cfg, device="cpu", write=False)
    assert not Path(cfg["output_dir"]).exists()


def test_in_memory_steer_reads_groups_already_fitted_on_disk(tmp_path, monkeypatch):
    """In memory (write=False), fit_emulators skips a group whose pickle is
    already on disk (force_retrain False); the steer reads that group from
    its pickle and hands every group to the MCMC, which gives the same chain
    as the run that fits both groups; the log-probs agree to rtol 1e-12 (the
    group fitted alone is a smaller batch of the same float64 fit, which
    rounds its last bits differently). A group neither fitted nor on disk is
    named in a ValueError."""
    path, name, param = make_analysis_yaml(tmp_path, n_walkers=8, n_burn_steps=8, n_sampling_steps=16, n_restarts=1)
    cfg = yaml.safe_load(path.read_text())
    run = f"{name}_{param}"
    both = tsteer.SteerAnalysis(config=cfg, device="cpu", write=False).run_analysis()[run]
    assert sorted(both["emulation"]) == ["group_ch", "group_pi"]
    emu = tconfigs.EmulationConfig.from_config_file(name, param, cfg["analyses"][name], config=cfg)
    temulator.write_emulators(emu.emulation_groups_config["group_pi"], both["emulation"]["group_pi"])

    partial = tsteer.SteerAnalysis(config=cfg, device="cpu", write=False).run_analysis()[run]
    assert sorted(partial["emulation"]) == ["group_ch"]
    for key in ("chain", "acceptance_fraction"):
        np.testing.assert_array_equal(partial["mcmc"][key], both["mcmc"][key], err_msg=key)
    np.testing.assert_allclose(partial["mcmc"]["log_prob"], both["mcmc"]["log_prob"], rtol=1e-12)

    os.remove(emu.emulation_groups_config["group_pi"].emulation_outputfile)
    monkeypatch.setattr(temulator, "fit_emulators", lambda *args, **kwargs: {})
    with pytest.raises(ValueError, match="'group_ch' was not fitted in this run"):
        tsteer.SteerAnalysis(config=cfg, device="cpu", write=False).run_analysis()


def test_cli_refuses_cuda_without_a_card_and_x64_on_cuda(tmp_path, monkeypatch):
    """``--device cuda`` (the default) raises where torch finds no CUDA
    device, instead of running on the CPU; ``--x64`` needs ``--device cpu``."""
    path, cfg = _steer_yaml(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["-c", str(path)], ["-c", str(path), "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsteer.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--x64"):
        tsteer.main(["-c", str(path), "--device", "cuda", "--x64"])
    assert not Path(cfg["output_dir"]).exists()


def test_device_trace_writes_a_trace_file(tmp_path):
    """device_trace writes a Chrome trace holding the annotated region;
    without a directory it is a no-op."""
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("biq_test_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    assert any(e.get("name") == "biq_test_region" for e in trace["traceEvents"])
    with profiling.device_trace(None):
        pass
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace"]
