"""The harness's run, at a tiny size on the CPU (float64, the port's plain
paths), past the look for a card, over two units: the first on the
benchmark's draws, the second on the program's own generator. A sound run
comes out correct, with the reference agreeing with the port to rounding; a
run with the timed path broken underneath comes out not correct, once for
each fault a cell can have (a step that returns its state unchanged, half of
the ensemble left out, an answer altered where it is produced, a fit that
stops where it starts), and once for each fault of the generator's draws
alone that puts a walker where no stretch move could (a split that is not a
permutation, an inverse that is not the split's)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bayesian_inference_tpu_torch.mcmc import programs as programs_mod  # noqa: E402
from bayesian_inference_tpu_torch.mcmc import stretch  # noqa: E402
from bayesian_inference_tpu_torch.mcmc.stretch import EnsembleState  # noqa: E402
from bayesian_inference_tpu_torch.models import gp_fit  # noqa: E402
from pbench import cell as cell_mod  # noqa: E402
from pbench import harness  # noqa: E402

SEED = 2**31 + 4321  # wider than 32 signed bits: the benchmark takes such seeds


def tiny(name: str, **traffic) -> cell_mod.Cell:
    cell = cell_mod.load_cell(name)
    cell.config = dict(cell.config, n_restarts=1, opt_iters=60, n_walkers=8)
    cell.traffic = dict(cell.traffic, n_burn_steps=20, n_sampling_steps=60,
                        warmup={"n_burn_steps": 10, "n_sampling_steps": 20}, **traffic)
    cell.limits = dict(cell.limits, check_rows=8)
    return cell


class TwoUnits(harness.Run):
    """A window of exactly two units, whatever they take."""

    def starts(self, i: int, elapsed: float) -> bool:
        return i < 2


def run_cell(cell: cell_mod.Cell, tmp_path) -> dict:
    torch.set_num_threads(4)
    run = TwoUnits(cell, SEED, 1e-3, False, device="cpu", work_dir=tmp_path / "work")
    try:
        run.measure()
        return harness.result(run, run.end_to_end(), {"platform": "cpu", "kind": "cpu", "count": 1}, "cpu")
    finally:
        run.cleanup()


def numbers(line: dict) -> dict[str, float]:
    """Every number read, the largest over the units (those without a limit too)."""
    out: dict[str, float] = {}
    for _, got in line["units"]["numbers_by_unit"]:
        for k, v in got.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


@pytest.fixture
def wrap_chunk(monkeypatch):
    """Replace the sampler's chunk by ``fault(self, state, result)`` around the real one."""
    real = programs_mod.SamplerPrograms.chunk

    def install(fault):
        def chunk(self, state, like, n_steps, generator=None, rands=None):
            return fault(self, state, real(self, state, like, n_steps, generator=generator, rands=rands))

        monkeypatch.setattr(programs_mod.SamplerPrograms, "chunk", chunk)

    return install


@pytest.mark.parametrize("name", ["substructure_block.long_prod", "substructure_lowrank.long_prod"])
def test_a_sound_analysis_is_correct_and_agrees_with_the_port(name, tmp_path):
    line = run_cell(tiny(name), tmp_path)
    got = numbers(line)
    assert line["correct"], got
    assert got["lp_gap"] < 1e-7 and got["lml_gap"] < 1e-7 and got["rhat_gap"] < 1e-10
    assert got["move_mismatch"] == 0 and got["off_line_moves"] == 0
    assert line["units"]["checked"] == 2 and [u for u, _ in line["units"]["numbers_by_unit"]] == [0, 1]
    assert "move_mismatch" in line["units"]["numbers_by_unit"][0][1]
    assert "move_mismatch" not in line["units"]["numbers_by_unit"][1][1]


def test_a_sound_closure_batch_is_correct(tmp_path):
    line = run_cell(tiny("substructure_block.closure30", validation_points=3), tmp_path)
    got = numbers(line)
    assert line["correct"], got
    assert got["lp_gap"] < 1e-7 and got["move_mismatch"] == 0 and got["off_line_moves"] == 0


def test_a_sound_refit_is_correct(tmp_path):
    line = run_cell(tiny("substructure_block.refit"), tmp_path)
    assert line["correct"], numbers(line)
    assert numbers(line)["lml_gap"] < 1e-7


def stuck(self, state, result):
    """Every step returns its state unchanged."""
    final, outs = result
    if not self.store_chain:
        return state, torch.zeros_like(outs)
    chain, log_prob, acc = outs
    return state, (state.coords.expand_as(chain).clone(), state.log_prob.expand_as(log_prob).clone(),
                   torch.zeros_like(acc))


def half_left_out(self, state, result):
    """The second half of each ensemble never moves."""
    final, outs = result
    h = state.coords.shape[-2] // 2
    coords, lp = final.coords.clone(), final.log_prob.clone()
    coords[..., h:, :], lp[..., h:] = state.coords[..., h:, :], state.log_prob[..., h:]
    if not self.store_chain:
        return EnsembleState(coords, lp, final.n_accepted), outs
    chain, log_prob, acc = (o.clone() for o in outs)
    chain[..., h:, :] = state.coords[..., h:, :]
    log_prob[..., h:] = state.log_prob[..., h:]
    return EnsembleState(coords, lp, final.n_accepted), (chain, log_prob, acc)


def altered(self, state, result):
    """One walker's recorded log-probability off by five nats in every row."""
    final, outs = result
    if not self.store_chain:
        return result
    chain, log_prob, acc = (o.clone() for o in outs)
    log_prob[..., 0] += 5.0
    return final, (chain, log_prob, acc)


@pytest.mark.parametrize("fault", [stuck, half_left_out, altered])
@pytest.mark.parametrize("name", ["substructure_block.long_prod", "substructure_block.closure30"])
def test_a_broken_sampler_is_not_correct(name, fault, wrap_chunk, tmp_path):
    wrap_chunk(fault)
    line = run_cell(tiny(name, validation_points=3), tmp_path)
    assert not line["correct"], numbers(line)
    assert line["failed"] >= 1


def split_not_a_permutation(rands):
    """One walker of each step's split taken twice, another left out."""
    perm = rands["perm"].clone()
    perm[..., 1] = perm[..., 0]
    return dict(rands, perm=perm, inv=torch.argsort(perm, dim=-1))


def stale_inverse(rands):
    """Each step's walkers put back by the inverse of the step before's split."""
    return dict(rands, inv=torch.argsort(rands["perm"].roll(1, dims=0), dim=-1))


@pytest.mark.parametrize("fault", [split_not_a_permutation, stale_inverse])
@pytest.mark.parametrize("name", ["substructure_block.long_prod", "substructure_block.closure30"])
def test_broken_generator_draws_are_not_correct(name, fault, monkeypatch, tmp_path):
    """Only the program's own draws are broken: the first unit, on the
    benchmark's draws, stays sound, and the second fails."""
    real = stretch.pregen_rands
    monkeypatch.setattr(stretch, "pregen_rands", lambda *args, **kwargs: fault(real(*args, **kwargs)))
    line = run_cell(tiny(name, validation_points=3), tmp_path)
    by_unit = dict((u, got) for u, got in line["units"]["numbers_by_unit"] if u >= 0)
    assert not line["correct"], numbers(line)
    assert by_unit[0]["off_line_moves"] == 0 and by_unit[1]["off_line_moves"] > 0, by_unit


def test_a_fit_that_stops_where_it_starts_is_not_correct(monkeypatch, tmp_path):
    real = gp_fit.fit_gps

    def one_iteration(spec, *args, **kwargs):
        return real(dataclasses.replace(spec, n_iters=1, halving_keep=0), *args, **kwargs)

    monkeypatch.setattr(gp_fit, "fit_gps", one_iteration)
    line = run_cell(tiny("substructure_block.refit"), tmp_path)
    assert not line["correct"], numbers(line)


def test_a_fit_whose_likelihood_is_altered_is_not_correct(monkeypatch, tmp_path):
    from bayesian_inference_tpu_torch.models import emulator

    real = emulator._host

    def altered_lml(posts, sl):
        out = real(posts, sl)
        out["lml"] = out["lml"] + 2.0
        return out

    monkeypatch.setattr(emulator, "_host", altered_lml)
    line = run_cell(tiny("substructure_block.refit"), tmp_path)
    assert not line["correct"], numbers(line)
