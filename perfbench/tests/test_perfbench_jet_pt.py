"""The cell ``jet_pt_200w.prod25k`` on the CPU: its shapes come from the
yaml's ``analysis_jet`` selection (one 5-PC group over 44 jet spectra, the
STAR spectra cut to the yaml's x-ranges), and
the harness's run of it at its own 200 walkers, with the steps and restarts
shrunk as ``test_perfbench_faults.tiny`` shrinks them, comes out correct;
with the sampler broken underneath by each of the faults' tests' sampler
faults it does not. The reference's judgement of an accept decision takes a
stretch that rounds to 1, which this cell's runs meet, for what it is."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from test_perfbench_faults import altered, half_left_out, numbers, run_cell, stuck, tiny, wrap_chunk  # noqa: E402, F401

from pbench import cell as cell_mod  # noqa: E402
from pbench import harness, shapes, tables  # noqa: E402
from reference import data as ref_data  # noqa: E402
from reference import sampler as ref_sampler  # noqa: E402

CELL = "jet_pt_200w.prod25k"


def jet_pt() -> cell_mod.Cell:
    """The cell shrunk as ``tiny`` shrinks it, at the configuration's own walkers."""
    walkers = cell_mod.load_cell(CELL).config["n_walkers"]
    cell = tiny(CELL)
    cell.config = dict(cell.config, n_walkers=walkers)
    return cell


def test_shapes_follow_the_yaml_selection(tmp_path):
    cell = cell_mod.load_cell(CELL)
    tables.make_production_tables(tmp_path, n_design=int(cell.config["tables"]["n_design"]),
                                  seed=harness.seed_of(7, 1))
    data = ref_data.read(str(tmp_path), cell.config)
    s = shapes.of(cell.config, cell.traffic, data)
    assert (s.k, s.walkers, s.points, s.half_batch) == (5, 200, 1, 100)
    assert s.buckets == ((16, 40), (24, 4))
    assert len(data.labels) == cell.config["tables"]["n_observables"] == 44
    assert data.n_features == cell.config["tables"]["n_features"] == 608
    assert not any("pt_y_atlas" in lbl for lbl in data.labels)
    star = {lbl.split("__")[4]: w for g in data.groups for lbl, w in zip(g.labels, g.widths) if "pt_star" in lbl}
    assert star == {"R0.2": 6, "R0.3": 10, "R0.4": 6, "R0.5": 10}        # the yaml's cuts keep 6 of 10 bins


def test_a_sound_run_of_the_cell_is_correct(tmp_path):
    line = run_cell(jet_pt(), tmp_path)
    got = numbers(line)
    assert line["correct"], got
    assert got["lp_gap"] < 1e-7 and got["lml_gap"] < 1e-7 and got["rhat_gap"] < 1e-10
    assert got["move_mismatch"] == 0 and got["off_line_moves"] == 0
    assert line["units"]["checked"] == 2


@pytest.mark.parametrize("fault", [stuck, half_left_out, altered])
def test_a_broken_sampler_is_not_correct(fault, wrap_chunk, tmp_path):
    wrap_chunk(fault)
    line = run_cell(jet_pt(), tmp_path)
    assert not line["correct"], numbers(line)
    assert line["failed"] >= 1


def test_an_accepted_move_that_rounds_to_its_start_is_no_mismatch():
    """Eight walkers, none of which moves. In the first half the reference
    accepts the proposals of walkers 0-2 and rejects walker 3's. Walker 0's
    stretch is a rounding under 1 and its float32 proposal is its start, bit
    for bit: staying is the accepted move. Walker 1's stretch is a rounding
    over 1 and its float32 proposal leaves the start in some coordinates:
    staying is a mismatch, though its float64 proposal lies as near the
    start as walker 0's. Walker 2's stretch is 1.5: a mismatch. In the
    second half the reference rejects all four, as the program did."""
    rng = np.random.default_rng(3)
    x = rng.uniform(1.0, 2.0, (8, 6)).astype(np.float32)
    u_under, u_over, u_wide = np.float32(0.4142135), np.float32(0.4142136), np.float32(np.sqrt(3.0) - 1.0)
    draws = {"perm": np.arange(8, dtype=np.int32)[None],
             "partners": np.array([[[1, 0, 2, 3], [0, 1, 2, 3]]], np.int32),
             "u_z": np.array([[[u_under, u_over, u_wide, 0.5], [0.5] * 4]], np.float32),
             "u_acc": np.full((1, 2, 4), 0.5, np.float32)}
    p = ref_sampler.proposals(x, x, draws, 0)
    xt = torch.tensor(x, dtype=torch.float64)
    y, y32 = p["y"][0], p["y32"][0]
    assert torch.equal(y32[0], xt[0]) and not torch.equal(y32[1], xt[1])
    near = ((y[:2] - xt[:2]).abs() / xt[:2].abs()).amax(-1)
    assert torch.all((near > 0) & (near < 2.0**-20))
    lp_cur = torch.zeros(8, dtype=torch.float64)
    lp_y = [torch.tensor([0.0, 0.0, 0.0, -torch.inf], dtype=torch.float64),
            torch.full((4,), -torch.inf, dtype=torch.float64)]
    judged = ref_sampler.judge_step(p, lp_cur, lp_y, draws, 0, np.ones(6), margin=0.25)
    assert judged["mismatches"] == 2
