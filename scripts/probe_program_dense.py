#!/usr/bin/env python3
"""Does a sampler step with a dense route capture as a CUDA graph?

A block-mode bucket wider than ``fused_mvn.MAX_NB`` and a lowrank likelihood
of more than ``tiny_mvn.MAX_NB`` PCs go through ``torch.linalg.cholesky_ex``
and ``solve_triangular`` instead of a kernel. This probe builds one likelihood
of each kind at production width (the production buckets plus one 56-wide
bucket; 82 PCs), tries to capture the ensemble step on it
(``SamplerPrograms.compile``), and, where that works, holds 50 replayed steps
against the eager loop bit for bit. Each case runs in its own process, since a
failed capture can leave the CUDA context unusable. Run from the repository
root on a CUDA card::

    python3 scripts/probe_program_dense.py

One line per case: ``captures`` with the equality, or ``does not capture``
with the error.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CASES = ("block_nb56", "lowrank_k82")
N_STEPS = 50


def run_case(case: str) -> None:
    import torch

    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke
    from bayesian_inference_tpu_torch.io import observables as obs_io
    from bayesian_inference_tpu_torch.mcmc import likelihood as lik
    from bayesian_inference_tpu_torch.mcmc import stretch
    from bayesian_inference_tpu_torch.mcmc.programs import SamplerPrograms, dense_routes
    from bayesian_inference_tpu_torch.models.emulator import fit_emulators
    from bayesian_inference_tpu_torch.ops.mvn import build_woodbury
    from bayesian_inference_tpu_torch.pipeline.configs import EmulationConfig

    device = torch.device("cuda", 0)
    data = chip_smoke.production_data()
    observables, mcmc = data["observables"], data["mcmc"]
    config = chip_smoke.production_config(chip_smoke.WORK_DIR, data["table_dir"], chip_smoke.N_WALKERS,
                                          chip_smoke.N_BURN, chip_smoke.N_STEPS, 1)
    emu = EmulationConfig.from_config_file(chip_smoke.ANALYSIS, chip_smoke.PARAMETERIZATION,
                                           config["analyses"][chip_smoke.ANALYSIS], config=config)
    artifacts = fit_emulators(emu, seed=1, n_opt_iters=10, device=device, observables=observables, write=False)
    box = mcmc.parameterization_spec()
    exp = obs_io.data_array_from_h5(mcmc.output_dir, mcmc.observables_filename,
                                    observable_filter=emu.observable_filter, observables=observables)
    mode = "block" if case == "block_nb56" else "lowrank"
    like = lik.build_likelihood(emu, artifacts, exp, box["min"], box["max"], mode=mode, device=device,
                                observables=observables)
    W, ndim = chip_smoke.N_WALKERS, len(box["min"])
    if mode == "block":
        wide = chip_smoke.mvn_buckets(W // 2, device, torch.float32, extra_widths=(56,))[0][-1]
        like = dataclasses.replace(like, U=(*like.U, wide[0]), D=(*like.D, wide[1]), d0=(*like.d0, wide[2]))
    else:
        wb = like.wb
        wb = build_woodbury(wb.L_D @ wb.L_D.T, torch.cat([wb.U, 0.5 * wb.U], dim=1), wb.d0)
        like = dataclasses.replace(like, groups=like.groups * 2, wb=wb)
    gen = torch.Generator(device=device).manual_seed(3)
    dt = like.theta_min.dtype
    x0 = like.theta_min + (like.theta_max - like.theta_min) * torch.rand((W, ndim), generator=gen, dtype=dt,
                                                                         device=device)
    rands = stretch.pregen_rands(N_STEPS, W, gen, dt)
    state0 = stretch.init_state(like.log_posterior, x0)
    ref = stretch.run_chunk(state0, like.log_posterior, N_STEPS, rands=rands)
    torch.cuda.synchronize()
    head = f"{case}: dense routes {dense_routes(like)}; {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}: "
    programs = SamplerPrograms(like, W, ndim, [N_STEPS])
    try:
        programs.compile()
    except Exception as e:  # the probe's question is whether this raises
        print(head + f"does not capture: {type(e).__name__}: {str(e).splitlines()[0][:300]}", flush=True)
        return
    out = programs.chunk(programs.init(like, x0), like, N_STEPS, rands=rands)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(ref[1][1]).all())
    print(head + f"captures in {programs.compile_seconds:.3f} s; {N_STEPS} replayed steps bit-equal to the eager "
          f"loop: {chip_smoke.same_chunk(out, ref)}; eager log-probs finite: {finite}", flush=True)


def main() -> int:
    if len(sys.argv) > 1:
        run_case(sys.argv[1])
        return 0
    for case in CASES:
        proc = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(case)]
        if lines:
            print(lines[-1], flush=True)
        else:
            errors = proc.stderr.strip().splitlines()
            print(f"{case}: the process ended with code {proc.returncode}: {errors[-1][:300] if errors else 'no output'}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
