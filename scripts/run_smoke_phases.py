#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s path phases alone, on one CUDA card::

    python3 scripts/run_smoke_phases.py mesh full_length

It builds the kernels, makes the production tables, runs ``phase_slice`` (the
fit and the short run whose emulators and chain the later phases reuse) and
then the named phases (``options``, ``closure_slabs``, ``mesh``,
``full_length``, ``parity``; ``k4`` needs no slice but runs after it), each as ``chip_smoke.py`` runs it. For looking at one phase
without paying for the whole script; ``chip_smoke.py`` stays the check.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main(names) -> int:
    if not torch.cuda.is_available():
        print("run_smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(chip_smoke.SRC))
    from bayesian_inference_tpu_torch.ops import blocked_cholesky, fused_mvn, tiny_mvn
    from bayesian_inference_tpu_torch.ops._native import build_all

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kernels = {"diag_chol_inv": blocked_cholesky.KERNEL, "fused_block_mvn": fused_mvn.KERNEL,
               "block_mvn": tiny_mvn.KERNEL}
    build_all(kernels.values())
    print(f"card: {chip_smoke.nvidia_smi_line()}", flush=True)
    data = chip_smoke.production_data()
    _, reuse = chip_smoke.phase_slice(device, kernels, data)
    phases = {
        "options": lambda: chip_smoke.phase_sampler_options(device, kernels, reuse),
        "closure_slabs": lambda: chip_smoke.phase_closure_slabs(device, kernels, reuse),
        "mesh": lambda: chip_smoke.phase_mesh(device, kernels, reuse, data),
        "full_length": lambda: chip_smoke.phase_full_length(device, kernels, data),
        "parity": lambda: chip_smoke.phase_parity(device, kernels, reuse, data),
        "k4": lambda: chip_smoke.phase_k4(device),
    }
    for name in names:
        phases[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
