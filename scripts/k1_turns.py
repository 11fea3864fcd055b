#!/usr/bin/env python3
"""Time kernel K1 at the production buckets (W = 50 walkers, k = 41 PCs) with
``chip_smoke.phase_k1``, on the port's package found under SRC_DIR, and print
the result as one JSON line.

Two trees are compared on one card by running this in turns in one call,
the other tree's ``src/`` unpacked under the git-ignored ``build/``::

    git archive <commit> src | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do python3 scripts/k1_turns.py $s; done
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_turns: needs a CUDA device", file=sys.stderr)
        return 1
    src = Path(argv[1]).resolve()
    sys.path[:0] = [str(src), str(REPO)]
    import chip_smoke
    from bayesian_inference_tpu_torch.ops import fused_mvn

    if src not in Path(fused_mvn.__file__).resolve().parents:
        raise RuntimeError(f"imported {fused_mvn.__file__}, not the package under {src}")
    result = chip_smoke.phase_k1(torch.device("cuda", 0), W=chip_smoke.N_WALKERS // 2)
    print(json.dumps({"src": argv[1], "card": chip_smoke.nvidia_smi_line(), **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
