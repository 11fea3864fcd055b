#!/usr/bin/env python3
"""Per-thread-block timeline of kernel K1 (csrc/fused_block_mvn.cu) on one GPU.

The card's machine has no Nsight, so this builds a copy of the kernel with
``%globaltimer`` probes (block start, end of staging, end of the assembly on
the shared-memory path, last thread done) into ``build/k1_timeline/``, runs
one all-bucket call at the production bucket mix (nb 8/16/24 x 40/96/8
blocks, k = 41) at W = 50 and at P = 30 x Wh = 50, and prints per bucket the
median block time and its parts, and when the bucket's blocks ran. Run from
the repository root::

    python3 scripts/k1_block_timeline.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "k1_timeline"
MAX_BLOCKS = 16384

PROBES = """
#include <cuda_runtime.h>
__device__ unsigned long long g_t[4][%d];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int read_times(unsigned long long* out) { return cudaMemcpyFromSymbol(out, g_t, sizeof(g_t)); }
extern "C" int clear_times() {
  static unsigned long long zeros[4][%d];
  return cudaMemcpyToSymbol(g_t, zeros, sizeof(zeros));
}
""" % (MAX_BLOCKS, MAX_BLOCKS)

# (anchor in the kernel source, the probe put after it)
EDITS = [
    ("extern __shared__ __align__(16) float smem[];",
     "\n  const unsigned long long t_start = gtime();"),
    ("  copy_async_wait();\n  __syncthreads();\n",
     "  if (threadIdx.x == 0) { g_t[0][blockIdx.x] = t_start; g_t[1][blockIdx.x] = gtime(); }\n"),
    ("      if (live) assemble_in_shared(D_s, d0w, U_s, zT, vT, tp, C_s, b_s, tw, t, nb, k, true, part, "
     "kThreads / tw);\n    }\n    __syncthreads();\n",
     "    if (threadIdx.x == 0) g_t[3][blockIdx.x] = gtime();\n"),
    ("    factor_in_shared(C_s, b_s, tw, t, nb, quad, half_logdet);\n  }\n",
     "  atomicMax(&g_t[2][blockIdx.x], gtime());\n"),
]


def build(native) -> ctypes.CDLL:
    src = (native.CSRC_DIR / "fused_block_mvn.cu").read_text()
    for anchor, probe in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in fused_block_mvn.cu: {anchor!r}")
        src = src.replace(anchor, anchor + probe)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "timeline.cu").write_text(PROBES + src)
    from torch.utils.cpp_extension import CUDA_HOME

    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *native.NVCC_FLAGS, "-I", str(native.CSRC_DIR),
           "-o", str(OUT / "timeline.so"), str(OUT / "timeline.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(OUT / "timeline.so"))


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_block_timeline: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke
    from bayesian_inference_tpu_torch.ops import _native, fused_mvn

    lib = build(_native)
    for entry, argtypes in fused_mvn.KERNEL.entries.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    fused_mvn.KERNEL._lib = lib
    device = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for W, P in ((50, 0), (1500, 30)):
        buckets, z, v = chip_smoke.mvn_buckets(W, device, torch.float32, seed=3, n_points=P)
        Us, Ds, d0s = zip(*buckets)
        for _ in range(3):
            fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)
        torch.cuda.synchronize()
        lib.clear_times()
        fused_mvn.fused_block_mvn_loglike_buckets(Us, Ds, d0s, z, v)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4 * MAX_BLOCKS))()
        lib.read_times(buf)
        t = np.frombuffer(buf, dtype=np.uint64).astype(np.int64).reshape(4, MAX_BLOCKS)
        # launch order: the widest bucket first; walker tiles of 64 (nb <= 16) or 32
        layout = [(U.shape[1], U.shape[0] * -(-W // (64 if U.shape[1] <= 16 else 32))) for U in reversed(Us)]
        n = sum(c for _, c in layout)
        t = t[:, :n]
        t0 = t[0].min()
        print(f"W={W}: {n} thread blocks, first start to last end {(t[2].max() - t0) / 1e3:.1f} us", flush=True)
        i = 0
        for nb, c in layout:
            s = t[:, i:i + c]
            i += c
            line = (f"  nb={nb}: {c} blocks; per block median {np.median(s[2] - s[0]) / 1e3:.1f} us "
                    f"(max {(s[2] - s[0]).max() / 1e3:.1f}), staging {np.median(s[1] - s[0]) / 1e3:.2f} us")
            if nb > 16:
                line += (f", assembly {np.median(s[3] - s[1]) / 1e3:.1f} us, factorisation "
                         f"{np.median(s[2] - s[3]) / 1e3:.1f} us")
            line += (f"; started {(s[0].min() - t0) / 1e3:.1f}..{(s[0].max() - t0) / 1e3:.1f} us, ended "
                     f"{(s[2].min() - t0) / 1e3:.1f}..{(s[2].max() - t0) / 1e3:.1f} us")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
