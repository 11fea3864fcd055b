"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/bayesian_inference_tpu_torch/`` at the repository root, and loaded
with ``ctypes``. The library's file name carries a hash of its source, so an
edited source is always rebuilt. Nothing is built or loaded at import time.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``NativeKernel.launch`` raises if that is not 0 and
counts the launches, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "bayesian_inference_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

P = ctypes.c_void_p
I = ctypes.c_int


class NativeKernel:
    """One CUDA source, its C entry points (name -> ctypes argtypes), and a
    count of kernel launches made through ``launch``."""

    def __init__(self, source: str, entries: dict[str, list]):
        self.source = CSRC_DIR / source
        self.entries = entries
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib: ctypes.CDLL | None = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def build(self) -> ctypes.CDLL:
        """Compile (when the library for this source is missing) and load."""
        if self._lib is not None:
            return self._lib
        out = self.library_path()
        t0 = time.perf_counter()
        if not out.exists():
            from torch.utils.cpp_extension import CUDA_HOME

            if CUDA_HOME is None:
                raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = (proc.stdout + proc.stderr).strip()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in self.entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        lib.error_string.argtypes = [I]
        lib.error_string.restype = ctypes.c_char_p
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def launch(self, entry: str, *args) -> None:
        lib = self.build()
        rc = getattr(lib, entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} failed: {lib.error_string(rc).decode()} (cudaError {rc})")
        self.launches += 1


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous float32 tensor on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operands on different devices ({t.device} vs {device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous operands")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
