"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface (and may include the shared
``csrc/*.cuh`` headers). At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/bayesian_inference_tpu_torch/``
at the repository root, and loaded with ``ctypes``. The library's file name
carries a hash of its source and the headers, so an edited source is always
rebuilt. Nothing is built or loaded at import time.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``NativeKernel.launch`` raises if that is not 0 and
counts the launches, so a run can show that its main path went through the
kernel.

A wrapper may name the batch size of a launch; the kernel then also counts its
launches by batch (``launches_by_batch``), so a run can show which stage of
a path launched it.

A CUDA graph replays its captured launches without passing through ``launch``.
``captured_launches`` records what a capture recorded per kernel, in all and
by batch (and takes those recordings back out of the counts: a capture
launches nothing); ``count_replays`` adds them for every replay, so the
counts stay the number of times each kernel ran on the card. Each root call
of ``utils/profiling`` keeps its difference of them (``launch_counts``).
"""

from __future__ import annotations

import contextlib
import ctypes
from collections import Counter
import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from bayesian_inference_tpu_torch.utils import profiling

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "bayesian_inference_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

P = ctypes.c_void_p
I = ctypes.c_int

# Every NativeKernel of the process, in creation order (one per ops module).
KERNELS: list["NativeKernel"] = []


class NativeKernel:
    """One CUDA source, its C entry points (name -> ctypes argtypes), and a
    count of kernel launches made through ``launch``."""

    def __init__(self, source: str, entries: dict[str, list]):
        self.source = CSRC_DIR / source
        self.entries = entries
        self.launches = 0
        self.launches_by_batch: Counter = Counter()
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib: ctypes.CDLL | None = None
        KERNELS.append(self)

    def library_path(self) -> Path:
        """The library's path, named by a hash of the source and of every
        header under ``csrc/`` (the sources include them)."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:12]}.so"

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

    def launch(self, entry: str, *args, device: torch.device, batch: int | None = None) -> None:
        """Call the C entry point ``entry``, which launches on the current
        device: ``device``, the operands' own, is made current around the call
        (under a mesh a kernel is launched for other cards than the first)."""
        lib = self.build()
        with torch.cuda.device(device):
            rc = getattr(lib, entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{entry} failed: {lib.error_string(rc).decode()} (cudaError {rc})")
        self.launches += 1
        if batch is not None:
            self.launches_by_batch[batch] += 1


class LaunchRecord(dict):
    """What one capture recorded: kernel -> launches, and in ``by_batch``
    (kernel, batch) -> launches for the launches that named their batch."""

    def __init__(self):
        super().__init__()
        self.by_batch: dict[tuple[NativeKernel, int], int] = {}


@contextlib.contextmanager
def captured_launches():
    """Around a stream capture: yields a dict that, when the block ends, maps
    each kernel to the launches the capture recorded. The counts themselves
    are put back to what they were, since a capture runs nothing."""
    before = [(k, k.launches, Counter(k.launches_by_batch)) for k in KERNELS]
    record = LaunchRecord()
    try:
        yield record
    finally:
        for k, n, by_batch in before:
            if k.launches != n:
                record[k] = k.launches - n
                k.launches = n
            for batch, count in (k.launches_by_batch - by_batch).items():
                record.by_batch[k, batch] = count
            k.launches_by_batch = by_batch


def count_replays(record: dict["NativeKernel", int], replays: int) -> None:
    """Count ``replays`` replays of a graph whose capture recorded ``record``."""
    for k, n in record.items():
        k.launches += n * replays
    for (k, batch), n in getattr(record, "by_batch", {}).items():
        k.launches_by_batch[batch] += n * replays


def build_all(kernels) -> None:
    """Build every kernel at once: one ``nvcc`` process per source, all
    started together."""
    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        list(pool.map(NativeKernel.build, kernels))


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


@profiling.counter_source
def launch_counts() -> dict[str, int]:
    """Kernel launches by kernel (``launches.<source>``), and by batch where a
    wrapper named it (``launches.<source>.B<batch>``), counted through graph
    replays."""
    out = {}
    for k in KERNELS:
        out[f"launches.{k.source.stem}"] = k.launches
        for batch, n in k.launches_by_batch.items():
            out[f"launches.{k.source.stem}.B{batch}"] = n
    return out
