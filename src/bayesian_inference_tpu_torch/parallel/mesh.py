"""A one-dimensional device mesh for multi-card runs: one process, a list
of devices.

Port of ``bayesian_inference_tpu.parallel.mesh`` by meaning. The JAX package
marks arrays with sharding constraints and lets its compiler partition the
program; PyTorch has no such pass, so the split is explicit here:

  - MCMC walkers: the ensemble state stays on the mesh's first device; each
    half-step's walker batch is split over the devices, every shard is
    evaluated on its device against that device's replica of the likelihood,
    and the (W,) log-probabilities are gathered on the first device
    (``make_sharded_log_prob``).
  - Closure points and GP fit instances (PCs x restarts) are independent, so
    their leading axis is split the same way and each device advances its
    share with its own device program (mcmc/programs.py, models/gp_fit.py).

Kernels of different cards run concurrently from the one host thread: every
launch and every copy between devices is asynchronous and ordered on the
devices' streams (a copy between cards waits for its source on the source's
stream and is waited for on the destination's), so nothing here synchronises
with the host. Single-card runs pass ``mesh=None`` everywhere and pay nothing.

A mesh may name one device several times (``devices=["cuda:0"] * 4``, or
eight ``"cpu"`` entries in the tests): the split, the replicas and the gather
then run as they would over that many cards, on the one device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Sequence

import torch


@dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D mesh, in shard order. Hashable and comparable:
    two meshes are equal when they name the same devices in the same order
    under the same axis name."""

    devices: tuple[torch.device, ...]
    axis_name: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> int:
        """How many different devices the mesh names."""
        return len(set(self.devices))


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: torch finds no CUDA device; name CPU devices for a mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def get_mesh(n_devices: int | None = None, axis_name: str = "data", devices: Sequence | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: all).

    ``devices`` defaults to every visible CUDA card, and raises where there is
    none; pass device names to choose them (``["cpu"] * 8`` is the CPU tests'
    mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("get_mesh: torch finds no CUDA device; pass devices=[...] to name the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"get_mesh: n_devices {n_devices}, {len(devices)} device(s) to choose from")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("get_mesh: a mesh needs at least one device")
    return Mesh(tuple(devices), axis_name)


def shard_sizes(n: int, mesh: Mesh) -> list[int]:
    """Near-equal shard lengths of an axis of ``n`` over the mesh, in device
    order: the first ``n % size`` shards hold one more. Shards may be empty."""
    base, extra = divmod(n, mesh.size)
    return [base + (i < extra) for i in range(mesh.size)]


def _check_axis(mesh: Mesh, axis_name: str | None) -> None:
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")


def shard_leading_axis(x: torch.Tensor, mesh: Mesh | None, axis_name: str | None = None):
    """``x`` itself without a mesh; else the list of its leading-axis shards,
    in device order, each on its device (``shard_sizes`` lengths).
    ``axis_name``, when given, must be the mesh's one axis."""
    if mesh is None:
        return x
    _check_axis(mesh, axis_name)
    return [s.to(d, non_blocking=True) for s, d in zip(torch.split(x, shard_sizes(x.shape[0], mesh)), mesh.devices)]


def map_tensors(tree, fn):
    """``tree`` (tensors, dataclasses, tuples, lists, dicts; anything else is
    a leaf kept as it is) with every tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: map_tensors(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(o, fn) for o in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(o, fn) for o in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    return tree


def replicate(x, mesh: Mesh | None):
    """The tree ``x`` itself without a mesh; else one copy of it per mesh device, in
    device order. The first copy shares the tensors that already lie on the
    first device; every other one is a copy of its own, also where the mesh
    names a device twice."""
    if mesh is None:
        return x
    return [
        map_tensors(x, lambda t, d=d, own=i > 0: t.to(d, copy=own, non_blocking=True))
        for i, d in enumerate(mesh.devices)
    ]


def _as_log_prob(obj) -> Callable[[torch.Tensor], torch.Tensor]:
    return obj.log_posterior if hasattr(obj, "log_posterior") else obj


def make_sharded_log_prob(log_prob_fn, mesh: Mesh | None,
                          axis_name: str | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """A batched log-probability whose walker batch is split over the mesh.

    ``log_prob_fn``: a likelihood (anything with ``log_posterior``), which is
    replicated over the mesh; or a sequence with one likelihood or function
    per mesh device, each holding its tensors on that device; or a function
    that holds no tensors of one device and so serves every shard. A closure
    over the tensors of one device cannot run on another, which is why the
    likelihood is taken where the JAX package takes the function. Without a
    mesh the log-probability comes back unchanged (the likelihood's
    ``log_posterior``).

    The returned function splits the leading axis of its (W, d) argument,
    evaluates every shard on its device, and returns the (W,) result on the
    argument's device. Empty shards (more devices than walkers) are skipped.
    ``axis_name``, when given, must be the mesh's one axis.
    """
    if mesh is None:
        return _as_log_prob(log_prob_fn)
    _check_axis(mesh, axis_name)
    if isinstance(log_prob_fn, (list, tuple)):
        if len(log_prob_fn) != mesh.size:
            raise ValueError(f"make_sharded_log_prob: {len(log_prob_fn)} log-probabilities for {mesh.size} mesh devices")
        fns = [_as_log_prob(f) for f in log_prob_fn]
    elif hasattr(log_prob_fn, "log_posterior"):
        fns = [_as_log_prob(f) for f in replicate(log_prob_fn, mesh)]
    else:
        fns = [log_prob_fn] * mesh.size

    def sharded(theta: torch.Tensor) -> torch.Tensor:
        shards = shard_leading_axis(theta, mesh)
        # every shard is launched before the first result is gathered
        outs = [fn(s) for fn, s in zip(fns, shards) if s.shape[0]]
        return torch.cat([o.to(theta.device, non_blocking=True) for o in outs])

    return sharded
