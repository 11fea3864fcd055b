"""Nested dict-of-ndarray <-> HDF5 round trip (host code, carried over).

Same file layout as ``bayesian_inference_tpu.io.hdf5`` (nested groups, leaf
datasets). ``h5py`` is imported inside the functions that read or write, so
the rest of the port imports on machines without it.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np

logger = logging.getLogger(__name__)


def _store_group(group, data: Mapping[str, Any]) -> None:
    import h5py

    for key, value in data.items():
        key = str(key)
        if value is None:
            # e.g. autocorrelation_time=None when tau cannot be estimated
            continue
        if isinstance(value, Mapping):
            _store_group(group.require_group(key), value)
        else:
            if key in group:
                del group[key]
            arr = np.asarray(value)
            if arr.dtype.kind in ("U", "O"):
                arr = arr.astype(h5py.string_dtype())
            group.create_dataset(key, data=arr)


def _load_group(group) -> dict[str, Any]:
    import h5py

    out: dict[str, Any] = {}
    for key, value in group.items():
        if isinstance(value, h5py.Group):
            out[key] = _load_group(value)
        else:
            data = value[()]
            if isinstance(data, bytes):
                data = data.decode()
            out[key] = data
    return out


def write_dict_to_h5(results: Mapping[str, Any], output_dir: str, filename: str, verbose: bool = True) -> None:
    """Write a nested dictionary of ndarrays; existing leaves are replaced."""
    import h5py

    if verbose:
        logger.info(f"Writing results to {output_dir}/{filename}...")
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    mode = "a" if os.path.exists(path) else "w"
    with h5py.File(path, mode) as f:
        _store_group(f, results)


def read_dict_from_h5(input_dir: str, filename: str, verbose: bool = True) -> dict[str, Any]:
    """Read a nested dictionary of ndarrays from an HDF5 file."""
    import h5py

    if verbose:
        logger.info(f"Loading results from {input_dir}/{filename}...")
    with h5py.File(os.path.join(input_dir, filename), "r") as f:
        return _load_group(f)
