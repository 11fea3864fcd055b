"""emcee-compatible sampler archive: what ``mcmc_sampler.pkl`` holds (host
code, carried over from ``bayesian_inference_tpu.mcmc.sampler_archive``).

The archive stores the small sampler state (final ensemble, acceptance, tau,
seed) and serves emcee's chain-access API lazily from the ``mcmc.h5``
written alongside it. One deliberate difference from the JAX package:
``get_autocorr_time(discard=..., thin=...)`` recomputes tau on the sliced
chain, as emcee does, instead of returning the stored full-chain value.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np


class EnsembleSamplerArchive:
    """Picklable read-API stand-in for ``emcee.EnsembleSampler``."""

    def __init__(
        self,
        final_coords: np.ndarray,
        final_log_prob: np.ndarray,
        acceptance_fraction: np.ndarray,
        autocorrelation_time: np.ndarray | None,
        seed: int,
        mode: str,
        h5_filename: str = "mcmc.h5",
    ):
        self.final_coords = np.asarray(final_coords)
        self.final_log_prob = np.asarray(final_log_prob)
        self._acceptance_fraction = np.asarray(acceptance_fraction)
        self.autocorrelation_time = None if autocorrelation_time is None else np.asarray(autocorrelation_time)
        self.seed = int(seed)
        self.mode = str(mode)
        self.h5_filename = h5_filename
        self._h5_dir: str | None = None

    def save(self, path: str) -> None:
        self._h5_dir = None  # never bake an absolute dir into the artifact
        with open(path, "wb") as f:
            pickle.dump(self, f)
        self._h5_dir = os.path.dirname(os.path.abspath(path))

    @classmethod
    def load(cls, path: str) -> "EnsembleSamplerArchive":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, cls):
            obj._h5_dir = os.path.dirname(os.path.abspath(path))
        return obj

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._h5_dir = None

    @property
    def nwalkers(self) -> int:
        return int(self.final_coords.shape[0])

    @property
    def ndim(self) -> int:
        return int(self.final_coords.shape[1])

    @property
    def acceptance_fraction(self) -> np.ndarray:
        return self._acceptance_fraction

    def get_last_sample(self):
        return self.final_coords, self.final_log_prob

    def _load_h5(self, key: str) -> np.ndarray:
        from bayesian_inference_tpu_torch.io import hdf5

        if self._h5_dir is None:
            raise RuntimeError(
                "This archive was unpickled directly; use EnsembleSamplerArchive.load(path) "
                "so it can find the mcmc.h5 written alongside it."
            )
        results = hdf5.read_dict_from_h5(self._h5_dir, self.h5_filename, verbose=False)
        if key not in results:
            raise KeyError(f"{key} not found in {self._h5_dir}/{self.h5_filename}")
        return np.asarray(results[key])

    @staticmethod
    def _slice(a: np.ndarray, discard: int, thin: int, flat: bool) -> np.ndarray:
        a = a[discard::thin]
        if flat:
            return a.reshape(np.prod(a.shape[:2]), *a.shape[2:])
        return a

    def get_chain(self, *, discard: int = 0, thin: int = 1, flat: bool = False):
        """(nsteps, nwalkers, ndim) production chain, emcee semantics."""
        return self._slice(self._load_h5("chain"), discard, thin, flat)

    def get_log_prob(self, *, discard: int = 0, thin: int = 1, flat: bool = False):
        return self._slice(self._load_h5("log_prob"), discard, thin, flat)

    def get_autocorr_time(self, *, discard: int = 0, thin: int = 1, **kwargs: Any):
        """tau of the production chain; recomputed (emcee semantics, with
        ``kwargs`` passed to ``integrated_time``) when sliced or configured."""
        if discard == 0 and thin == 1 and not kwargs:
            return self.autocorrelation_time
        from bayesian_inference_tpu_torch.mcmc.stats import integrated_time

        return thin * integrated_time(self.get_chain(discard=discard, thin=thin), **kwargs)

    @property
    def chain(self) -> np.ndarray:
        """(nwalkers, nsteps, ndim) -- emcee's legacy axis order."""
        return np.swapaxes(self.get_chain(), 0, 1)

    @property
    def lnprobability(self) -> np.ndarray:
        return np.swapaxes(self.get_log_prob(), 0, 1)

    @property
    def flatchain(self) -> np.ndarray:
        return self.get_chain(flat=True)

    @property
    def flatlnprobability(self) -> np.ndarray:
        return self.get_log_prob(flat=True)
