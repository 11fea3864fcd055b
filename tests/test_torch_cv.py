"""Port parity of emulator k-fold cross-validation (``models/cv.py``) on the
bundled fixture against the JAX package's, from the same restart points,
and the CV keys of the port's emulation config."""

import jax
import numpy as np
import pytest
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from config_factory import make_analysis_yaml

from bayesian_inference_tpu.models import cv as jcv
from bayesian_inference_tpu.pipeline import configs as jconfigs
from bayesian_inference_tpu_torch.io import hdf5 as thdf5
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.models import cv as tcv
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs

K, N_ITERS, SEED = 5, 20, 3
GROUPS = {
    "group_ch": {"n_pc": 2, "observable_list": ["pt_ch_"], "cross_validation": True, "cross_validation_k": K},
    "group_pi": {"n_pc": 2, "observable_list": ["pt_pi"]},
}


def _emulation_configs(tmp_path, n_restarts=4):
    path, name, param = make_analysis_yaml(tmp_path, groups=GROUPS, n_restarts=n_restarts)
    cfg = tconfigs.load_yaml(path)
    kw = dict(analysis_name=name, parameterization=param, analysis_config=cfg["analyses"][name])
    return (jconfigs.EmulationConfig.from_config_file(**kw, config_file=str(path)),
            tconfigs.EmulationConfig.from_config_file(**kw, config_file=str(path)),
            tconfigs.EmulationConfig.from_config_file(**kw, config=cfg))


def test_cross_validation_keys_parse_like_jax(tmp_path):
    """cross_validation / cross_validation_k reach the port's group configs
    (from the YAML and from the parsed dict) with JAX's values and defaults."""
    jemu, temu, temu_dict = _emulation_configs(tmp_path)
    for ours in (temu, temu_dict):
        for name, ref in jemu.emulation_groups_config.items():
            g = ours.emulation_groups_config[name]
            assert (g.cross_validation, g.cross_validation_k) == (ref.cross_validation, ref.cross_validation_k)
    assert (temu.emulation_groups_config["group_ch"].cross_validation_k,
            temu.emulation_groups_config["group_pi"].cross_validation) == (K, False)
    assert temu.emulation_groups_config["group_pi"].cross_validation_k == 5  # the default


def _recording(monkeypatch, module, store):
    fit_pca = module.fit_pca

    def wrapped(Y, max_n_components=None):
        state, Z = fit_pca(Y, max_n_components=max_n_components)
        store.append((state, np.asarray(Z)))
        return state, Z

    monkeypatch.setattr(module, "fit_pca", wrapped)


def test_cross_validate_matches_jax_on_fixture(tmp_path, monkeypatch):
    """k = 5 folds of the charged-hadron group (2 PCs, 4 + 1 restarts, 20
    iterations), the port fed the restart points JAX draws for each fold:
    the same folds and truth; each fold's scaler + PCA at rtol 1e-10; fitted
    LML per fold and PC within 0.1 nat (the repo's fit bar); predictions and
    predictive stds at rtol 1e-6; the same artifact keys, which
    ``cross_validate`` writes to cross_validation_group_ch.h5 for the
    flagged group only."""
    monkeypatch.setenv("BIQ_FIT_LML", "matmul")  # the JAX fit's TPU path, as the port always runs
    jemu, temu, _ = _emulation_configs(tmp_path)
    jgroup, tgroup = jemu.emulation_groups_config["group_ch"], temu.emulation_groups_config["group_ch"]
    jpcas, tpcas = [], []
    _recording(monkeypatch, jcv.pca_mod, jpcas)
    _recording(monkeypatch, tcv.pca_mod, tpcas)

    ref = jcv.cross_validate_group(jgroup, seed=SEED, n_opt_iters=N_ITERS)
    spec = jgroup.fit_spec(n_iters=N_ITERS)
    rand_logs = [
        np.asarray(jax.random.uniform(jax.random.key(SEED + f), (jgroup.n_pc, spec.n_restarts, spec.theta0.shape[0]),
                                      dtype=spec.theta0.dtype, minval=spec.log_lo, maxval=spec.log_hi))
        for f in range(K)
    ]
    ours = tcv.cross_validate_group(tgroup, seed=SEED, n_opt_iters=N_ITERS, device="cpu", rand_logs=rand_logs)

    assert sorted(ours) == sorted(ref)
    for key in ("fold_indices", "truth", "k", "seed"):
        np.testing.assert_array_equal(ours[key], np.asarray(ref[key]), err_msg=key)
    assert len(jpcas) == len(tpcas) == K
    for (ts, tz), (js, jz) in zip(tpcas, jpcas):
        np.testing.assert_allclose(tz, jz, rtol=1e-10, atol=1e-12)
        for name in ("mean", "scale", "components", "explained_variance"):
            np.testing.assert_allclose(getattr(ts, name), np.asarray(getattr(js, name)), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours["lml_per_fold"], np.asarray(ref["lml_per_fold"]), rtol=0, atol=0.1)
    for key in ("predictions", "predictive_std", "normalized_residuals", "rmse_per_feature"):
        np.testing.assert_allclose(ours[key], np.asarray(ref[key]), rtol=1e-6, err_msg=key)

    observables = tobs.read_observables(temu.output_dir, "observables.h5")
    out = tcv.cross_validate(temu, seed=SEED, n_opt_iters=N_ITERS, device="cpu", observables=observables)
    assert sorted(out) == ["group_ch"]
    stored = thdf5.read_dict_from_h5(temu.output_dir, "cross_validation_group_ch.h5", verbose=False)
    assert sorted(stored) == sorted(ref)
    np.testing.assert_array_equal(stored["predictions"], out["group_ch"]["predictions"])


def test_cross_validate_refuses_a_bad_k(tmp_path):
    _, temu, _ = _emulation_configs(tmp_path, n_restarts=1)
    with pytest.raises(ValueError, match="cross_validation_k=1 invalid"):
        tcv.cross_validate_group(temu.emulation_groups_config["group_ch"], k=1, device="cpu")
