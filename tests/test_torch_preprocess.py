"""Port parity of the preprocessing stage: outlier smoothing of the bundled
fixture (both passes, training and validation sets) against the JAX
package's ``preprocess``, and the port's ``PreprocessingConfig``."""

import numpy as np
import pytest
import torch_parity  # noqa: F401  (one intra-op thread per test worker)
from config_factory import make_analysis_yaml

from bayesian_inference_tpu.io import hdf5 as jhdf5
from bayesian_inference_tpu.pipeline import configs as jconfigs
from bayesian_inference_tpu.preprocess import outliers as joutliers
from bayesian_inference_tpu_torch.io import observables as tobs
from bayesian_inference_tpu_torch.pipeline import configs as tconfigs
from bayesian_inference_tpu_torch.preprocess import outliers as toutliers

SPIKED = "2760__PbPb__hadron__pt_ch_atlas____0-5"  # 21 bins


def _smoothing_yaml(tmp_path, method):
    """The fixture analysis with the given interpolation method, its
    observables.h5 staged with one interior spike planted in the training set
    and one in the validation set, so that both passes move values."""
    import h5py
    import yaml

    path, name, param = make_analysis_yaml(tmp_path)
    cfg = yaml.safe_load(path.read_text())
    cfg["analyses"][name]["parameters"]["preprocessing"]["smoothing"]["interpolation_method"] = method
    path.write_text(yaml.safe_dump(cfg))
    with h5py.File(tmp_path / "output" / f"{name}_{param}" / "observables.h5", "r+") as f:
        for key, design in (("Prediction", 7), ("Prediction_validation", 3)):
            y = f[key][SPIKED]["y"][()]
            y[10, design] = 50.0 * np.abs(y).max()
            f[key][SPIKED]["y"][...] = y
    return path, name, param, cfg


def _assert_same_tree(ours, ref, path=""):
    assert sorted(ours) == sorted(ref), path
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_same_tree(ours[key], ref[key], f"{path}/{key}")
        else:
            np.testing.assert_allclose(np.asarray(ours[key], float), np.asarray(ref[key], float), rtol=1e-12,
                                       err_msg=f"{path}/{key}")


@pytest.mark.parametrize("method", ["linear", "cubic_spline"])
def test_preprocess_matches_jax_on_fixture(tmp_path, method):
    """Both smoothing passes over the training and validation predictions:
    every leaf equal to JAX's at rtol 1e-12, the planted spikes smoothed
    away; the in-memory call (observables passed in) equals the file call."""
    path, name, param, cfg = _smoothing_yaml(tmp_path, method)
    ac = cfg["analyses"][name]
    kw = dict(analysis_name=name, parameterization=param, analysis_config=ac)
    ref = joutliers.preprocess(jconfigs.PreprocessingConfig(**kw, config_file=str(path)))
    tcfg = tconfigs.PreprocessingConfig(**kw, config_file=str(path))
    ours = toutliers.preprocess(tcfg)
    _assert_same_tree(ours, ref)

    raw = jhdf5.read_dict_from_h5(tcfg.output_dir, "observables.h5", verbose=False)
    for key, design in (("Prediction", 7), ("Prediction_validation", 3)):
        assert raw[key][SPIKED]["y"][10, design] != ours[key][SPIKED]["y"][10, design]
        assert abs(ours[key][SPIKED]["y"][10, design]) < 5 * np.abs(raw[key][SPIKED]["y"]).mean()

    in_memory = toutliers.preprocess(tconfigs.PreprocessingConfig(**kw, config=cfg),
                                     tobs.read_observables(tcfg.output_dir, "observables.h5"))
    _assert_same_tree(in_memory, ref)


def test_preprocessing_config_parses_like_jax(tmp_path):
    """PreprocessingConfig from the YAML path and from the parsed dict carry
    JAX's values; an unknown interpolation method raises, as in JAX."""
    path, name, param = make_analysis_yaml(tmp_path)
    cfg = tconfigs.load_yaml(path)
    ac = cfg["analyses"][name]
    kw = dict(analysis_name=name, parameterization=param, analysis_config=ac)
    ref = jconfigs.PreprocessingConfig(**kw, config_file=str(path))
    for ours in (tconfigs.PreprocessingConfig(**kw, config_file=str(path)), tconfigs.PreprocessingConfig(**kw, config=cfg)):
        for attr in ("outlier_n_RMS", "interpolation_method", "max_n_feature_outliers_to_interpolate", "output_dir"):
            assert getattr(ours, attr) == getattr(ref, attr), attr
    ac["parameters"]["preprocessing"]["smoothing"]["interpolation_method"] = "quadratic"
    with pytest.raises(ValueError, match="Unrecognized interpolation method"):
        tconfigs.PreprocessingConfig(**kw, config=cfg)
