"""The port's own config tree and presets equal the JAX package's, field by
field: names, order, defaults, properties and the presets' dicts, so that a
config dict of either package loads in the other."""

import dataclasses

import pytest

from densebox_tpu import config as jax_config
from densebox_tpu import presets as jax_presets
from densebox_tpu_torch import config, presets

CLASSES = ["ModelCfg", "LabelCfg", "LossCfg", "InferCfg", "TrainCfg",
           "DenseBoxConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours(), dataclasses.fields(ours)[0].name, None)
    assert hash(ours()) == hash(ours())


@pytest.mark.parametrize("preset,kw", [
    ("kitti_vehicle", {}), ("kitti_vehicle", dict(width_mult=0.5, fast=True)),
    ("malf_face", {}), ("malf_face", dict(num_landmarks=72, fast=True))])
def test_presets_equal_and_load_across_packages(preset, kw):
    ours = getattr(presets, preset)(**kw)
    theirs = getattr(jax_presets, preset)(**kw)
    assert ours.to_dict() == theirs.to_dict()
    assert config.DenseBoxConfig.from_dict(theirs.to_dict()) == ours
    assert jax_config.DenseBoxConfig.from_dict(ours.to_dict()) == theirs


def test_derived_values_equal():
    for kw in ({}, dict(patch_size=64, std_height_px=20.0, stride=4),
               dict(scale_band=(0.7, 1.3), std_height_px=33.0)):
        a, b = config.LabelCfg(**kw), jax_config.LabelCfg(**kw)
        assert (a.map_size, a.loc_norm, a.height_band_map) == \
            (b.map_size, b.loc_norm, b.height_band_map)
    for w in (0.125, 0.25, 0.3, 1.0):
        for c in (3, 64, 100, 512):
            assert config.ModelCfg(width_mult=w).scaled(c) == \
                jax_config.ModelCfg(width_mult=w).scaled(c)
    for model_dt in ("float32", "bfloat16"):
        for crop in ("auto", "float32", "bfloat16"):
            for canvas in ("auto", "float32", "bfloat16"):
                def mk(mod):
                    return mod.DenseBoxConfig(
                        model=mod.ModelCfg(compute_dtype=model_dt),
                        train=mod.TrainCfg(crop_dtype=crop,
                                           canvas_dtype=canvas))
                assert config.resolved_canvas_dtype(mk(config)) == \
                    jax_config.resolved_canvas_dtype(mk(jax_config))


def test_from_dict_ignores_unknown_keys_and_takes_lists():
    d = presets.malf_face().to_dict()
    d["model"]["not_a_field"] = 1
    d["infer"]["scales"] = list(d["infer"]["scales"])
    assert config.DenseBoxConfig.from_dict(d) == presets.malf_face()
