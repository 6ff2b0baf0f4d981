"""The port's checkpoints on the CPU: step files with keep-last-N, atomic
writes, the config round trip, exact restore into a fresh state,
``load_for_inference`` and the int8 export.

Tiny shapes (width 0.125, 64 px patches), ``device="cpu"``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from densebox_tpu_torch import (DenseBox, DenseBoxConfig, QuantDenseBox,
                                kitti_vehicle, malf_face, quantize_densebox)
from densebox_tpu_torch.data import synthetic_batch
from densebox_tpu_torch.train import (create_train_state, fit,
                                      is_quantized_dir, load_for_inference,
                                      load_quantized, make_manager,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint, save_quantized)
import torch_threads  # noqa: F401  (sets torch's threads)


def _tiny(preset=kitti_vehicle):
    cfg = preset()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, width_mult=0.125),
        label=dataclasses.replace(cfg.label, patch_size=64,
                                  std_height_px=20.0),
        train=dataclasses.replace(cfg.train, batch_size=2, max_boxes=3,
                                  seed=5))


def _trained_state(cfg, steps=2):
    model = DenseBox(cfg.model, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    for i in range(steps):
        step(state, synthetic_batch(
            torch.Generator().manual_seed(i), 2, cfg.label, 3,
            cfg.model.num_landmarks, device="cpu"))
    return state


@pytest.mark.parametrize("preset", [kitti_vehicle, malf_face])
def test_config_json_round_trip(preset):
    for cfg in (preset(), _tiny(preset)):
        again = DenseBoxConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
        assert again == cfg


@pytest.mark.parametrize("keep", [1, 3])
def test_keep_last_n_and_latest_step(keep, tmp_path):
    cfg = _tiny()
    state = _trained_state(cfg, steps=0)
    mngr = make_manager(str(tmp_path / "ckpt"), keep)
    assert mngr.latest_step() is None and mngr.all_steps() == []
    assert restore_checkpoint(mngr, state, device="cpu") is None
    for step in (1, 2, 10, 11, 300):
        state.step = step
        save_checkpoint(mngr, state, cfg)
        assert mngr.latest_step() == step
    assert mngr.all_steps() == [1, 2, 10, 11, 300][-keep:]
    assert sorted(os.listdir(mngr.directory)) == [
        f"step_{s:08d}.pt" for s in [1, 2, 10, 11, 300][-keep:]]
    mngr.wait_until_finished()
    # a second manager over the same directory sees the same steps
    assert make_manager(str(tmp_path / "ckpt"), keep).latest_step() == 300


def test_leftover_temporary_file_is_ignored(tmp_path):
    """A save cut before its rename leaves a temporary file: it is no
    checkpoint, and the step before it is still the latest."""
    cfg = _tiny()
    state = _trained_state(cfg, steps=1)
    mngr = make_manager(str(tmp_path / "ckpt"), 3)
    save_checkpoint(mngr, state, cfg)
    for name in (".step_00000009.pt.tmp", "step_00000009.pt.part", "notes"):
        with open(os.path.join(mngr.directory, name), "wb") as f:
            f.write(b"half a file")
    assert mngr.all_steps() == [1] and mngr.latest_step() == 1
    restored, _ = restore_checkpoint(
        mngr, _trained_state(cfg, steps=0), device="cpu")
    assert restored.step == 1
    # the next save of that step replaces the leftover and lands whole
    state.step = 9
    save_checkpoint(mngr, state, cfg)
    assert mngr.all_steps() == [1, 9]
    assert ".step_00000009.pt.tmp" not in os.listdir(mngr.directory)


@pytest.mark.parametrize("preset", [kitti_vehicle, malf_face])
def test_restore_into_a_fresh_state_is_exact(preset, tmp_path):
    cfg = _tiny(preset)
    state = _trained_state(cfg)
    state.salt = 77
    mngr = make_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mngr, state, cfg)
    fresh = create_train_state(DenseBox(cfg.model, device="cpu"),
                               dataclasses.replace(cfg, train=dataclasses.replace(
                                   cfg.train, seed=0)), device="cpu")
    assert fresh.seed == 0 and state.seed == 5
    restored, stored_cfg = restore_checkpoint(mngr, fresh, device="cpu")
    assert restored is fresh and stored_cfg == cfg
    assert (fresh.step, fresh.seed, fresh.salt) == (2, 5, 77)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k]), k
    for k, v in state.momentum.items():
        assert torch.equal(v, fresh.momentum[k]), k
        assert float(v.abs().max()) > 0
    # another model's checkpoint does not load
    other = _tiny(malf_face if preset is kitti_vehicle else kitti_vehicle)
    with pytest.raises((RuntimeError, ValueError)):
        restore_checkpoint(mngr, create_train_state(
            DenseBox(other.model, device="cpu"), other, device="cpu"),
            device="cpu")


def test_checkpoint_file_holds_tensors_and_plain_python_only(tmp_path):
    cfg = _tiny()
    mngr = make_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mngr, _trained_state(cfg, steps=1), cfg)
    payload = torch.load(mngr.path(1), weights_only=True)
    assert set(payload) == {"format", "step", "seed", "salt", "params",
                            "momentum", "config"}
    assert payload["step"] == 1 and payload["seed"] == 5
    assert DenseBoxConfig.from_dict(json.loads(payload["config"])) == cfg
    assert all(v.device.type == "cpu" for v in payload["params"].values())
    with open(mngr.path(1), "wb") as f:
        torch.save({"format": 99}, f)
    with pytest.raises(ValueError, match="format"):
        mngr.load(1)


def test_load_for_inference_gives_the_trained_model(tmp_path):
    cfg = dataclasses.replace(_tiny(malf_face), train=dataclasses.replace(
        _tiny(malf_face).train, ckpt_every=2, log_every=2))

    def batches(step):
        return synthetic_batch(torch.Generator().manual_seed(step), 2,
                               cfg.label, 3, cfg.model.num_landmarks,
                               device="cpu")

    res = fit(cfg, batches, str(tmp_path / "run"), num_steps=3,
              sample_from_canvas=False, device="cpu")
    got_cfg, sd = load_for_inference(str(tmp_path / "run" / "ckpt"),
                                     device="cpu")
    assert got_cfg == cfg
    model = DenseBox(got_cfg.model, device="cpu").eval()
    model.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3)
                         .astype(np.float32))
    with torch.inference_mode():
        want = res.state.model.eval()(x)
        got = model(x)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for missing in (tmp_path / "nothing", tmp_path):
        with pytest.raises(FileNotFoundError):
            load_for_inference(str(missing), device="cpu")


def test_quantized_export_round_trip(tmp_path):
    cfg = _tiny()
    model = DenseBox(cfg.model, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    calib = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3)
                             .astype(np.float32))
    qparams = quantize_densebox(model.state_dict(), cfg.model, calib)
    export = str(tmp_path / "int8")
    assert not is_quantized_dir(export)
    save_quantized(export, qparams, cfg, calibration="2 random images")
    assert is_quantized_dir(export)
    got_cfg, got, note = load_quantized(export, device="cpu")
    assert got_cfg == cfg and note == "2 random images"
    assert set(got) == set(qparams)
    for k, v in qparams.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    qmodel = QuantDenseBox(cfg.model, device="cpu").eval()
    qmodel.load_state_dict(got)
    want_model = QuantDenseBox(cfg.model, device="cpu").eval()
    want_model.load_state_dict(qparams)
    with torch.inference_mode():
        for k, v in want_model(calib).items():
            assert torch.equal(qmodel(calib)[k], v), k
    # exporting again over the export replaces it
    qparams2 = {k: (v + 1 if v.dtype == torch.float32 else v)
                for k, v in qparams.items()}
    save_quantized(export, qparams2, cfg)
    _, got2, note2 = load_quantized(export, device="cpu")
    assert note2 == "" and all(torch.equal(got2[k], v)
                               for k, v in qparams2.items())
    assert sorted(os.listdir(export)) == ["quantized.json", "step_00000000.pt"]
    # a training run's directory is refused and left as it was
    mngr = make_manager(str(tmp_path / "run"))
    save_checkpoint(mngr, state, cfg)
    before = sorted(os.listdir(mngr.directory))
    with pytest.raises(FileExistsError):
        save_quantized(mngr.directory, qparams, cfg)
    assert sorted(os.listdir(mngr.directory)) == before
    assert not is_quantized_dir(mngr.directory)
    with pytest.raises(FileNotFoundError):
        load_quantized(str(tmp_path / "nothing"), device="cpu")


def test_checkpoint_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = _tiny()
    state = _trained_state(cfg, steps=0)
    mngr = make_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mngr, state, cfg)
    save_quantized(str(tmp_path / "int8"), {}, cfg)
    for call in (lambda: restore_checkpoint(mngr, state),
                 lambda: load_for_inference(mngr.directory),
                 lambda: load_quantized(str(tmp_path / "int8"))):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
