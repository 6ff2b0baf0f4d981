"""The port's command line (``densebox_tpu_torch/cli.py``) on the CPU:
``train`` (KITTI directory and synthetic), ``detect`` (images, video,
int8), ``quantize``, ``eval``, their refusals, and ``eval``'s summary
against the JAX package's functions on the same weights and files.

Tiny models (width 0.125, 64 px patches, 2 to 4 steps), ``--device cpu``,
data written by the tests. The ``eval`` parity case carries JAX's Flax
weights into the port (``models/convert.py:from_flax``) with the loc head's
output bias raised by one, so that boxes have extent, and computes JAX's
summary with the functions JAX's ``cmd_eval`` calls (``canvas_batch``,
``detect_batch`` run eagerly, ``detections_to_numpy``,
``evaluate_detections``, ``evaluate_kitti``). Bar: the same keys, equal
counts, and every AP equal to the 4 decimals printed.
"""

import dataclasses
import json
import os
import re
import sys
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu import config as jax_config
from densebox_tpu import eval as jax_eval
from densebox_tpu.data import kitti as jax_kitti
from densebox_tpu.data import pipeline as jax_pipeline
from densebox_tpu.infer import detector as jax_detector
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu_torch import cli
from densebox_tpu_torch.config import DenseBoxConfig, LabelCfg, ModelCfg
from densebox_tpu_torch.models import DenseBox, from_flax
from densebox_tpu_torch.train import (create_train_state, load_for_inference,
                                      make_manager, save_checkpoint)
import torch_threads  # noqa: F401  (sets torch's threads)

TINY = ["--width-mult", "0.125", "--patch-size", "64", "--std-height", "20",
        "--max-boxes", "3", "--batch-size", "2", "--device", "cpu"]
# steps of the landmark run: enough for some detections to match a GT box
STEPS_LM = 30
KITTI = ("{cls} {trunc:.2f} {occ} -1.58 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
         "1.57 1.73 4.15 1.00 1.75 13.22 -1.62")


def _scene_dir(root, n=6, hw=(128, 160), num_lm=0, seed=0, big=None):
    """A KITTI directory of PNG scenes with bright boxes, their labels
    (vehicles, a pedestrian, DontCare; with ``num_lm`` the box corners as
    keypoints) and, with ``big``, one more image of that size."""
    rng = np.random.RandomState(seed)
    (root / "image_2").mkdir(parents=True)
    (root / "label_2").mkdir()
    shapes = [hw] * n + ([big] if big else [])
    for i, (h, w) in enumerate(shapes):
        img = (rng.rand(h, w, 3) * 50).astype(np.uint8)
        lines = []
        for j in range(rng.randint(1, 4)):
            s = rng.uniform(26, 48)
            x1, y1 = rng.uniform(2, w - s - 2), rng.uniform(2, h - s - 2)
            img[int(y1):int(y1 + s), int(x1):int(x1 + s)] = 220
            line = KITTI.format(cls=("Car", "Van", "Pedestrian")[j % 3],
                                trunc=rng.choice([0.0, 0.2, 0.4]),
                                occ=rng.randint(0, 3), x1=x1, y1=y1,
                                x2=x1 + s, y2=y1 + s)
            if num_lm:
                pts = [x1, y1, x1 + s, y1, x1 + s, y1 + s, x1, y1 + s]
                line += " " + " ".join(f"{v:.2f}" for v in pts[:2 * num_lm])
            lines.append(line)
        lines.append("DontCare -1 -1 -10 0.00 0.00 12.00 9.00 -1 -1 -1 -1000 "
                     "-1000 -1000 -10")
        assert cv2.imwrite(str(root / "image_2" / f"{i:06d}.png"), img)
        (root / "label_2" / f"{i:06d}.txt").write_text("\n".join(lines))
    return str(root)


def _train(work, *extra, steps=2):
    return cli.main(["train", "--workdir", work, "--steps", str(steps),
                     "--ckpt-every", str(steps), "--log-every", "1",
                     *TINY, *extra])


def _detections(out):
    return int(re.search(r": (\d+) detections", out).group(1))


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    """A workdir trained 2 steps on synthetic data, with inference settings
    given at train time."""
    work = str(tmp_path_factory.mktemp("cli") / "run")
    assert _train(work, "--synthetic", "--thresh=-1000", "--scales", "1.0",
                  "--max-dets", "4", "--topk-per-scale", "16",
                  "--lm-decode", "finest") == 0
    return work


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    rng = np.random.RandomState(0)
    img = (rng.rand(90, 121, 3) * 40).astype(np.uint8)
    img[30:58, 40:68] = 230
    path = str(tmp_path_factory.mktemp("img") / "scene.png")
    assert cv2.imwrite(path, img)
    return path


def test_train_synthetic_checkpoint_round_trips_flags(synthetic_run):
    cfg, _ = load_for_inference(os.path.join(synthetic_run, "ckpt"), "cpu")
    assert cfg.model.width_mult == 0.125 and cfg.model.compute_dtype == \
        "float32"
    assert cfg.label.patch_size == 64 and cfg.label.std_height_px == 20.0
    assert (cfg.train.batch_size, cfg.train.max_boxes, cfg.train.num_steps) \
        == (2, 3, 2)
    assert cfg.infer.score_thresh == -1000 and cfg.infer.scales == (1.0,)
    assert (cfg.infer.max_dets, cfg.infer.topk_per_scale,
            cfg.infer.lm_decode) == (4, 16, "finest")
    assert make_manager(os.path.join(synthetic_run, "ckpt")).all_steps() == [2]


def test_detect_honours_checkpoint_and_flags(synthetic_run, image, tmp_path,
                                             capsys):
    """No inference flag: the checkpoint's (thresh -1000, max_dets 4) hold;
    an explicit flag wins. KITTI result files round-trip through the
    parser; the annotated image is written."""
    capsys.readouterr()
    kit = str(tmp_path / "kitti")
    assert cli.main(["detect", "--workdir", synthetic_run, "--image", image,
                     "--out", str(tmp_path / "d"), "--save-kitti", kit,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _detections(out) == 4
    assert os.path.exists(tmp_path / "d" / "scene.png")
    res = os.path.join(kit, "scene.txt")
    lines = open(res).read().strip().splitlines()
    assert len(lines) == 4 and all(len(ln.split()) == 16 for ln in lines)
    from densebox_tpu_torch.data.kitti import parse_label_file

    cols = np.array([ln.split()[4:8] for ln in lines], np.float32)
    proper = cols[(cols[:, 2] > cols[:, 0]) & (cols[:, 3] > cols[:, 1])]
    np.testing.assert_array_equal(parse_label_file(res)[0], proper)
    assert cli.main(["detect", "--workdir", synthetic_run, "--image", image,
                     "--out", str(tmp_path / "d2"), "--thresh", "1000",
                     "--device", "cpu"]) == 0
    assert _detections(capsys.readouterr().out) == 0


def test_detect_without_cv2(synthetic_run, image, tmp_path, capsys):
    """Without cv2: the same detections printed, the KITTI files written, a
    note on stderr instead of the annotated image; --video exits 2."""
    capsys.readouterr()
    args = ["detect", "--workdir", synthetic_run, "--image", image,
            "--device", "cpu"]
    assert cli.main(args + ["--out", str(tmp_path / "a"), "--save-kitti",
                            str(tmp_path / "ka")]) == 0
    with_cv2 = capsys.readouterr().out
    with mock.patch.dict(sys.modules, {"cv2": None}):
        assert cli.main(args + ["--out", str(tmp_path / "b"), "--save-kitti",
                                str(tmp_path / "kb")]) == 0
        got = capsys.readouterr()
        assert cli.main(["detect", "--workdir", synthetic_run, "--video",
                         image, "--device", "cpu"]) == 2
        video_err = capsys.readouterr().err
    assert "no annotated image written" in got.err and "cv2" in got.err
    assert not os.path.exists(tmp_path / "b" / "scene.png")
    boxes = [ln for ln in got.out.splitlines() if "box=" in ln]
    assert boxes and boxes == [ln for ln in with_cv2.splitlines()
                               if "box=" in ln]
    assert (tmp_path / "kb" / "scene.txt").read_bytes() == \
        (tmp_path / "ka" / "scene.txt").read_bytes()
    assert "--video needs OpenCV (cv2)" in video_err


def test_detect_video(synthetic_run, tmp_path):
    vid = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (128, 96))
    rng = np.random.RandomState(0)
    for t in range(5):
        f = (rng.rand(96, 128, 3) * 40).astype(np.uint8)
        f[30:52, 20 + 6 * t:42 + 6 * t] = 230
        w.write(f)
    w.release()
    out = str(tmp_path / "dets")
    assert cli.main(["detect", "--workdir", synthetic_run, "--video", vid,
                     "--video-batch", "2", "--out", out,
                     "--device", "cpu"]) == 0
    cap = cv2.VideoCapture(os.path.join(out, "in_dets.avi"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 5
    assert cli.main(["detect", "--workdir", synthetic_run,
                     "--device", "cpu"]) == 2


def test_quantize_then_detect_and_eval(synthetic_run, image, tmp_path,
                                       capsys):
    q = str(tmp_path / "q")
    capsys.readouterr()
    assert cli.main(["quantize", "--workdir", synthetic_run, "--out", q,
                     "--calib-dir", os.path.dirname(image),
                     "--device", "cpu"]) == 0
    assert "calibration: --calib-dir" in capsys.readouterr().out
    assert os.path.exists(os.path.join(q, "ckpt", "quantized.json"))
    kit = str(tmp_path / "k")
    assert cli.main(["detect", "--workdir", q, "--image", image,
                     "--out", str(tmp_path / "d"), "--save-kitti", kit,
                     "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert "int8 checkpoint (calibration: --calib-dir" in got.err
    assert _detections(got.out) == 4
    assert os.path.exists(os.path.join(kit, "scene.txt"))
    assert cli.main(["eval", "--workdir", q, "--synthetic", "--batch-size",
                     "2", "--eval-batches", "1", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 2 and summary["n_pred"] > 0
    assert cli.main(["quantize", "--workdir", q, "--out", str(tmp_path / "x"),
                     "--device", "cpu"]) == 2


def test_detect_quantize_calibrates_on_the_input_images(synthetic_run, image,
                                                        tmp_path, capsys):
    capsys.readouterr()
    assert cli.main(["detect", "--workdir", synthetic_run, "--image", image,
                     "--out", str(tmp_path / "d"), "--quantize",
                     "--dtype", "bfloat16", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "int8 calibration: 1 images from the input images" in err
    assert "--dtype is ignored with --quantize" in err
    assert cli.main(["detect", "--workdir", synthetic_run, "--image", image,
                     "--out", str(tmp_path / "e"), "--dtype", "bfloat16",
                     "--device", "cpu"]) == 0
    assert _detections(capsys.readouterr().out) == 4


def test_missing_source_or_workdir_exits_2(tmp_path, image):
    for argv in (["train", "--workdir", str(tmp_path), "--device", "cpu"],
                 ["eval", "--workdir", str(tmp_path), "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
    nowhere = str(tmp_path / "nowhere")
    for argv in (["detect", "--workdir", nowhere, "--image", image],
                 ["eval", "--workdir", nowhere, "--synthetic"],
                 ["quantize", "--workdir", nowhere, "--out", nowhere],
                 ["serve", "--workdir", nowhere]):
        assert cli.main(argv + ["--device", "cpu"]) == 2, argv[0]


def test_no_device_and_no_card_raises(synthetic_run, image, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for argv in (["train", "--synthetic", "--workdir", str(tmp_path)],
                 ["detect", "--workdir", synthetic_run, "--image", image],
                 ["quantize", "--workdir", synthetic_run, "--out",
                  str(tmp_path / "q")],
                 ["serve", "--workdir", synthetic_run],
                 ["eval", "--workdir", synthetic_run, "--synthetic"]):
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main(argv)


def test_tpu_only_flags_are_not_offered():
    for flag in ("--nms-backend", "--lm-backend", "--approx-topk",
                 "--dropout-impl", "--skip-fusion", "--pool-impl",
                 "--head-impl", "--artifact"):
        with pytest.raises(SystemExit):
            cli.main(["train", "--synthetic", "--workdir", "x", flag, "jax",
                      "--device", "cpu"])
    # export exists since the port has torch.export artifacts; its TPU/CPU
    # lowering knob does not (--device takes its place)
    with pytest.raises(SystemExit):
        cli.main(["export", "--workdir", "x", "--out", "y", "--platforms",
                  "tpu,cpu", "--device", "cpu"])


def test_max_restarts_reenters_fit_salted(tmp_path, capsys):
    """A raised step: --max-restarts 1 calls fit again with run_salt=1 and
    resume; without restarts the error propagates."""
    from densebox_tpu_torch import train

    calls = []
    real_fit = train.fit

    def flaky(cfg, batches, **kw):
        calls.append(kw)
        if len(calls) == 1:
            real_fit(cfg, batches, **{**kw, "num_steps": 1})
            raise FloatingPointError("step 2 failed")
        return real_fit(cfg, batches, **kw)

    work = str(tmp_path / "run")
    with mock.patch.object(train, "fit", flaky):
        assert _train(work, "--synthetic", "--max-restarts", "1",
                      "--no-resume") == 0
    out = capsys.readouterr().out
    assert [(c["run_salt"], c["resume"]) for c in calls] == [(0, False),
                                                             (1, True)]
    assert "[restart 1/1] step failed: FloatingPointError" in out
    assert "resumed from step 1" in out and "done at step 2" in out
    calls.clear()
    with mock.patch.object(train, "fit", flaky):
        with pytest.raises(FloatingPointError):
            _train(str(tmp_path / "other"), "--synthetic")


def test_no_resume_starts_over(tmp_path, capsys):
    work = str(tmp_path / "run")
    assert _train(work, "--synthetic") == 0
    capsys.readouterr()
    assert _train(work, "--synthetic", steps=3) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done at step 3" in out
    assert _train(work, "--synthetic", "--no-resume", steps=3) == 0
    out = capsys.readouterr().out
    assert "resumed" not in out and "[train step 1]" in out


def test_synthetic_resume_is_bit_exact(tmp_path):
    """--synthetic batches are keyed by the step: 2 steps, then a resume to
    4, leave the parameters and momentum of 4 steps straight."""
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    assert _train(straight, "--synthetic", steps=4) == 0
    assert _train(resumed, "--synthetic", steps=2) == 0
    assert _train(resumed, "--synthetic", steps=4) == 0
    a, b = (make_manager(os.path.join(w, "ckpt")) for w in (straight,
                                                            resumed))
    pa, pb = a.load(4), b.load(4)
    for key in ("params", "momentum"):
        assert pa[key].keys() == pb[key].keys()
        for k in pa[key]:
            assert torch.equal(pa[key][k], pb[key][k]), (key, k)


def test_train_profile_and_debug_nans(tmp_path):
    work = str(tmp_path / "run")
    try:
        assert _train(work, "--synthetic", "--profile", "--debug-nans",
                      steps=1) == 0
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    traces = os.listdir(os.path.join(work, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    trace = json.load(open(os.path.join(work, "profile", traces[0])))
    assert trace["traceEvents"]


def test_train_on_kitti_dir_with_landmarks_then_eval(tmp_path, capsys):
    """KITTI files with the keypoint extension through the loader, the
    canvas step and the real-data eval branch, which reports the NME."""
    root = _scene_dir(tmp_path / "kitti", n=4, num_lm=4)
    work = str(tmp_path / "run")
    assert _train(work, "--data-dir", root, "--canvas", "128", "160",
                  "--landmarks", "4", "--lm-flip-perm", "1,0,3,2",
                  "--lm-anchors", "0,0,1,0,1,1,0,1", "--std-height", "30",
                  "--lr", "3e-3", steps=STEPS_LM) == 0
    out = capsys.readouterr().out
    assert "loaded 4 samples" in out and "loader backend: " in out
    assert f"done at step {STEPS_LM}" in out
    cfg, _ = load_for_inference(os.path.join(work, "ckpt"), "cpu")
    assert cfg.model.num_landmarks == 4 and cfg.model.use_refine
    assert cfg.label.lm_flip_perm == (1, 0, 3, 2)
    assert cfg.label.lm_anchors == ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0),
                                    (0.0, 1.0))
    assert cli.main(["eval", "--workdir", work, "--data-dir", root,
                     "--batch-size", "2", "--canvas", "128", "160",
                     "--scales", "1.0", "--thresh=-1000",
                     "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 4 and "landmark_nme" in summary
    assert summary["n_lm_matched"] > 0


def test_eval_default_threshold_is_low(synthetic_run, monkeypatch):
    seen = {}
    real = cli._merged_infer_cfg

    def spy(base, args):
        seen["thresh"] = args.thresh
        return real(base, args)

    monkeypatch.setattr(cli, "_merged_infer_cfg", spy)
    assert cli.main(["eval", "--workdir", synthetic_run, "--synthetic",
                     "--batch-size", "2", "--eval-batches", "1",
                     "--device", "cpu"]) == 0
    assert seen["thresh"] == 0.3


def _jax_summary(jmodel, params, jcfg, root, batch, canvas):
    """What JAX's ``cmd_eval --protocol kitti`` prints, computed with the
    functions it calls, detect_batch run eagerly."""
    samples = jax_kitti.load_dataset(os.path.join(root, "image_2"),
                                     os.path.join(root, "label_2"))
    per_image, kitti_items = [], []
    for i in range(0, len(samples) - batch + 1, batch):
        b = jax_pipeline.canvas_batch(samples[i:i + batch], canvas,
                                      max_boxes=64)
        with jax.disable_jit():
            dets = jax_detector.detect_batch(jmodel, params,
                                             jnp.asarray(b["image"]),
                                             jcfg.infer, jcfg.label)
        d_np = jax_eval.detections_to_numpy(dets, b["boxes"], b["box_valid"])
        per_image += d_np
        for k, s in enumerate(samples[i:i + batch]):
            f = float(b["scale"][k])
            kitti_items.append({"pred_boxes": d_np[k]["pred_boxes"] / f,
                                "pred_scores": d_np[k]["pred_scores"],
                                "gt_boxes": s.boxes,
                                "gt_truncation": s.truncation,
                                "gt_occlusion": s.occlusion,
                                "dontcare": s.dontcare})
    res = jax_eval.evaluate_detections(per_image, iou_thresh=0.5)
    summary = {"ap@0.50": round(res["ap"], 4), "n_images": len(per_image),
               "n_gt": int(res["n_gt"]), "n_pred": int(res["n_pred"])}
    kres = jax_eval.evaluate_kitti(kitti_items, iou_thresh=0.7)
    for d in ("easy", "moderate", "hard"):
        v = kres[f"ap_{d}"]
        summary[f"kitti_ap_{d}@0.70"] = round(v, 4) if v == v else None
        summary[f"kitti_n_gt_{d}"] = int(kres[f"n_gt_{d}"])
    return summary


def test_eval_summary_equals_jax(tmp_path, capsys):
    """The port's ``eval --protocol kitti`` on a workdir holding JAX's
    weights prints JAX's summary for the same files (one image larger than
    the canvas, so predictions map back through the canvas scale)."""
    root = _scene_dir(tmp_path / "kitti", n=5, seed=3, big=(160, 200))
    model_cfg = ModelCfg(width_mult=0.125)
    jmodel = JaxDenseBox(jax_config.ModelCfg(width_mult=0.125))
    params = jmodel.init(jax.random.key(7), jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(np.asarray, params)
    bias = params["params"]["loc"]["loc_conv2"]["bias"]
    params["params"]["loc"]["loc_conv2"]["bias"] = bias + 1.0
    cfg = DenseBoxConfig(model=model_cfg,
                         label=LabelCfg(patch_size=64, std_height_px=30.0))
    cfg = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, scales=(0.7071, 1.0), score_thresh=0.05, max_dets=24,
        topk_per_scale=48))
    model = DenseBox(model_cfg, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    model.load_state_dict(from_flax(params, model_cfg))
    work = str(tmp_path / "run")
    save_checkpoint(make_manager(os.path.join(work, "ckpt")), state, cfg)

    capsys.readouterr()
    assert cli.main(["eval", "--workdir", work, "--data-dir", root,
                     "--protocol", "kitti", "--batch-size", "2",
                     "--canvas", "128", "160", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    jcfg = jax_config.DenseBoxConfig.from_dict(cfg.to_dict())
    jcfg = dataclasses.replace(jcfg, infer=dataclasses.replace(
        jcfg.infer, score_thresh=0.3, nms_backend="jax"))    # eval's default
    want = _jax_summary(jmodel, params, jcfg, root, 2, (128, 160))
    assert got == want
    assert want["n_pred"] > 0 and want["kitti_n_gt_hard"] > 0
    assert want["n_images"] == 6
