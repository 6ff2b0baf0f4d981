"""Serving an exported artifact on the CPU: ``DetectServer.from_exported``,
``cli export`` and ``cli serve --artifact`` (a subprocess).

Tiny models (width 0.125), a 96 x 128 canvas, batch 2. Requests go one at a
time, so each device call holds one image in slot 0; each answer must equal
a direct ``detect_batch`` of that call's batch (after the front end's
rounding for the HTTP answers). JAX is not needed here.
"""

import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from densebox_tpu_torch import cli
from densebox_tpu_torch.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.export import (artifact_meta, export_detect_program,
                                       load_exported, save_exported)
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import DenseBox, init_params
from densebox_tpu_torch.serve import DetectServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (96, 128)
LABEL = LabelCfg(patch_size=64, std_height_px=20.0)
INFER = InferCfg(scales=(1.0,), score_thresh=-1e9, topk_per_scale=32,
                 max_dets=6, lm_topk=4)
INFER_FLAGS = ["--scales", "1.0", "--thresh=-1e9", "--max-dets", "6",
               "--topk-per-scale", "32"]


def _scene(seed, h=90, w=121):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
    y, x = rng.randint(0, h - 30), rng.randint(0, w - 30)
    img[y:y + 25, x:x + 25] = 220
    return img


def _png(rgb):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _direct(model, rgb, infer=INFER):
    """The direct detect of the image alone in slot 0 of a zero batch."""
    x = np.zeros((2,) + CANVAS + (3,), np.float32)
    h, w = rgb.shape[:2]
    x[0, :h, :w] = rgb.astype(np.float32) / 255.0
    with torch.no_grad():
        out = {k: v.numpy() for k, v in detect_batch(
            model, torch.from_numpy(x), infer, LABEL).items()}
    v = out["valid"][0]
    return {k: out[k][0][v] for k in out if k != "valid"}


@pytest.fixture(scope="module")
def lm_artifact(tmp_path_factory):
    """A landmark model (refine, loc bias raised so boxes span pixels) and
    its artifact for (2, 96, 128)."""
    cfg = ModelCfg(width_mult=0.125, num_landmarks=4, use_refine=True)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    sd["loc.loc_conv2.bias"] += 1.0
    model = DenseBox(cfg, device="cpu")
    model.load_state_dict(sd)
    path = str(tmp_path_factory.mktemp("art") / "lm.pt2")
    ep = export_detect_program(model, INFER, LABEL, 2, CANVAS, device="cpu")
    save_exported(path, ep, artifact_meta(model, INFER, 2, CANVAS))
    return model.eval(), path


def test_from_exported_serves_the_artifact(lm_artifact):
    model, path = lm_artifact
    server = DetectServer.from_exported(path, batch_window_ms=1.0,
                                        device="cpu")
    try:
        assert (server.max_batch, server.canvas_hw) == (2, CANVAS)
        assert server.meta == load_exported(path, "cpu")[1]
        assert server.stats == {"requests": 0, "device_calls": 0}
        for seed in range(3):
            rgb = _scene(seed)
            got = server.submit(rgb.astype(np.float32) / 255.0)
            want = _direct(model, rgb)
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), (seed, k)
            assert len(want["boxes"]) > 0 and want["lm_valid"].any()
    finally:
        server.close()
    assert server.stats == {"requests": 3, "device_calls": 3}


def test_from_exported_batch_is_the_artifacts(lm_artifact):
    _, path = lm_artifact
    with pytest.raises(ValueError, match="re-export"):
        DetectServer.from_exported(path, max_batch=4, warmup=False,
                                   device="cpu")
    server = DetectServer.from_exported(path, max_batch=2, warmup=False,
                                        device="cpu")
    server.close()
    with pytest.raises(ValueError, match="re-export"):
        DetectServer.from_exported(path, warmup=False, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            DetectServer.from_exported(path)
        with pytest.raises(RuntimeError, match="CUDA card"):
            load_exported(path)


def _train(work):
    assert cli.main(["train", "--synthetic", "--workdir", work, "--steps",
                     "1", "--batch-size", "2", "--width-mult", "0.125",
                     "--patch-size", "64", "--std-height", "20",
                     "--max-boxes", "2", "--device", "cpu"]) == 0


def test_cli_export_then_serve_artifact(tmp_path, capsys):
    """``cli export`` of a trained workdir (verified by a reload and a
    call), then ``python -m densebox_tpu_torch.cli serve --artifact`` as a
    subprocess: /healthz reports the artifact's metadata, each POSTed PNG
    is answered as a direct detect of the checkpoint's model, SIGINT ends
    it with rc 0. Without --workdir and --artifact serve exits 2."""
    from densebox_tpu_torch.train import load_for_inference

    work = str(tmp_path / "run")
    _train(work)
    out = str(tmp_path / "art" / "detect.pt2")
    capsys.readouterr()
    assert cli.main(["export", "--workdir", work, "--out", out, "--batch",
                     "2", "--canvas", *map(str, CANVAS), *INFER_FLAGS,
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "device cpu" in printed and "verify: reload + call ok" in printed
    meta = load_exported(out, "cpu")[1]
    assert (meta["batch"], meta["canvas"], meta["quantized"]) == \
        (2, list(CANVAS), False)
    assert cli.main(["serve", "--device", "cpu"]) == 2

    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "densebox_tpu_torch.cli", "serve",
         "--artifact", out, "--port", "0", "--batch-window-ms", "1",
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    answers = []
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        for seed in (10, 11):
            conn.request("POST", "/detect", body=_png(_scene(seed)))
            answers.append(json.loads(conn.getresponse().read()))
        conn.close()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0
    assert health["artifact"] == out and health["max_batch"] == 2
    assert {k: health[k] for k in meta} == meta
    cfg, sd = load_for_inference(os.path.join(work, "ckpt"), "cpu")
    model = DenseBox(cfg.model, device="cpu")
    model.load_state_dict(sd)
    infer = dataclasses.replace(cfg.infer, scales=(1.0,), score_thresh=-1e9,
                                max_dets=6, topk_per_scale=32)
    for seed, resp in zip((10, 11), answers):
        want = _direct(model.eval(), _scene(seed), infer)
        assert resp == json.loads(json.dumps({
            "n": len(want["boxes"]),
            "boxes": np.round(want["boxes"], 2).tolist(),
            "scores": np.round(want["scores"], 4).tolist()}))
        assert resp["n"] == 6


def test_cli_export_quantized(tmp_path, capsys):
    """``export --quantize`` calibrates as ``quantize`` does (synthetic
    canvases here) and writes the int8 program: its metadata says so and its
    answers equal the live int8 model's."""
    from densebox_tpu_torch.models import QuantDenseBox
    from densebox_tpu_torch.train import load_for_inference

    work = str(tmp_path / "run")
    _train(work)
    out = str(tmp_path / "q.pt2")
    assert cli.main(["export", "--workdir", work, "--out", out, "--batch",
                     "2", "--canvas", *map(str, CANVAS), "--quantize",
                     "--no-verify", *INFER_FLAGS, "--device", "cpu"]) == 0
    assert "verify" not in capsys.readouterr().out
    call, meta = load_exported(out, "cpu")
    assert meta["quantized"] and meta["backend"] == "fused"
    cfg, sd = load_for_inference(os.path.join(work, "ckpt"), "cpu")
    model = DenseBox(cfg.model, device="cpu")
    model.load_state_dict(sd)
    qmodel = cli._quantize(model, cfg, None, None, "cpu")
    assert isinstance(qmodel, QuantDenseBox)
    infer = dataclasses.replace(cfg.infer, scales=(1.0,), score_thresh=-1e9,
                                max_dets=6, topk_per_scale=32)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, *CANVAS, 3)
                         .astype(np.float32))
    got = call(x)
    with torch.no_grad():
        want = detect_batch(qmodel.eval(), x, infer, cfg.label)
    for k in want:
        assert torch.equal(got[k], want[k]), k
