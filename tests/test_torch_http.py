"""The port's HTTP front end (``serve.py:make_http_server``,
``serve_forever``, ``MAX_BODY_BYTES``) over a CPU ``DetectServer``, and the
CLI's ``serve`` subcommand as a subprocess.

Tiny models (width 0.125; the loc head's bias raised by one so that boxes
span a few map pixels), a 96 x 128 canvas, ``max_batch`` 2. Requests are
posted one at a time, so each device call holds one image in slot 0; each
response must equal, after the JSON round trip, the rounding JAX's front
end applies (boxes and points to 2 decimals, scores to 4) to a direct
``detect_batch`` of that call's batch.
"""

import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

from densebox_tpu_torch.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import DenseBox
from densebox_tpu_torch.serve import (MAX_BODY_BYTES, DetectServer,
                                      make_http_server, serve_forever)
import torch_threads  # noqa: F401  (sets torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (96, 128)
LABEL = LabelCfg(patch_size=64, std_height_px=20.0)
INFER = InferCfg(scales=(1.0,), score_thresh=-1e9, topk_per_scale=32,
                 max_dets=6, lm_topk=4)


def _model(num_lm=0, seed=0):
    torch.manual_seed(seed)
    cfg = ModelCfg(width_mult=0.125, num_landmarks=num_lm,
                   use_refine=num_lm > 0)
    model = DenseBox(cfg, device="cpu")
    with torch.no_grad():
        model.loc.loc_conv2.bias += 1.0
    return model.eval()


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


def _want(model, rgb, infer=INFER, device="cpu"):
    """The response a direct detect_batch of the request's device call
    gives: the image in slot 0 of a zeroed canvas batch."""
    x = np.zeros((2,) + CANVAS + (3,), np.float32)
    h, w = rgb.shape[:2]
    x[0, :h, :w] = rgb.astype(np.float32) / 255.0
    with torch.inference_mode():
        out = {k: v.cpu().numpy() for k, v in detect_batch(
            model, torch.from_numpy(x).to(device), infer, LABEL).items()}
    v = out["valid"][0]
    want = {"n": int(v.sum()),
            "boxes": np.round(out["boxes"][0][v], 2).tolist(),
            "scores": np.round(out["scores"][0][v], 4).tolist()}
    if "lm_points" in out:
        want["lm_points"] = np.round(out["lm_points"][0][v], 2).tolist()
        want["lm_valid"] = out["lm_valid"][0][v].tolist()
    return json.loads(json.dumps(want))


class _Front:
    """A DetectServer behind make_http_server, served by serve_forever in a
    thread until ``close``."""

    def __init__(self, model, info=None, device="cpu"):
        self.model = model
        self.server = DetectServer(model, INFER, LABEL, canvas_hw=CANVAS,
                                   max_batch=2, batch_window_ms=1.0,
                                   device=device)
        self.httpd = make_http_server(self.server, "127.0.0.1", 0, info)
        self.port = self.httpd.server_address[1]
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=serve_forever, args=(self.httpd, self.stop, 0.05),
            daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.stop.set()
        self.thread.join(10)
        self.server.close()
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def det_front():
    front = _Front(_model(), info={"canvas": list(CANVAS), "max_batch": 2})
    yield front
    front.close()


def test_detect_responses_equal_direct_detect(det_front):
    for seed in range(4):
        rgb = _scene(seed)
        status, resp = det_front.request("POST", "/detect", _png(rgb))
        assert status == 200
        assert resp == _want(det_front.model, rgb) and resp["n"] > 0
        assert set(resp) == {"n", "boxes", "scores"}


def test_healthz_counts_requests(det_front):
    before = det_front.request("GET", "/healthz")[1]
    for seed in range(2):
        assert det_front.request("POST", "/detect",
                                 _png(_scene(10 + seed)))[0] == 200
    status, health = det_front.request("GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["canvas"] == list(CANVAS) and health["max_batch"] == 2
    assert health["requests"] == before["requests"] + 2
    assert health["device_calls"] == before["device_calls"] + 2


def test_error_statuses(det_front):
    conn = http.client.HTTPConnection("127.0.0.1", det_front.port, timeout=10)
    conn.putrequest("POST", "/detect")
    conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
    conn.endheaders()                   # refused before any body byte
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 413 and "too large" in body["error"]
    status, body = det_front.request("POST", "/detect", b"garbage bytes")
    assert status == 400 and body["error"] == "could not decode image"
    assert det_front.request("GET", "/nowhere")[0] == 404
    assert det_front.request("POST", "/elsewhere", b"x")[0] == 404


def test_without_cv2(det_front):
    """Without cv2 a PNG body is decoded by the port and answered alike; a
    JPEG body, and a PNG larger than the canvas, get 400 naming cv2."""
    rgb = _scene(20)
    jpeg = cv2.imencode(".jpg", rgb)[1].tobytes()
    big = _png(_scene(21, h=120, w=160))
    with mock.patch.dict(sys.modules, {"cv2": None}):
        status, resp = det_front.request("POST", "/detect", _png(rgb))
        assert status == 200 and resp == _want(det_front.model, rgb)
        for body, what in ((jpeg, "JPEG"), (big, "downscaling")):
            status, resp = det_front.request("POST", "/detect", body)
            assert status == 400, what
            assert what in resp["error"] and "cv2" in resp["error"]


def test_landmark_model_returns_points():
    model = _model(num_lm=4, seed=1)
    front = _Front(model)
    try:
        for seed in range(2):
            rgb = _scene(30 + seed)
            status, resp = front.request("POST", "/detect", _png(rgb))
            assert status == 200 and resp == _want(model, rgb)
            assert len(resp["lm_points"]) == resp["n"] > 0
            assert all(len(p) == 4 for p in resp["lm_valid"])
    finally:
        front.close()


def test_server_error_is_500():
    front = _Front(_model())
    try:
        def fail(images):
            raise ValueError("device lost")

        front.server._detect = fail
        status, resp = front.request("POST", "/detect", _png(_scene(0)))
        assert status == 500 and "device lost" in resp["error"]
    finally:
        front.close()


def test_serve_forever_stops_on_its_event_and_closes():
    server = DetectServer(_model(), INFER, LABEL, canvas_hw=CANVAS,
                          max_batch=2, warmup=False, device="cpu")
    httpd = make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    stop = threading.Event()
    t = threading.Thread(target=serve_forever, args=(httpd, stop, 0.05))
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.load(r)["status"] == "ok"
        stop.set()
        t.join(5)
        assert not t.is_alive()
        assert httpd.socket.fileno() == -1          # closed
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=2)
    finally:
        stop.set()
        server.close()


def test_cli_serve_subprocess(tmp_path):
    """``python -m densebox_tpu_torch.cli serve --device cpu`` on a workdir
    written by ``train``: /healthz, a PNG round trip equal to a direct
    detect of the loaded checkpoint, 413 and 400; SIGINT ends it with rc 0.
    Without --device (and without a card) it exits non-zero."""
    from densebox_tpu_torch.cli import main
    from densebox_tpu_torch.train import load_for_inference

    work = str(tmp_path / "run")
    assert main(["train", "--synthetic", "--workdir", work, "--steps", "1",
                 "--batch-size", "2", "--width-mult", "0.125",
                 "--patch-size", "64", "--std-height", "20",
                 "--max-boxes", "2", "--device", "cpu"]) == 0
    env = dict(os.environ, PYTHONPATH=REPO)
    flags = ["serve", "--workdir", work, "--canvas", *map(str, CANVAS),
             "--max-batch", "2", "--scales", "1.0", "--thresh=-1e9",
             "--max-dets", "6", "--topk-per-scale", "32", "--port", "0"]
    if not torch.cuda.is_available():
        res = subprocess.run([sys.executable, "-m", "densebox_tpu_torch.cli",
                              *flags], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0 and "CUDA card" in res.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "densebox_tpu_torch.cli", *flags,
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["device"] == "cpu" and health["requests"] == 0
        rgb = _scene(40)
        conn.request("POST", "/detect", body=_png(rgb))
        resp = json.loads(conn.getresponse().read())
        conn.request("POST", "/detect", body=b"garbage")
        r400 = conn.getresponse()
        r400.read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        r413 = conn.getresponse()
        r413.read()
        conn.close()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()
        proc.stderr.close()
    assert (r400.status, r413.status, rc) == (400, 413, 0)
    cfg, sd = load_for_inference(os.path.join(work, "ckpt"), "cpu")
    model = DenseBox(cfg.model, device="cpu")
    model.load_state_dict(sd)
    infer = dataclasses.replace(cfg.infer, scales=(1.0,), score_thresh=-1e9,
                                max_dets=6, topk_per_scale=32)
    assert resp == _want(model.eval(), rgb, infer) and resp["n"] > 0
