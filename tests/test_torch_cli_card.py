"""The command line's slice on a CUDA card: the loader's pinned host batches
and their copy to the card, the CLI's subcommands without ``--device``, and
the HTTP front end over a server on the card.

These tests need a CUDA card (marker ``gpu``) and skip without one. This
file imports no jax, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -q tests/test_torch_cli_card.py
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from densebox_tpu_torch import cli
from densebox_tpu_torch.data import kitti, pipeline
from test_torch_http import _Front, _model, _png, _scene, _want

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from chip_smoke import write_png  # noqa: E402
import torch_threads  # noqa: F401,E402  (sets torch's threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _write_dir(root, n=6):
    """A KITTI-format directory of PNG scenes (written without cv2) with one
    Car each."""
    (root / "image_2").mkdir(parents=True)
    (root / "label_2").mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        write_png(str(root / "image_2" / f"{i:06d}.png"), _scene(i, 70, 100))
        x1, y1 = rng.uniform(0, 50, 2)
        (root / "label_2" / f"{i:06d}.txt").write_text(
            f"Car 0.00 0 -1.58 {x1:.2f} {y1:.2f} {x1 + 30:.2f} {y1 + 20:.2f} "
            "1.57 1.73 4.15 1.00 1.75 13.22 -1.62\n")
    return str(root)


@pytest.mark.gpu
@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_loader_batches_reach_the_card_equal(cuda, tmp_path, image_dtype):
    root = _write_dir(tmp_path)
    samples = kitti.load_dataset(os.path.join(root, "image_2"),
                                 os.path.join(root, "label_2"))
    host = pipeline.canvas_batch(samples[:3], (72, 104), 2,
                                 image_dtype=image_dtype, pin_memory=True)
    assert all(v.is_pinned() for v in host.values())
    kw = dict(batch_size=3, canvas_hw=(72, 104), max_boxes=2, seed=3,
              image_dtype=image_dtype)
    on_card = iter(pipeline.PrefetchLoader(samples, **kw))
    on_cpu = iter(pipeline.PrefetchLoader(samples, device="cpu", **kw))
    for _ in range(3):
        a, b = next(on_card), next(on_cpu)
        assert all(v.device.type == "cuda" for v in a.values())
        for k in b:
            assert torch.equal(a[k].cpu(), b[k]), k


@pytest.mark.gpu
def test_cli_runs_on_the_card_by_default(cuda, tmp_path, capsys):
    root = _write_dir(tmp_path / "kitti")
    work = str(tmp_path / "run")
    tiny = ["--width-mult", "0.125", "--patch-size", "64", "--std-height",
            "20", "--max-boxes", "2", "--batch-size", "2"]
    assert cli.main(["train", "--data-dir", root, "--workdir", work,
                     "--steps", "2", "--canvas", "72", "104",
                     "--ckpt-every", "2", "--log-every", "1", *tiny]) == 0
    assert "loader backend" in capsys.readouterr().out
    image = os.path.join(root, "image_2", "000000.png")
    assert cli.main(["detect", "--workdir", work, "--image", image,
                     "--out", str(tmp_path / "d"), "--thresh=-1000",
                     "--max-dets", "3"]) == 0
    assert re.search(r": 3 detections", capsys.readouterr().out)
    assert cli.main(["eval", "--workdir", work, "--data-dir", root,
                     "--canvas", "72", "104", "--batch-size", "2",
                     "--protocol", "kitti"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_gt"] == 6
    q = str(tmp_path / "q")
    assert cli.main(["quantize", "--workdir", work, "--out", q]) == 0
    assert cli.main(["detect", "--workdir", q, "--image", image, "--out",
                     str(tmp_path / "dq"), "--thresh=-1000",
                     "--max-dets", "3"]) == 0


@pytest.mark.gpu
def test_http_front_over_a_server_on_the_card(cuda):
    model = _model()
    front = _Front(model, device=cuda)
    try:
        for seed in range(3):
            rgb = _scene(5 + seed)
            status, resp = front.request("POST", "/detect", _png(rgb))
            assert status == 200 and resp["n"] > 0
            assert resp == _want(model, rgb, device=cuda)
    finally:
        front.close()
