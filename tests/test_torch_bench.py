"""The port's bench (``python -m densebox_tpu_torch.bench``) and serve load
test (``python -m densebox_tpu_torch.loadtest``) on the CPU.

* ``--smoke --device cpu`` prints a last line with the JAX bench's four
  keys, a finite value and ``vs_baseline`` null, in both modes;
* without ``--device`` and without a card it prints exactly one structured
  failure line (``stage`` "device-init", ``value`` null) and exits 1, as
  ``tests/test_bench_harness.py`` asks of the JAX bench;
* a failure while building or timing prints one failure line with
  ``stage`` "run";
* presets, shapes and configs as the JAX bench's;
* the load test's levels with the tiny trained server.

The pipeline's parity with the JAX bench's is
``tests/test_torch_bench_parity.py``.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from densebox_tpu_torch import bench, loadtest
import torch_threads  # noqa: F401  (sets torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _run(*argv):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "densebox_tpu_torch.bench",
                           *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("argv", [[], ["--dtype", "bfloat16"],
                                  ["--mode", "train"]],
                         ids=["infer_int8", "infer_bf16", "train"])
def test_smoke_on_the_cpu_prints_the_line(argv):
    res = _run("--smoke", "--device", "cpu", *argv)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] is None
    info = json.loads(res.stderr.strip().splitlines()[-1])
    assert info["device"] == "cpu" and info["batch"] == 2
    if argv[-1:] == ["train"]:
        assert line["unit"] == "steps/sec" and info["patch"] == 64
        assert np.isfinite(info["loss_total_sum"])
    else:
        assert line["metric"] == bench.INFER_METRIC
        assert info["hw"] == [96, 128] and np.isfinite(info["checksum"])


def test_no_card_prints_one_failure_line():
    res = _run("--smoke")
    assert res.returncode == 1
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["value"] is None and out["stage"] == "device-init"
    assert "CUDA card" in out["error"] and out["device"] == "cuda"


def test_a_run_failure_prints_one_failure_line(capsys):
    with mock.patch.object(bench, "build_infer",
                           side_effect=RuntimeError("out of memory")), \
            pytest.raises(SystemExit) as e:
        bench.main(["--smoke", "--device", "cpu"])
    assert e.value.code == 1
    out = json.loads(capsys.readouterr().out.strip())
    assert out == {"error": "RuntimeError: out of memory", "stage": "run",
                   "device": "cpu", "value": None}


def test_presets_and_flags_follow_the_jax_bench():
    for preset, (stem, depth, wm, batch) in {
            "paper": ("conv", 4, 1.0, 64), "fast": ("s2d", 3, 0.5, 128),
            "turbo": ("s2d4", 3, 0.25, 256)}.items():
        args = bench.parse_args(["--preset", preset])
        hw, b, w, iters, patch = bench.run_shape(args)
        cfg = bench.model_cfg(args, w)
        assert (hw, b, w, iters, patch) == ((480, 640), batch, wm, 8, 240)
        assert (cfg.stem, cfg.trunk_depth, cfg.compute_dtype) == (
            stem, depth, "bfloat16")
        assert not cfg.num_landmarks and not cfg.use_refine
    args = bench.parse_args(["--landmarks", "4", "--dtype", "float32",
                             "--smoke", "--batch", "64"])
    assert bench.run_shape(args) == ((96, 128), 2, 0.125, 2, 64)
    cfg = bench.model_cfg(args, 0.125)
    assert cfg.num_landmarks == 4 and cfg.use_refine
    assert cfg.compute_dtype == "float32"
    icfg = bench.infer_cfg(args)
    assert (icfg.scales, icfg.score_thresh, icfg.topk_per_scale,
            icfg.max_dets) == ((1.0,), 0.5, 256, 128)
    assert args.qbackend == "fused" and args.device is None


def test_loadtest_levels_on_the_cpu(capsys):
    """The tiny trained server (``cli train --synthetic``) at 96 x 128:
    one line a client count, every request answered, one client's requests
    each a device call of its own, four clients coalesced."""
    assert loadtest.main(["--device", "cpu", "--clients", "1", "4",
                          "--requests", "24"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["clients"] for ln in lines] == [1, 4]
    for ln in lines:
        assert ln["requests"] == 24 and ln["device"] == "cpu"
        assert ln["canvas"] == [96, 128] and ln["max_batch"] == 8
        assert np.isfinite([ln["req_per_s"], ln["p50_ms"], ln["p99_ms"]]).all()
        assert ln["p50_ms"] <= ln["p99_ms"]
    assert lines[0]["device_calls"] == 24 and lines[0]["coalescing_ratio"] == 1
    assert lines[1]["coalescing_ratio"] >= 1
    assert lines[1]["device_calls"] <= 24


def test_loadtest_scene_is_the_jax_probes():
    img = loadtest.scene(3, (96, 128))
    rng = np.random.RandomState(3)
    want = (rng.rand(96, 128, 3) * 40).astype(np.float32)
    want[30:52, 40:62] = 230.0
    np.testing.assert_array_equal(img, want / 255.0)
