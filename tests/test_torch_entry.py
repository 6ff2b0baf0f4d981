"""The port's entry points (``densebox_tpu_torch/entry.py``, the
counterpart of ``__graft_entry__.py``) and the command line's
data-parallel training under torchrun, on the CPU over gloo."""

import os
import subprocess
import sys

import pytest
import torch

from densebox_tpu_torch.entry import dryrun_multichip, entry
import torch_threads  # noqa: F401  (sets torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,mesh,batch", [(2, {"data": 2, "model": 1}, 4),
                                          (4, {"data": 2, "model": 2}, 4)])
def test_dryrun_multichip_prints_the_ok_line(capsys, n, mesh, batch):
    res = dryrun_multichip(n, timeout=120)
    out = capsys.readouterr().out
    assert f"dryrun_multichip ok: mesh={mesh} batch={batch} loss=" in out
    assert res["mesh"] == mesh and res["backend"] == "gloo"
    assert torch.isfinite(torch.tensor(res["loss"]))
    assert res["spatial_err"] < 1e-3


def test_entry_is_the_flagship_forward_on_the_card():
    fn, (images,) = entry(device="cpu")
    assert images.shape == (1, 480, 640, 3)
    assert fn.cfg.num_landmarks == 5 and fn.cfg.use_refine
    assert fn.cfg.compute_dtype == "bfloat16" and fn.cfg.width_mult == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            entry()


def test_cli_train_under_torchrun_two_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m densebox_tpu_torch.cli train
    --device cpu``: rank 0 alone prints and writes one checkpoint."""
    work = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "densebox_tpu_torch.cli", "train",
         "--synthetic", "--device", "cpu", "--width-mult", "0.125",
         "--patch-size", "64", "--std-height", "20", "--batch-size", "4",
         "--steps", "2", "--ckpt-every", "2", "--workdir", str(work)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("done at step 2") == 1, res.stdout
    assert res.stdout.count("[train step 2]") == 1
    assert "DP mesh disabled" not in res.stdout
    assert sorted(os.listdir(work / "ckpt")) == ["step_00000002.pt"]
