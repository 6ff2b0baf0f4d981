"""The flagship forward and a multi-process dry run (port of
``__graft_entry__.py``).

``entry()``: the flagship DenseBox forward (full-width trunk, 5 landmarks
and the refine branch, bf16 compute, a 640 x 480 image) on the card.
``dryrun_multichip(n)``: one training step over n processes with the
port's real shardings (data x tensor parallel), then the spatially sharded
forward over all n, checked against the local forward.

    python -m densebox_tpu_torch.entry [n]
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from densebox_tpu_torch.config import (DenseBoxConfig, LabelCfg, ModelCfg,
                                       TrainCfg)
from densebox_tpu_torch.device import resolve_device


def entry(device=None):
    """(fn, example_args): the flagship model (random weights from seed 0,
    eval mode) and a zero (1, 480, 640, 3) image, on ``device`` (the card
    when none is given). ``fn(*example_args)`` is its forward."""
    from densebox_tpu_torch.models import DenseBox, init_params

    cfg = ModelCfg(num_landmarks=5, use_refine=True,
                   compute_dtype="bfloat16")
    dev = resolve_device(device)
    model = DenseBox(cfg, device=dev)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    images = torch.zeros((1, 480, 640, 3), device=dev)
    return model.eval(), (images,)


def _dryrun_rank(rank: int, n: int, workdir: str, cuda: bool) -> None:
    """One rank of ``dryrun_multichip``: rank 0 saves what it found."""
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.parallel import (make_mesh,
                                             make_sharded_train_step,
                                             spatial_forward, unshard_state)
    from densebox_tpu_torch.train import create_train_state

    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{workdir}/pg",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        n_model = 2 if n % 2 == 0 and n >= 4 else 1
        n_data = n // n_model
        batch = 2 * n_data              # divisible by the data ranks
        cfg = DenseBoxConfig(
            model=ModelCfg(num_landmarks=4, use_refine=True,
                           width_mult=0.125),
            label=LabelCfg(patch_size=64, std_height_px=20.0),
            train=TrainCfg(batch_size=batch, max_boxes=3))
        b = synthetic_batch(torch.Generator(device=dev).manual_seed(0),
                            batch, cfg.label, max_boxes=3, num_landmarks=4,
                            device=dev)
        model = DenseBox(cfg.model, device=dev)
        state = create_train_state(model, cfg, device=dev)
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        step, place_state, place_batch = make_sharded_train_step(
            model, cfg, mesh, state, tensor_parallel=n_model > 1, device=dev)
        state, metrics = step(place_state(state), place_batch(b))
        loss = float(metrics["loss_total"])
        if not math.isfinite(loss) or state.step != 1:
            raise RuntimeError(f"dryrun: loss {loss}, step {state.step}")

        # the spatial (halo) forward over all n ranks, with the trained
        # parameters, against the same model run whole on this rank
        params, _ = unshard_state(state, mesh)
        whole = DenseBox(cfg.model, device=dev)
        whole.load_state_dict(params)
        xs = torch.rand((1, cfg.model.min_divisor * n, 64, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        got = spatial_forward(whole, xs)
        with torch.no_grad():
            want = whole(xs)
        err = max(float((got[k] - want[k]).abs().max()) for k in want)
        if not err < 1e-3:
            raise RuntimeError(f"spatial sharding diverged: {err}")
        if rank == 0:
            torch.save({"mesh": mesh.shape, "batch": batch, "loss": loss,
                        "spatial_err": err, "backend": dist.get_backend()},
                       os.path.join(workdir, "result.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> dict:
    """One data x tensor parallel train step over ``n_devices`` processes
    (a ('data', 'model') mesh of n/2 x 2 when n >= 4 is even, else n x 1;
    tiny shapes: width 0.125, 64 px patches, 4 landmarks and refine, a
    batch of 2 per data rank): loss finite, one step taken. Then the
    spatial forward over all n against the local forward (error < 1e-3).
    One process per card over NCCL where there are ``n_devices`` cards,
    else CPU processes over gloo. Prints the JAX entry's line and returns
    what it reports."""
    from densebox_tpu_torch.parallel.multihost import run_processes

    cuda = torch.cuda.is_available() and \
        torch.cuda.device_count() >= n_devices
    with tempfile.TemporaryDirectory() as workdir:
        run_processes(_dryrun_rank, n_devices, (n_devices, workdir, cuda),
                      timeout=timeout)
        res = torch.load(os.path.join(workdir, "result.pt"))
    print(f"dryrun_multichip ok: mesh={res['mesh']} batch={res['batch']} "
          f"loss={res['loss']:.4f} spatial_err={res['spatial_err']:.2e}",
          flush=True)
    return res


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        print({k: tuple(v.shape) for k, v in fn(*args).items()})
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else max(torch.cuda.device_count(), 1))
