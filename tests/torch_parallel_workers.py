"""What each spawned rank of ``test_torch_parallel.py`` and
``test_torch_spatial.py`` runs: the port's multi-device paths over a gloo
group on the CPU. Imports torch and the port only (no jax), so a spawned
process starts quickly; results go to ``torch.save`` files the test reads.
"""

from __future__ import annotations

import io
import os
from contextlib import redirect_stdout
from datetime import timedelta
from unittest import mock

import torch
import torch.distributed as dist

from densebox_tpu_torch.config import (DenseBoxConfig, LabelCfg, ModelCfg,
                                       TrainCfg)
from densebox_tpu_torch.data import synthetic_batch
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import DenseBox
from densebox_tpu_torch.parallel import (SpatialDenseBox, make_mesh,
                                         make_sharded_train_step,
                                         spatial_forward, unshard_state)
from densebox_tpu_torch.train import create_train_state, fit, trainer


def tiny_cfg(landmarks=0, refine=False, batch=4, dropout=0.5, **train):
    """Width 0.125, 64 px patches (16 x 16 maps), K = 3 box slots."""
    label = LabelCfg(patch_size=64, std_height_px=20.0,
                     lm_flip_perm=(1, 0, 3, 2) if landmarks == 4 else None)
    return DenseBoxConfig(
        model=ModelCfg(num_landmarks=landmarks, use_refine=refine,
                       width_mult=0.125, dropout_rate=dropout),
        label=label,
        train=TrainCfg(batch_size=batch, learning_rate=1e-2, max_boxes=3,
                       **train))


def global_batches(cfg, n, canvas=False, seed=0):
    """``n`` global synthetic batches (96 px canvases with ``canvas``)."""
    label = LabelCfg(patch_size=96, std_height_px=20.0) if canvas else cfg.label
    return [synthetic_batch(torch.Generator().manual_seed(seed + i),
                            cfg.train.batch_size, label, max_boxes=3,
                            num_landmarks=cfg.model.num_landmarks,
                            device="cpu")
            for i in range(n)]


def join(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))


def train_rank(rank, world, init, out, cfg, batches, n_model, canvas,
               state_dict=None, momentum=None, draws=None):
    """Steps of ``make_sharded_train_step`` on a (world / n_model) x n_model
    mesh over global ``batches``; saves the whole parameters and momentum
    (``unshard_state``), the metrics and the mesh to ``out/rank<r>.pt``.
    ``state_dict``/``momentum`` replace the seeded initial state;
    ``draws[i]`` are the global draws of step i."""
    join(rank, world, init)
    try:
        mesh = make_mesh(n_model=n_model)
        model = DenseBox(cfg.model, device="cpu")
        state = create_train_state(model, cfg, device="cpu")
        if state_dict is not None:
            state.load(state_dict, momentum, 0)
        step, place_state, place_batch = make_sharded_train_step(
            model, cfg, mesh, state, tensor_parallel=n_model > 1,
            sample_from_canvas=canvas, device="cpu")
        state = place_state(state)
        local = {n: tuple(p.shape) for n, p in model.named_parameters()}
        metrics = []
        for i, b in enumerate(batches):
            state, m = step(state, place_batch(b),
                            draws=draws[i] if draws else None)
            metrics.append({k: float(v) for k, v in m.items()})
        sd, mom = unshard_state(state, mesh)
        torch.save({"sd": sd, "mom": mom, "metrics": metrics,
                    "step": state.step, "mesh": mesh.shape,
                    "local_shapes": local},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def fit_rank(rank, world, init, out, cfg, batches, workdir, steps, tag):
    """``fit(use_mesh=True)`` on a step-keyed stream of this rank's rows of
    ``batches`` (global; the whole batch where it does not divide over the
    ranks), the console captured; saves the final state, the last metrics,
    what was printed and how many checkpoints this rank wrote to
    ``out/rank<r>_<tag>.pt``."""
    join(rank, world, init)
    try:
        n = trainer.data_parallel_ranks(cfg)
        rows = cfg.train.batch_size // n
        lo = rank * rows if n > 1 else 0

        def fetch(step):
            return {k: v[lo:lo + rows] for k, v in batches[step].items()}

        writes = []
        real = trainer.ckpt_lib.save_checkpoint

        def counting(*args, **kw):
            writes.append(args[1].step)
            return real(*args, **kw)

        buf = io.StringIO()
        with redirect_stdout(buf), mock.patch.object(
                trainer.ckpt_lib, "save_checkpoint", counting):
            res = fit(cfg, fetch, workdir, num_steps=steps,
                      sample_from_canvas=False, device="cpu")
        torch.save({"sd": res.state.model.state_dict(),
                    "mom": res.state.momentum, "last": res.last_metrics,
                    "printed": buf.getvalue(), "step": res.state.step,
                    "writes": writes, "ranks": n},
                   os.path.join(out, f"rank{rank}_{tag}.pt"))
    finally:
        dist.destroy_process_group()


def spatial_rank(rank, world, init, out, cases, detect_cases):
    """``spatial_forward`` of each case (cfg, state dict, images) and
    ``detect_batch`` through ``SpatialDenseBox`` of each detect case (cfg,
    state dict, images, infer cfg, label cfg); a case whose height the ring
    refuses records the error's message."""
    join(rank, world, init)
    try:
        res = {"maps": {}, "dets": {}, "errors": {}}
        for name, (mcfg, sd, images) in cases.items():
            model = DenseBox(mcfg, device="cpu")
            model.load_state_dict(sd)
            try:
                res["maps"][name] = spatial_forward(model, images)
            except ValueError as e:
                res["errors"][name] = str(e)
        for name, (mcfg, sd, images, icfg, lcfg) in detect_cases.items():
            model = DenseBox(mcfg, device="cpu")
            model.load_state_dict(sd)
            with torch.inference_mode():
                res["dets"][name] = detect_batch(SpatialDenseBox(model),
                                                 images, icfg, lcfg)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
