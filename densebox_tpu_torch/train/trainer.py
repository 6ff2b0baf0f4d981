"""Training loop (port of ``densebox_tpu/train/trainer.py``).

One step = on-device patch sampling + GT rasterization + forward + OHEM loss
+ backward + SGD (``train/loop.py``). ``fit`` adds the loop around it:
checkpoints with exact resume, metric logging, and the divergence check,
on one device or data-parallel over the ranks of a process group
(``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Mapping, Optional

import torch.distributed as dist

from densebox_tpu_torch.config import DenseBoxConfig
from densebox_tpu_torch.device import resolve_device
from densebox_tpu_torch.models.densebox import DenseBox
from densebox_tpu_torch.parallel import mesh as mesh_lib
from densebox_tpu_torch.parallel.multihost import is_primary, world_size
from densebox_tpu_torch.train import checkpoint as ckpt_lib
from densebox_tpu_torch.train.loop import (TrainState, build_train_step,
                                           create_train_state, mix_seed)
from densebox_tpu_torch.utils.logging import MetricsLogger


def make_canvas_train_step(model: DenseBox, cfg: DenseBoxConfig,
                           sample_from_canvas: bool = True, device=None
                           ) -> Callable:
    """As ``train.loop.make_train_step``, for batches of raw canvases (full
    images and boxes in canvas coordinates): each step first samples
    ``cfg.label.patch_size`` patches on the device
    (``data.patches.sample_patches``, interpolating in
    ``cfg.train.crop_dtype``), flips included. ``draws["patches"]`` gives
    that function's draws. With ``sample_from_canvas=False`` the batch is
    taken as pre-cropped patches."""
    return build_train_step(model, cfg, device, sample_from_canvas)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    last_metrics: Dict[str, float]


class TrainingDiverged(RuntimeError):
    """Raised when the loss or the update norm goes non-finite. The trainer
    checks the fetched values at every log and checkpoint boundary and
    refuses to checkpoint a poisoned state, so a retry resumes from the last
    finite checkpoint."""


def data_parallel_ranks(cfg: DenseBoxConfig, use_mesh: bool = True) -> int:
    """How many ranks ``fit`` splits each global batch of
    ``cfg.train.batch_size`` over: every rank of the process group when
    there is more than one and the batch divides over them, else 1."""
    world = world_size()
    if use_mesh and world > 1 and cfg.train.batch_size % world == 0:
        return world
    return 1


def fit(
    cfg: DenseBoxConfig,
    batches,
    workdir: Optional[str] = None,
    *,
    num_steps: Optional[int] = None,
    sample_from_canvas: bool = True,
    use_mesh: bool = True,
    resume: bool = True,
    init_state: Optional[TrainState] = None,
    run_salt: int = 0,
    draws: Optional[Callable[[int], Mapping]] = None,
    device=None,
) -> FitResult:
    """Run the training loop on ``device`` (the card when none is given;
    raises without one).

    ``batches`` is either an iterator of batch dicts, or a callable
    ``step -> batch`` (step-keyed streams make resume bit-exact, since the
    data consumed at step N is identical across interrupted and
    uninterrupted runs; after a resume at step s the next batch fetched is
    ``batches(s)``). With ``workdir`` the newest ``cfg.train.ckpt_keep``
    checkpoints are kept under ``workdir/ckpt`` (every
    ``cfg.train.ckpt_every`` steps and at the last one), metrics are logged
    every ``cfg.train.log_every`` steps (TensorBoard files under
    ``workdir/tb`` where a writer is installed), and with ``resume`` the
    run continues from the latest checkpoint there.

    The loop reads the device only at those boundaries: there the loss and
    the update norm are fetched, and a non-finite value of either raises
    ``TrainingDiverged`` before any checkpoint is written.

    ``run_salt`` (nonzero on a retry after a divergence) is mixed into the
    state's salt after the restore, so the retry draws fresh patch, dropout
    and OHEM randomness instead of replaying a deterministic divergence bit
    for bit. Salted resumes are intentionally NOT bit-exact against an
    uninterrupted run.

    ``draws(step)`` gives the step's random draws (the ``draws`` argument
    of the step, ``train.loop.make_train_step``; those of the global batch)
    in place of the state's generator. It exists for parity tests, which
    feed the draws of the JAX package's run; training leaves it None.

    Data parallelism (``use_mesh``) engages when the default process group
    has more than one rank and the global batch ``cfg.train.batch_size``
    divides over them (``data_parallel_ranks``): each rank's ``batches``
    then hold its own ``batch_size / ranks`` rows of every global batch (as
    ``PrefetchLoader(num_shards=, shard_index=)`` or ``parallel.shard_batch``
    give them), and every step is ``parallel.make_sharded_train_step``'s,
    which equals the single-device step on the global batch. When the batch
    does not divide, the primary says so and every rank trains on the whole
    batch it is given. Either way rank 0 alone writes checkpoints (the
    others wait for it) and logs; every rank restores the same file; the
    checked loss is the global one, so a divergence raises on every rank.
    """
    dev = resolve_device(device)
    num_steps = num_steps or cfg.train.num_steps
    fetch = batches if callable(batches) else (lambda _step: next(batches))
    primary, world = is_primary(), world_size()
    n_data = data_parallel_ranks(cfg, use_mesh)
    if use_mesh and world > 1 and n_data == 1 and primary:
        print(f"DP mesh disabled: global batch {cfg.train.batch_size} not "
              f"divisible by {world} ranks; every rank trains on the whole "
              f"batch", flush=True)

    first = fetch(0)
    if n_data > 1 and first["image"].shape[0] * n_data != cfg.train.batch_size:
        raise ValueError(f"fit: a rank's batch has {first['image'].shape[0]} "
                         f"rows; {n_data} ranks split a global batch of "
                         f"{cfg.train.batch_size} into "
                         f"{cfg.train.batch_size // n_data}")
    state = init_state or create_train_state(
        DenseBox(cfg.model, device=dev), cfg, device=dev)

    mngr = logger = None
    if workdir:
        mngr = ckpt_lib.make_manager(os.path.join(workdir, "ckpt"),
                                     cfg.train.ckpt_keep)
        logger = MetricsLogger(os.path.join(workdir, "tb")) if primary \
            else None
        if resume and ckpt_lib.restore_checkpoint(mngr, state, dev) \
                and primary:
            print(f"resumed from step {state.step}", flush=True)
    if world > 1:       # nobody writes before every rank has read
        dist.barrier()
    if run_salt:
        state.salt = mix_seed(state.salt, run_salt)

    if n_data > 1:
        mesh = mesh_lib.make_mesh(n_data=n_data)
        step_fn, place_state, _ = mesh_lib.make_sharded_train_step(
            state.model, cfg, mesh, state,
            sample_from_canvas=sample_from_canvas, device=dev)
        state = place_state(state)
    else:
        step_fn = make_canvas_train_step(state.model, cfg, sample_from_canvas,
                                         device=dev)

    last: Dict[str, float] = {}
    # the step count lives on the host (state.step is a Python int), and
    # the metrics stay on the device until a boundary fetches them
    step = state.step
    batch = first if step == 0 else fetch(step)
    while step < num_steps:
        state, metrics = step_fn(state, batch,
                                 draws=draws(step) if draws else None)
        step += 1
        log_now = step % cfg.train.log_every == 0 or step == num_steps
        save_now = step % cfg.train.ckpt_every == 0 or step == num_steps
        if log_now or save_now:
            loss = float(metrics["loss_total"])
            upd = float(metrics.get("update_norm", 0.0))
            if not (math.isfinite(loss) and math.isfinite(upd)):
                raise TrainingDiverged(
                    f"non-finite loss {loss} / update norm {upd} "
                    f"at step {step}")
        if logger and log_now:
            last = logger.log(step, metrics)
        elif step == num_steps:
            last = {k: float(v) for k, v in metrics.items()}
        if mngr and save_now:
            if primary:
                ckpt_lib.save_checkpoint(mngr, state, cfg)
            if world > 1:
                dist.barrier()
        if step < num_steps:
            batch = fetch(step)
    if logger:
        logger.close()
    return FitResult(state=state, last_metrics=last)
