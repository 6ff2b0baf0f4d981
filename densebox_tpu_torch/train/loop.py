"""Training step and state (port of ``densebox_tpu/train/loop.py``).

One ``train_step(state, batch)`` does GT rasterization, the train-mode
forward, the OHEM loss, backward and the SGD update on the device; the batch
carries raw patch pixels and padded box tensors only. A step's random draws
(patch crops, dropout mask, OHEM uniforms) depend only on the state's seed
and salt and on the step count (``step_seed``): the step reseeds the state's
generator at its top, as the JAX package folds the step into its key. So
the same step from the same parameters and momentum gives the same result
bit for bit, on the card too (``repeatable_kernels``), and a run resumed
from a checkpoint continues as the uninterrupted run would have. The whole
step, backward included, runs at the reference's precision
(``device.reference_precision``: no TF32 under a float32 model).

Optimizer, as the JAX package chains it: clip the gradients by their global
norm, add ``weight_decay * p``, SGD momentum trace ``t = g + momentum * t``,
update ``-lr * t`` with the staircase schedule ``lr = learning_rate *
lr_decay_rate ** floor(step / lr_decay_steps)``. The clip leaves gradients
untouched when their norm is below ``grad_clip_norm`` and otherwise computes
``(g / norm) * grad_clip_norm`` (no epsilon in the denominator), which is
not what ``torch.nn.utils.clip_grad_norm_`` computes, so it is written out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from densebox_tpu_torch.config import DenseBoxConfig
from densebox_tpu_torch.data.patches import patch_draws, sample_patches
from densebox_tpu_torch.device import reference_precision, resolve_device
from densebox_tpu_torch.models.convert import init_params
from densebox_tpu_torch.models.densebox import DenseBox, dropout_keep_mask
from densebox_tpu_torch.ops.labels import rasterize
from densebox_tpu_torch.ops.ohem import densebox_loss

STEP_DRAWS = ("patches", "dropout_keep", "ohem_score", "ohem_refined")


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates in place: the model (its parameters),
    the SGD momentum trace per parameter name, the number of steps taken,
    the generator of the per-step random draws (on the model's device;
    reseeded by every step) and the ``seed`` and ``salt`` it is reseeded
    from (``salt`` is 0 until a retry asks for other draws,
    ``train.trainer.fit(run_salt=...)``)."""

    step: int
    model: DenseBox
    momentum: Dict[str, torch.Tensor]
    generator: torch.Generator
    seed: int = 0
    salt: int = 0

    def load(self, state_dict: Mapping[str, torch.Tensor],
             momentum: Mapping[str, torch.Tensor], step: int) -> None:
        """Take parameters, momentum trace and step count from elsewhere
        (``models.convert.state_from_jax`` gives them from a JAX state)."""
        self.model.load_state_dict(state_dict)
        if set(momentum) != set(self.momentum):
            raise ValueError(
                f"momentum names differ from the model's parameters: "
                f"{sorted(set(momentum) ^ set(self.momentum))}")
        with torch.no_grad():
            for k, buf in self.momentum.items():
                buf.copy_(momentum[k])
        self.step = int(step)


_MASK64 = (1 << 64) - 1


def mix_seed(*values: int) -> int:
    """A fixed 63-bit mix of a few integers (splitmix64's finalizer over a
    running sum), the seed a ``torch.Generator`` takes."""
    x = 0
    for v in values:
        x = (x + (v & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def step_seed(seed: int, salt: int, step: int) -> int:
    """The seed of step ``step``'s draws: nothing but these three enter."""
    return mix_seed(seed, salt, step)


# steps inside ``repeatable_kernels`` right now, and the flag's value before
# the first of them came in
_pin_lock = threading.Lock()
_pin_depth = 0
_pin_saved = False


@contextlib.contextmanager
def repeatable_kernels():
    """Within it cuDNN takes only algorithms whose result does not depend on
    the run: some of its backward-filter and backward-data algorithms split
    a sum over blocks and add the parts with atomics, in the order the
    blocks happen to finish. Everything else a step runs (the GEMMs, the
    max-pool and upsample backward, the reductions of the loss and of the
    norms, the kernels of ``csrc/``) sums in a fixed order already.

    The flag is the process's: the first step to come in saves and sets it,
    the last one out puts it back, so steps in several threads leave it as
    they found it. Other cuDNN work of the process (a ``DetectServer``
    beside the trainer) runs with the pinned algorithms while a step is
    inside."""
    global _pin_depth, _pin_saved
    with _pin_lock:
        if _pin_depth == 0:
            _pin_saved = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
        _pin_depth += 1
    try:
        yield
    finally:
        with _pin_lock:
            _pin_depth -= 1
            if _pin_depth == 0:
                torch.backends.cudnn.deterministic = _pin_saved


def learning_rate(cfg: DenseBoxConfig, step: int) -> float:
    """The staircase schedule at ``step`` updates taken so far."""
    t = cfg.train
    return t.learning_rate * t.lr_decay_rate ** (step // t.lr_decay_steps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, a float32 scalar."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)).float())


@torch.no_grad()
def sgd_update(params: List[torch.Tensor], grads: List[torch.Tensor],
               momentum: List[torch.Tensor], cfg: DenseBoxConfig, step: int,
               norm: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm
               ) -> torch.Tensor:
    """Apply one optimizer step to ``params`` and ``momentum`` in place
    (see the module docstring for the chain). Returns the global norm of the
    updates. No host synchronisation: the clip is a select on the device.
    ``norm`` is the global norm of a list of tensors aligned with
    ``params`` (a tensor-parallel step sums the squares of its sharded
    parameters over the model ranks)."""
    t = cfg.train
    if t.grad_clip_norm > 0:
        norm_g = norm(grads)
        below = norm_g < t.grad_clip_norm
        clipped = torch._foreach_div(grads, norm_g)
        torch._foreach_mul_(clipped, t.grad_clip_norm)
        grads = [torch.where(below, g, c) for g, c in zip(grads, clipped)]
    grads = torch._foreach_add(grads, params, alpha=t.weight_decay)
    torch._foreach_mul_(momentum, t.momentum)
    torch._foreach_add_(momentum, grads)
    updates = torch._foreach_mul(momentum, -learning_rate(cfg, step))
    torch._foreach_add_(params, updates)
    return norm(updates)


def create_train_state(model: DenseBox, cfg: DenseBoxConfig, device=None
                       ) -> TrainState:
    """Move ``model`` to ``device`` (the card when none is given), give it
    fresh He-normal weights from ``cfg.train.seed`` and zero momentum, and
    make the generator of the per-step draws on that device (seeded from
    ``cfg.train.seed`` and the step count by each step)."""
    dev = resolve_device(device)
    model.to(dev)
    model.load_state_dict(init_params(
        cfg.model, torch.Generator().manual_seed(cfg.train.seed)))
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    return TrainState(step=0, model=model, momentum=momentum,
                      generator=torch.Generator(device=dev),
                      seed=cfg.train.seed)


def step_draws(gen: torch.Generator, model: DenseBox, cfg: DenseBoxConfig,
               b: int, k: int, device, sample_from_canvas: bool,
               given: Mapping) -> Dict:
    """Every random draw of one step for a batch of ``b`` rows with ``k``
    box slots, each from ``given`` (the step's ``draws`` argument) or else
    from ``gen``, always in this order: the patch draws (canvas steps), the
    dropout keep mask of the heads' hidden tensor, the OHEM uniforms of the
    score term and of the refined term."""
    out = {}
    if sample_from_canvas:
        out["patches"] = patch_draws(gen, b, k, cfg.label, device,
                                     given=given.get("patches"))
    m = cfg.label.map_size
    if "dropout_keep" in given:
        out["dropout_keep"] = given["dropout_keep"].to(device)
    elif cfg.model.dropout_rate > 0.0:
        hidden = (b, m, m, len(model.head_spec)
                  * cfg.model.scaled(cfg.model.head_width))
        out["dropout_keep"] = dropout_keep_mask(hidden, cfg.model.dropout_rate,
                                                gen)
    names = ["ohem_score"]
    if cfg.model.num_landmarks and cfg.model.use_refine:
        names.append("ohem_refined")
    for name in names:
        out[name] = (given[name].to(device) if name in given else
                     torch.rand((b, m * m), device=device, generator=gen))
    return out


def build_train_step(model: DenseBox, cfg: DenseBoxConfig, device,
                     sample_from_canvas: bool, shard=None) -> Callable:
    """The step behind ``make_train_step`` and
    ``train.trainer.make_canvas_train_step`` (which see): with
    ``sample_from_canvas`` the batch is first cropped to patches on the
    device.

    ``shard`` makes it the step of one rank of a data- (and tensor-)
    parallel mesh (``parallel/mesh.py:make_sharded_train_step``): the batch
    holds this rank's rows of a global batch of ``shard.n_data`` times as
    many; the draws are made for the global batch and ``shard.local_draws``
    keeps this rank's share; ``shard.total`` sums the loss's counts over the
    data ranks, ``shard.reduce_grads`` the gradients, ``shard.norm`` is the
    global norm of the update and ``shard.sum_metrics`` makes the loss
    terms global."""
    dev = resolve_device(device)
    crop = cfg.train.crop_dtype
    if crop == "auto":
        crop = cfg.model.compute_dtype
    crop_dtype = torch.bfloat16 if crop == "bfloat16" else None

    @reference_precision(cfg.model.compute_dtype)
    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   draws: Optional[Mapping] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("train_step: the state holds another model "
                             "than the step was made for")
        if any(p.device.type != dev.type for p in model.parameters()):
            raise ValueError(f"train_step: the model is not on {dev}")
        draws = {} if draws is None else draws
        unknown = set(draws) - set(STEP_DRAWS)
        if unknown:
            raise ValueError(f"train_step: unknown draws {sorted(unknown)}")
        gen = state.generator.manual_seed(
            step_seed(state.seed, state.salt, state.step))
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        b, k = batch["boxes"].shape[:2]
        with torch.no_grad():
            draws = step_draws(gen, model, cfg,
                               b * shard.n_data if shard else b, k, dev,
                               sample_from_canvas, draws)
            if shard is not None:
                draws = shard.local_draws(draws, b)
            if sample_from_canvas:
                batch = sample_patches(
                    None, batch["image"], batch["boxes"], batch["box_valid"],
                    cfg.label, landmarks=batch.get("landmarks"),
                    lm_valid=batch.get("lm_valid"), crop_dtype=crop_dtype,
                    draws=draws["patches"])
            gts = rasterize(batch["boxes"], batch["box_valid"], cfg.label,
                            batch.get("landmarks"), batch.get("lm_valid"))

        model.zero_grad(set_to_none=True)
        with repeatable_kernels():
            out = model(batch["image"], train=True,
                        dropout_keep=draws.get("dropout_keep"))
            loss, metrics = densebox_loss(
                out, gts, draws["ohem_score"], cfg.loss,
                draws.get("ohem_refined"),
                total=shard.total if shard else None)
            loss.backward()
        names, params = zip(*model.named_parameters())
        grads = [p.grad for p in params]
        if shard is not None:
            shard.reduce_grads(grads)
        metrics["update_norm"] = sgd_update(
            list(params), grads, [state.momentum[k] for k in names], cfg,
            state.step, norm=shard.norm if shard else global_norm)
        if shard is not None:
            metrics = shard.sum_metrics(metrics)
        state.step += 1
        return state, metrics

    return train_step


def make_train_step(model: DenseBox, cfg: DenseBoxConfig, device=None
                    ) -> Callable:
    """Returns ``train_step(state, batch, draws=None) -> (state, metrics)``
    for ``model`` on ``device`` (the card when none is given; raises without
    one). The state is updated in place and returned; metrics are 0-dim
    tensors on the device (``loss_total``, ``loss_cls``, ``loss_loc``
    [, ``loss_lm``, ``loss_refined``], ``n_pos``, ``n_sampled`` and
    ``update_norm``, the global norm of the parameter updates).

    batch (moved to the device if it is not there):
      image:     (B, P, P, 3) float patches
      boxes:     (B, K, 4) xyxy patch coords (padded)
      box_valid: (B, K) bool
      landmarks: (B, K, L, 2), lm_valid: (B, K, L)   [optional]

    Every random draw of a step comes from ``state.generator``, reseeded
    from ``step_seed(state.seed, state.salt, state.step)``, unless ``draws``
    gives it: ``dropout_keep`` (the bool keep mask of the heads'
    hidden tensor, (B, M, M, heads * width)), ``ohem_score`` and
    ``ohem_refined`` ((B, M*M) uniforms of the two OHEM terms)."""
    return build_train_step(model, cfg, device, sample_from_canvas=False)
