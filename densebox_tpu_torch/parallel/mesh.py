"""Data and tensor parallelism over ``torch.distributed`` (port of
``densebox_tpu/parallel/mesh.py``).

One process per device. A ``Mesh`` arranges the ranks of the default
process group as a (``data``, ``model``) grid with ``data`` outermost, as
the JAX mesh does (rank = data_index * n_model + model_index), and holds
this rank's two sub-groups: the ranks of its model index (over which it
splits the batch) and the ranks of its data index (over which it splits
the heads' conv1 channels).

The invariant (``docs/DESIGN.md`` §3): a data-parallel (or DP x TP) step
equals the single-device step on the same global batch. Two things are
designed for it:

* the loss's normalisers are batch-wide counts (sampled pixels,
  positives, landmark positives and negatives): the ranks sum those counts
  before dividing, each rank's loss is its numerator over the global
  count, and the gradients are **summed** over the data ranks, not
  averaged. The clip's and the update's global norms then see the global
  gradient, so every rank takes the same update;
* every rank reseeds from ``step_seed(seed, salt, step)``, draws the
  global batch's patch offsets, dropout mask and OHEM uniforms, and keeps
  its own rows (and, under TP, its own channels of the mask).

Tensor parallelism shards every head's ``_conv1`` on its output channels
over ``model`` (the JAX rule matches any ``*_conv1``, the refine branch's
3x3 ``refine_conv1`` included; here that conv stays replicated): each rank
computes its slice of every head's hidden channels, the hidden tensor is
gathered exactly before the block-diagonal conv2 and its gradient split
again; the replicated ``feat`` sums its gradient over ``model``. The
sharded parameters' gradients are summed over ``data`` only, as are the
replicated ones (identical over ``model`` by then).

Every collective is an ``all_reduce`` or a ``broadcast``: a gather is the
sum of a zero-filled buffer that each rank fills with its own part. These
two are what gloo carries for CUDA tensors, so the same code runs two
ranks on one card over gloo (NCCL refuses two ranks on one device) and one
rank per card over NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from densebox_tpu_torch.config import DenseBoxConfig
from densebox_tpu_torch.models.densebox import DenseBox
from densebox_tpu_torch.train.loop import (TrainState, build_train_step,
                                           global_norm)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data: dist.ProcessGroup     # the ranks that split the batch with this one
    model: dist.ProcessGroup    # the ranks that split the heads with this one

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over every rank of the default process group
    (``parallel/multihost.py:ensure_distributed`` or
    ``init_process_group``), data outermost. Every rank must call it, with
    the same arguments: it creates the sub-groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "ensure_distributed() or init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"make_mesh: {world} ranks do not split into "
                             f"model groups of {n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, data_groups[m], model_groups[d])


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in place where its dtype travels as it
    is; half-precision tensors travel as float32 (exact for the zero-filled
    gathers they are used in)."""
    if t.dtype in (torch.float16, torch.bfloat16):
        buf = t.float()
        dist.all_reduce(buf, group=group)
        return buf.to(t.dtype)
    dist.all_reduce(t, group=group)
    return t


def shard_batch(batch: Mapping[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (its data index's block of
    ``B / n_data``). Raises ``ValueError`` when the batch does not split
    evenly over the data ranks."""
    b = next(iter(batch.values())).shape[0]
    if b % mesh.n_data:
        raise ValueError(f"global batch {b} is not divisible by the "
                         f"{mesh.n_data} data ranks")
    n = b // mesh.n_data
    lo = mesh.data_index * n
    return {k: v[lo:lo + n] for k, v in batch.items()}


def _is_head_conv1(model: DenseBox, name: str) -> bool:
    parts = name.split(".")
    return (len(parts) == 3 and parts[1] == f"{parts[0]}_conv1"
            and parts[0] in dict(model.head_spec))


def param_shardings(model: DenseBox, mesh: Mesh,
                    tensor_parallel: bool = False) -> Dict[str, Optional[int]]:
    """Parameter name -> the dimension sharded over ``model`` (0, the
    output channels, for every head's ``_conv1`` weight and bias under
    tensor parallelism on more than one model rank), or None: replicated."""
    tp = tensor_parallel and mesh.n_model > 1
    return {name: 0 if tp and _is_head_conv1(model, name) else None
            for name, _ in model.named_parameters()}


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model ranks:
    each holds the part its conv1 channels send to the replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.clone(memory_format=torch.contiguous_format),
                    ctx.group), None


class _GatherHidden(torch.autograd.Function):
    """(rows, heads * w) this rank's channels of every head -> (rows,
    heads * w * n) all of them, head by head; backward keeps this rank's
    channels of the gradient (identical on every model rank: each computes
    the same loss from the same gathered tensor)."""

    @staticmethod
    def forward(ctx, y, group, n, index, heads):
        rows, c = y.shape
        ctx.index, ctx.shape = index, (rows, heads, n, c // heads)
        buf = y.new_zeros(ctx.shape)
        buf[:, :, index] = y.reshape(rows, heads, c // heads)
        return _sum(buf, group).reshape(rows, -1)

    @staticmethod
    def backward(ctx, g):
        rows, heads, _, w = ctx.shape
        mine = g.reshape(ctx.shape)[:, :, ctx.index]
        return mine.reshape(rows, heads * w), None, None, None, None


class HeadShards:
    """What ``DenseBox._heads`` calls when its conv1 channels are sharded
    (``DenseBox.head_shards``)."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _SumGradOverModel.apply(x, self.group)

    def gather(self, y: torch.Tensor, heads: int) -> torch.Tensor:
        return _GatherHidden.apply(y, self.group, self.n, self.index, heads)


class _StepShard:
    """The hooks of ``train.loop.build_train_step`` for one rank of a
    mesh (see there)."""

    def __init__(self, mesh: Mesh, model: DenseBox, tensor_parallel: bool):
        self.mesh = mesh
        self.n_data = mesh.n_data
        self.tp = tensor_parallel and mesh.n_model > 1
        self.heads = len(model.head_spec)
        shardings = param_shardings(model, mesh, self.tp)
        self.sharded = [shardings[n] is not None
                        for n, _ in model.named_parameters()]

    def local_draws(self, draws: Dict, b: int) -> Dict:
        lo, hi = self.mesh.data_index * b, (self.mesh.data_index + 1) * b
        out = {k: v[lo:hi] for k, v in draws.items() if k != "patches"}
        if "patches" in draws:
            out["patches"] = {k: v[lo:hi] for k, v in draws["patches"].items()}
        keep = out.get("dropout_keep")
        if keep is not None and self.tp:
            n = self.mesh.n_model
            lead, c = keep.shape[:-1], keep.shape[-1]
            keep = keep.reshape(*lead, self.heads, n, c // (self.heads * n))
            out["dropout_keep"] = keep[..., self.mesh.model_index, :].reshape(
                *lead, c // n)
        return out

    def total(self, counts: torch.Tensor) -> torch.Tensor:
        return _sum(counts, self.mesh.data)

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        flat = _sum(_flatten_dense_tensors(grads), self.mesh.data)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)

    def norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        if not self.tp:
            return global_norm(tensors)
        sq = torch.stack(torch._foreach_norm(tensors)).float() ** 2
        mask = torch.tensor(self.sharded, device=sq.device)
        sharded = _sum(sq[mask].sum(), self.mesh.model)
        return torch.sqrt(sq[~mask].sum() + sharded)

    def sum_metrics(self, metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        names = [k for k in metrics if k.startswith("loss_")]
        summed = _sum(torch.stack([metrics[k] for k in names]),
                      self.mesh.data)
        return {**metrics, **dict(zip(names, summed.unbind()))}


def _broadcast_from_first(tensors: List[torch.Tensor]) -> None:
    flat = _flatten_dense_tensors(tensors)
    dist.broadcast(flat, src=0)
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


def make_sharded_train_step(model: DenseBox, cfg: DenseBoxConfig, mesh: Mesh,
                            state: TrainState, tensor_parallel: bool = False,
                            *, sample_from_canvas: bool = False, device=None):
    """The train step of this rank of ``mesh``: batch split over ``data``;
    with ``tensor_parallel`` the heads' conv1 split over ``model``.

    Returns ``(step, place_state, place_batch)``, as the JAX function does:
    ``place_state(state)`` makes every rank's parameters and momentum those
    of rank 0 (a broadcast) and, under tensor parallelism, keeps this
    rank's channels of each head's conv1 (the model's and the momentum's);
    ``place_batch(batch)`` keeps this rank's rows of a global batch
    (``shard_batch``); ``step(state, batch, draws=None)`` is
    ``train.loop.make_train_step``'s step on those rows, ``draws`` (if
    given) those of the global batch. Metrics are those of the global
    batch. ``sample_from_canvas`` makes it the canvas step
    (``train.trainer.make_canvas_train_step``). ``device``: the model's
    device (the card when none is given)."""
    if state.model is not model:
        raise ValueError("make_sharded_train_step: the state holds another "
                         "model")
    shard = _StepShard(mesh, model, tensor_parallel)
    step = build_train_step(model, cfg, device, sample_from_canvas,
                            shard=shard)

    def place_state(s: TrainState) -> TrainState:
        if dist.get_world_size() > 1:
            with torch.no_grad():
                _broadcast_from_first([p.data for p in model.parameters()]
                                      + list(s.momentum.values()))
        if shard.tp:
            _shard_heads(s, mesh)
        return s

    def place_batch(batch):
        return shard_batch(batch, mesh)

    return step, place_state, place_batch


def _shard_heads(state: TrainState, mesh: Mesh) -> None:
    """Keep this rank's output channels of every head's conv1 (parameters
    and momentum) and hook the gather into the model."""
    model = state.model
    n, r = mesh.n_model, mesh.model_index
    for name, dim in param_shardings(model, mesh, True).items():
        if dim is None:
            continue
        mod, leaf = name.rsplit(".", 1)
        conv = model.get_submodule(mod)
        full = getattr(conv, leaf)
        if full.shape[0] % n:
            raise ValueError(f"{name}: {full.shape[0]} output channels do not "
                             f"split over {n} model ranks")
        w = full.shape[0] // n
        setattr(conv, leaf, nn.Parameter(full.data[r * w:(r + 1) * w].clone()))
        state.momentum[name] = state.momentum[name][r * w:(r + 1) * w].clone()
    model.head_shards = HeadShards(mesh.model, n, r)


def unshard_state(state: TrainState, mesh: Mesh
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, momentum) of the whole model, on every rank: the
    sharded ones gathered over ``model``, the rest as they are. Every rank
    of a model group must call it."""
    model = state.model
    tp = model.head_shards is not None
    sd, mom = {}, {}
    for name, p in model.named_parameters():
        sharded = tp and _is_head_conv1(model, name)
        for out, t in ((sd, p.detach()), (mom, state.momentum[name])):
            if not sharded:
                out[name] = t.clone()
                continue
            w = t.shape[0]
            buf = t.new_zeros((mesh.n_model * w,) + tuple(t.shape[1:]))
            buf[mesh.model_index * w:(mesh.model_index + 1) * w] = t
            out[name] = _sum(buf, mesh.model)
    return sd, mom
