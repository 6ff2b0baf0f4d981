"""Data-parallel training over the cell's cards: one process a card
(``densebox_tpu_torch.parallel.multihost.run_processes``), joined in one
process group (NCCL on cards, gloo on the CPU), each running
``parallel.mesh.make_sharded_train_step(..., sample_from_canvas=True)``
on a data x model mesh of ``chips`` x 1: the canvas step of
``drivers/train.py`` on its rows of a global batch, the gradients summed
over the ranks by one flat all-reduce.

The global batch is the configuration's ``train.batch_size``, split over
the cell's ``chips`` ranks as ``train/trainer.py:fit`` splits it (a rank
takes ``batch_size / chips`` rows). Every rank draws its own rows of the
pool's ``pool_batches`` global batches on its card, each block from a
stream of its own, as a loader reads its shard: no card makes or holds the
whole pool. Set-up spawns the ranks, joins the group, makes the weights,
broadcasts rank 0's state (``place_state``), draws the pool and drives the
first three steps with the draws of the global batch that the benchmark
makes (``drivers/train.py:step_draws`` at the global batch), which the
reference is handed too. The window starts and ends on a barrier with the
cards synchronised; there every step makes its own draws. Every
``check_every`` steps of the mix, rank 0 decides on its clock whether the
window goes on and sends the decision over a gloo group on the host, so
that every rank takes the same steps; between two decisions no rank waits
for another's host, only for the step's own collectives.
``train_images_per_s`` is the global images of the window's steps over its
length on rank 0's clock; ``setup_s`` runs from this process's start to
the window's.

Once every rank has ended, this process holds the program to the
reference, on its card or the CPU: the three steps' losses, the first
gradient and the change after three steps against
``reference/train.py`` on the global batch (the port's invariant: the
data-parallel step equals the single-device step on the same global
batch), and ``rank_gap``, the widest gap between any rank's parameters
after the window and rank 0's (the ranks are equal bit for bit by design).

``spec["rank_hook"]`` (tests only): a picklable callable that each rank
calls with its rank first, to break the timed path underneath.
"""

from __future__ import annotations

import importlib
import multiprocessing
import queue
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import torch

from port_bench import harness, program, roofline
from port_bench.drivers import train as single
from port_bench.reference import train as ref_train
from port_bench.trace import traced
from port_bench.traffic.scenes import scenes
from port_bench.weights import make_weights

COMPARED_STEPS = single.COMPARED_STEPS
HOST = "127.0.0.1"


def conf_of(cell) -> dict:
    return dict(cell.config["config"], model=program.model_group(cell))


def global_size(cell) -> int:
    return cell.config["config"]["train"]["batch_size"]


def rank_size(cell) -> int:
    """A rank's rows of a global batch (``fit``'s split)."""
    b, world = global_size(cell), cell.entry["chips"]
    if b % world:
        raise ValueError(f"train_dp: a global batch of {b} does not split "
                         f"over {world} ranks")
    return b // world


def rank_rows(cell, seed: int, j: int, rank: int, device) -> dict:
    """Rank ``rank``'s rows of global batch ``j`` of the pool: ``rank_size``
    canvases of the mix's scene kind, drawn on ``device`` from a stream of
    their own."""
    tr = cell.traffic
    gen = torch.Generator(device=device).manual_seed(
        harness.subseed(seed, f"scenes{j}.{rank}"))
    imgs, boxes, valid = scenes(rank_size(cell), (tr["canvas"], tr["canvas"]),
                                tr["scene"], tr["max_boxes"], gen,
                                height=tr["heights"], any_count=True)
    return {"image": imgs, "boxes": boxes, "box_valid": valid}


def global_batch(cell, seed: int, j: int, device) -> dict:
    """Global batch ``j``: every rank's rows, in rank order."""
    parts = [rank_rows(cell, seed, j, r, device)
             for r in range(cell.entry["chips"])]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def global_draws(cell, conf: dict, seed: int, i: int, device) -> dict:
    """The benchmark's draws of step ``i`` for the global batch."""
    tr = cell.traffic
    return single.step_draws(conf, global_size(cell),
                             tr["max_boxes"], seed, i, device,
                             len(ref_train.head_names(conf["model"])))


def weights_of(cell, conf: dict, seed: int, device) -> dict:
    return make_weights(conf["model"], cell.config["assumed"]["biases"],
                        harness.subseed(seed, "weights"), device,
                        torch.float32)


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone().numpy() for k, v in tensors.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ranked(cell, seed: int, seconds: float, trace: bool, device, rank: int,
            born: float, phases: dict) -> dict:
    """One rank's set-up, window and readings; ``phases``: seconds from
    ``born`` to each step of set-up."""
    import torch.distributed as dist
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from densebox_tpu_torch.train.loop import TrainState

    phases["joined"] = time.time() - born
    cfg = program.config(cell)
    conf = conf_of(cell)
    mesh = make_mesh(n_model=1)
    # the window's go / stop and its barriers, on the host
    ctl = dist.new_group(backend="gloo")
    model = DenseBox(cfg.model, device=device)
    model.load_state_dict(weights_of(cell, conf, seed, device))
    state = TrainState(step=0, model=model,
                       momentum={n: torch.zeros_like(p)
                                 for n, p in model.named_parameters()},
                       generator=torch.Generator(device=device), seed=seed)
    step, place_state, _ = make_sharded_train_step(
        model, cfg, mesh, state, sample_from_canvas=True, device=device)
    state = place_state(state)
    phases["state placed"] = time.time() - born
    pool = [rank_rows(cell, seed, j, rank, device)
            for j in range(cell.traffic["pool_batches"])]
    _sync(device)
    phases["pool made"] = time.time() - born

    def one(i):
        nonlocal state
        state, metrics = step(state, pool[i % len(pool)],
                              draws=global_draws(cell, conf, seed, i, device)
                              if i < COMPARED_STEPS else None)
        return metrics

    out: dict = {}
    losses = []
    for i in range(COMPARED_STEPS):
        losses.append(one(i)["loss_total"])
        if i == 0 and rank == 0:
            out["first_trace"] = _numpy(state.momentum)
    if rank == 0:
        out["losses"] = [float(v) for v in losses]
        out["after"] = _numpy(dict(model.named_parameters()))

    _sync(device)
    phases["steps compared"] = time.time() - born
    every = cell.traffic["check_every"]
    go = torch.ones(1, dtype=torch.int32)
    dist.barrier(group=ctl)
    out["setup_s"] = phases["window"] = time.time() - born
    out["phases"] = phases
    done = 0
    tout: dict = {}
    with traced(trace, tout):
        t0 = time.perf_counter()
        while True:
            go[0] = int(time.perf_counter() - t0 < seconds)
            dist.broadcast(go, 0, group=ctl)
            if not go[0]:
                break
            for _ in range(every):
                one(COMPARED_STEPS + done)
                done += 1
        _sync(device)
        dist.barrier(group=ctl)
        out["window_s"] = time.perf_counter() - t0
    out["steps"] = done
    cuda = device.type == "cuda"
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)
                                   if cuda else 0)
    out["kind"] = torch.cuda.get_device_name(device) if cuda else str(device)
    out["params"] = torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()]).cpu().numpy()
    summ = tout["summary"]
    if summ is not None:        # one string a kernel name: pickled once
        summ = summ.for_breakdown()
        summ.device = [(s, e, sys.intern(n)) for s, e, n in summ.device]
    out["trace"] = summ
    out["forbidden"] = harness.forbidden_modules()
    return out


def rank_main(rank: int, world: int, port: int, cell, seed: int,
              seconds: float, trace: bool, device_type: str, born: float,
              results) -> None:
    """The body of rank ``rank`` (a spawned process): join the group at the
    parent's store, run, and put ``(rank, readings)`` on ``results``."""
    import torch.distributed as dist

    phases = {"started": time.time() - born}
    hook = cell.spec.get("rank_hook")
    if hook is not None:
        hook(rank)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(1)
        device, backend = torch.device("cpu"), "gloo"
    phases["card set"] = time.time() - born
    store = dist.TCPStore(HOST, port, world, is_master=False,
                          timeout=timedelta(seconds=300))
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timedelta(seconds=300))
    try:
        res = _ranked(cell, seed, seconds, trace, device, rank, born, phases)
    finally:
        dist.destroy_process_group()
    results.put((rank, res))


def spawn(cell, seed: int, seconds: float, trace: bool, device) -> list:
    """Every rank's readings, in rank order."""
    import torch.distributed as dist
    from densebox_tpu_torch.parallel.multihost import run_processes

    world = cell.entry["chips"]
    born = time.time() - harness.process_age_s()
    print(f"port_bench.train_dp: spawning at {time.time() - born:.2f} s",
          file=sys.stderr)
    store = dist.TCPStore(HOST, 0, world, is_master=True,
                          wait_for_workers=False)
    results = multiprocessing.get_context("spawn").Queue()
    got: dict = {}
    stop = threading.Event()

    def drain():        # read while the ranks write: a full pipe blocks them
        while len(got) < world and not stop.is_set():
            try:
                r, res = results.get(timeout=0.5)
            except queue.Empty:
                continue
            got[r] = res

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        # by its import name: the harness loads this file under another,
        # which a spawned process could not import
        fn = importlib.import_module("port_bench.drivers.train_dp").rank_main
        run_processes(fn, world, (world, store.port, cell, seed, seconds,
                                  trace, device.type, born, results),
                      timeout=seconds + 900.0)
        reader.join(60.0)
    finally:
        stop.set()
    if len(got) < world:
        raise RuntimeError(f"train_dp: {world - len(got)} of {world} ranks "
                           f"gave no readings")
    return [got[r] for r in range(world)]


def rank_gap(params: list) -> float:
    """The widest absolute gap between an element of any rank's flat
    parameters and rank 0's."""
    return max(float(np.abs(p - params[0]).max()) for p in params[1:])


def run(cell, seed: int, seconds: float, trace: bool, device
        ) -> harness.Outcome:
    device = torch.device(device)
    ranks = spawn(cell, seed, seconds, trace, device)
    bad = sorted({m for r in ranks for m in r["forbidden"]})
    if bad:
        raise RuntimeError(f"train_dp: a rank loaded modules of {bad}")
    kinds = {r["kind"] for r in ranks}
    if len(kinds) != 1:
        raise RuntimeError(f"train_dp: the ranks ran on {sorted(kinds)}")
    steps = {r["steps"] for r in ranks}
    if len(steps) != 1:
        raise RuntimeError(f"train_dp: the ranks took {sorted(steps)} steps")
    first = ranks[0]
    for r, res in enumerate(ranks):
        print(f"port_bench.train_dp: rank {r} at " + ", ".join(
            f"{k} {v:.2f} s" for k, v in res["phases"].items()),
            file=sys.stderr)
    done, world = first["steps"], len(ranks)
    b = rank_size(cell)
    images = done * b * world
    conf = conf_of(cell)
    ctx = {"steps": done, "images": images, "window_s": first["window_s"],
           "least_s_per_step": roofline.least_s(roofline.train_products(
               conf["model"], b, conf["label"]["patch_size"]))}
    numbers, ctx["readings"] = check(cell, conf, seed, device, first,
                                     [r["params"] for r in ranks])
    return harness.Outcome(
        attempted=images, failed=0,
        end_to_end={"train_images_per_s": images / first["window_s"],
                    "setup_s": first["setup_s"]},
        ctx=ctx, numbers=numbers,
        memory_peak_bytes=max(r["memory_peak_bytes"] for r in ranks),
        device_kind=first["kind"], traces=[r["trace"] for r in ranks],
        count=world)


def check(cell, conf: dict, seed: int, device, first: dict, params: list):
    """``drivers/train.py:check``'s numbers of rank 0's first steps against
    the reference's steps on the global batches, and ``rank_gap``."""
    weights = weights_of(cell, conf, seed, device)
    batches = [global_batch(cell, seed, i, device)
               for i in range(COMPARED_STEPS)]
    draws = [global_draws(cell, conf, seed, i, device)
             for i in range(COMPARED_STEPS)]

    def on_device(arrays):
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    numbers, readings = single.check(conf, weights, batches, draws,
                                     first["losses"],
                                     on_device(first["first_trace"]),
                                     on_device(first["after"]))
    numbers["rank_gap"] = rank_gap(params)
    return numbers, readings
