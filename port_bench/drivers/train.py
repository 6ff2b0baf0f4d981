"""Training: ``densebox_tpu_torch.train.make_canvas_train_step`` steps one
after another, each on a batch of canvases: patches sampled on the card,
GT rasterised, forward, OHEM loss, backward and SGD.

Set-up makes the weights and a pool of canvas batches (scenes with their
boxes) on the device, builds one train state and its step, and drives it
through its first three steps: they warm every shape up and are the steps
the reference follows. Their random draws (patch windows and flips, the
heads' dropout mask, the OHEM noise) are made by the benchmark from the
seed and the step and given to the step, as its ``draws`` argument allows,
so that the reference can be handed them too. The window hands the same
state and step on, one batch of the pool after another, for its length;
there the step makes its own draws from its state's generator, as training
does. ``train_images_per_s`` counts the images of every step in the window
over all of its time.

After the window the reference runs the first three steps from the same
weights, batches and draws, and the comparison holds the program to it:
each step's loss, the gradient the optimizer got at the first step (from
the momentum after it), and each leaf's change after the three steps.
"""

from __future__ import annotations

import statistics
import time

import torch

from port_bench import harness, program, roofline
from port_bench.reference import train as ref_train
from port_bench.trace import traced
from port_bench.traffic.scenes import scenes
from port_bench.weights import make_weights

COMPARED_STEPS = 3


def step_draws(conf: dict, b: int, k: int, seed: int, step: int, device,
               heads: int) -> dict:
    """The draws of step ``step``, from the seed and the step alone."""
    label, model = conf["label"], conf["model"]
    gen = torch.Generator(device=device).manual_seed(
        harness.subseed(seed, f"draws{step}"))

    def uni(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, device=device, generator=gen) * (hi - lo) + lo

    lo, hi = label["scale_band"]
    patches = {"anchor": uni((b, k)), "scale": uni((b,), lo, hi),
               "trans": uni((b, 2), -0.25, 0.25),
               "neg_size": uni((b,), 0.5, 2.0), "neg_pos": uni((b, 2)),
               "neg": uni((b,)), "flip": uni((b,))}
    m = label["patch_size"] // label["stride"]
    width = ref_train.scaled_width(model)
    keep = torch.randint(0, 256, (b, m, m, heads * width), dtype=torch.uint8,
                         device=device, generator=gen) >= 128
    return {"patches": patches, "dropout_keep": keep,
            "ohem_score": uni((b, m * m))}


def leaf_gap(got: dict, want: dict, skip=()) -> float:
    """The widest gap between a leaf's norm in the program and in the
    reference, over the larger of the reference leaf's norm and the median
    leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in want.items()}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(got[k].double()))
                   - norms[k]) / max(norms[k], med)
               for k in want if k not in skip)


def inputs(cell, seed: int, device):
    """(configuration groups as run, pool of canvas batches, weights, and
    the draws of step i as a function of i) of a run."""
    tr = cell.traffic
    conf = dict(cell.config["config"], model=program.model_group(cell))
    b, k = tr["batch"], tr["max_boxes"]
    gen = torch.Generator(device=device).manual_seed(
        harness.subseed(seed, "scenes"))
    n = tr["pool_batches"] * b
    imgs, boxes, valid = scenes(n, (tr["canvas"], tr["canvas"]), tr["scene"],
                                k, gen, height=tr["heights"], any_count=True)
    pool = [{"image": imgs[i:i + b], "boxes": boxes[i:i + b],
             "box_valid": valid[i:i + b]} for i in range(0, n, b)]
    weights = make_weights(conf["model"], cell.config["assumed"]["biases"],
                           harness.subseed(seed, "weights"), device,
                           torch.float32)
    heads = len(ref_train.head_names(conf["model"]))

    def draws(i):
        return step_draws(conf, b, k, seed, i, device, heads)
    return conf, pool, weights, draws


def run(cell, seed: int, seconds: float, trace: bool, device
        ) -> harness.Outcome:
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.train import make_canvas_train_step
    from densebox_tpu_torch.train.loop import TrainState

    device = torch.device(device)
    cfg = program.config(cell)
    conf, pool, weights, draws_of = inputs(cell, seed, device)
    b = cell.traffic["batch"]
    model = DenseBox(cfg.model, device=device)
    model.load_state_dict(weights)
    state = TrainState(step=0, model=model,
                       momentum={n_: torch.zeros_like(p)
                                 for n_, p in model.named_parameters()},
                       generator=torch.Generator(device=device), seed=seed)
    step_fn = make_canvas_train_step(model, cfg, device=device)

    def one(i):
        nonlocal state
        state, metrics = step_fn(state, pool[i % len(pool)],
                                 draws=draws_of(i) if i < COMPARED_STEPS
                                 else None)
        return metrics

    losses, first_trace = [], None
    for i in range(COMPARED_STEPS):
        losses.append(one(i)["loss_total"])
        if i == 0:
            first_trace = {n_: v.clone() for n_, v in state.momentum.items()}
    after = {n_: p.detach().clone() for n_, p in model.named_parameters()}
    losses = [float(v) for v in losses]
    setup_s = harness.process_age_s()

    done = 0
    tout: dict = {}
    with traced(trace, tout):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            one(COMPARED_STEPS + done)
            done += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    ctx = {"steps": done, "images": done * b, "window_s": window_s,
           "least_s_per_step": roofline.least_s(roofline.train_products(
               conf["model"], b, conf["label"]["patch_size"]))}
    del model, state, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    batches = [pool[i % len(pool)] for i in range(COMPARED_STEPS)]
    draws = [draws_of(i) for i in range(COMPARED_STEPS)]
    numbers, ctx["readings"] = check(conf, weights, batches, draws, losses,
                                     first_trace, after)
    return harness.Outcome(
        attempted=done * b, failed=0,
        end_to_end={"train_images_per_s": done * b / window_s,
                    "setup_s": setup_s},
        ctx=ctx, numbers=numbers, memory_peak_bytes=int(peak),
        device_kind=kind, traces=[tout["summary"]])


def check(conf, weights, batches, draws, losses, first_trace, after):
    """``loss_gap`` (the widest relative gap of a step's loss),
    ``grad_gap`` (of the first gradient, as the optimizer got it, by leaf)
    and ``update_gap`` (of the change after the compared steps, by leaf),
    against the reference's steps; leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the last."""
    want_losses, want_trace, want_after, grad_norms = ref_train.steps(
        weights, conf, batches, draws)
    wd = conf["train"]["weight_decay"]
    p0 = {n: w.float() for n, w in weights.items()}
    med = statistics.median(grad_norms.values())
    nought = {n for n, g in grad_norms.items() if g < 1e-3 * med}

    def grad(trace):
        return {n: trace[n] - wd * p0[n] for n in p0}

    def change(params):
        return {n: params[n] - p0[n] for n in p0}

    numbers = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, want_losses)),
        "grad_gap": leaf_gap(grad(first_trace), grad(want_trace)),
        "update_gap": leaf_gap(change(after), change(want_after), nought)}
    return numbers, {"losses": losses, "reference_losses": want_losses,
                     "nought_leaves": sorted(nought)}
