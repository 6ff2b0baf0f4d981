"""The port's train step against the JAX package's, on the CPU.

The same numpy batch, the same parameters (``from_flax``) and momentum
(``state_from_jax``) and the same random draws go through
``densebox_tpu.train.loop.make_train_step`` (called directly, without jit,
with its Pallas rasterizer and OHEM kernels in interpret mode) and through
the port's step. Torch cannot replay threefry, so the test reproduces JAX's
draws from its key chain and hands them to the port: the OHEM uniforms from
``fold_in(state.key, step) -> split -> split -> per-sample split``, the
dropout keep mask captured from the key ``fused_relu_dropout`` receives.

Bars (float32): GT maps and OHEM masks identical; loss within 1e-5
relative; every gradient within 1e-4 of its largest entry; ``update_norm``
within 1e-5 relative; parameters after 3 steps within 1e-5 absolute. The
tolerances cover float32 sums taken in another order (convolutions, the
loss reductions), nothing else.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from densebox_tpu import config as jax_config
from densebox_tpu.data import synthetic_batch as jax_synthetic_batch
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import densebox as jax_db
from densebox_tpu.ops.labels import rasterize as jax_rasterize
from densebox_tpu.ops.pallas.ohem import ohem_mask_pallas
from densebox_tpu.train import loop as jax_loop
from densebox_tpu_torch.config import (DenseBoxConfig, LabelCfg, ModelCfg,
                                       TrainCfg)
from densebox_tpu_torch.data import synthetic_batch
from densebox_tpu_torch.models import (DenseBox, QuantDenseBox,
                                       dropout_keep_mask, dropout_plan,
                                       fused_relu_dropout, state_from_jax)
from densebox_tpu_torch.ops.kernels.ohem import ohem_select
from densebox_tpu_torch.ops.labels import rasterize
from densebox_tpu_torch.serve import DetectServer
from densebox_tpu_torch.train.loop import repeatable_kernels
from densebox_tpu_torch.train import (create_train_state, learning_rate,
                                      make_canvas_train_step, make_train_step,
                                      sgd_update)
from test_torch_ohem import kernel_uniforms


def _cfgs(landmarks=0, refine=False, **train_kw):
    """The same small config in both packages (width 0.125, 64 px patches,
    16x16 maps); the JAX one with its Pallas backends."""
    model = dict(num_landmarks=landmarks, use_refine=refine, width_mult=0.125)
    label = dict(patch_size=64, std_height_px=20.0)
    train = dict(batch_size=4, learning_rate=3e-3, max_boxes=3, **train_kw)
    port = DenseBoxConfig(model=ModelCfg(**model), label=LabelCfg(**label),
                          train=TrainCfg(**train))
    ref = jax_config.DenseBoxConfig(
        model=jax_config.ModelCfg(**model), label=jax_config.LabelCfg(**label),
        loss=jax_config.LossCfg(backend="pallas"),
        train=jax_config.TrainCfg(label_backend="pallas", **train))
    return port, ref


@pytest.mark.parametrize("rate,bits8", [(0.5, True), (0.25, True),
                                        (0.3, False)])
def test_fused_relu_dropout_identical_to_jax(rate, bits8):
    """Forward and backward equal JAX's for the same keep mask: the byte
    draw where the rate is a multiple of 1/256, else the exact-rate draw."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    g = rng.randn(2, 8, 8, 16).astype(np.float32)
    key = jax.random.key(3)
    thresh, keep_prob = dropout_plan(rate)
    assert bool(thresh) == bits8
    cfg = jax_config.ModelCfg(dropout_rate=rate)
    assert (jax_db.resolved_dropout_impl(cfg) == "fused8") == bits8
    f = jax_db.fused_relu_dropout(rate, bits8=bits8)
    want, vjp = jax.vjp(lambda a: f(a, key), jnp.asarray(x))
    want_dx, = vjp(jnp.asarray(g))
    if bits8:
        keep = np.asarray(jax.random.bits(key, x.shape, jnp.uint8)) >= thresh
    else:
        keep = np.asarray(jax.random.bernoulli(key, keep_prob, x.shape))
    tx = torch.from_numpy(x).requires_grad_()
    got = fused_relu_dropout(tx, torch.from_numpy(keep), keep_prob)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_dx))
    assert 0.3 < keep.mean() < 0.9


def test_dropout_keep_mask_rates_and_determinism():
    for rate in (0.5, 0.25, 0.3, 1 / 1024):
        a = dropout_keep_mask((64, 1024), rate,
                              torch.Generator().manual_seed(1))
        b = dropout_keep_mask((64, 1024), rate,
                              torch.Generator().manual_seed(1))
        assert a.dtype == torch.bool and torch.equal(a, b)
        assert abs(float(a.float().mean()) - (1 - rate)) < 0.01
    model = DenseBox(ModelCfg(width_mult=0.125), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(1, 16, 16, 3), train=True)


def test_max_pool_backward_sends_ties_to_the_first_maximum():
    """XLA's select_and_scatter gives a tied 2x2 window's gradient to its
    first maximum (row-major); after ReLU whole windows tie at 0. torch's
    max_pool2d backward does the same on the CPU."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, (2, 8, 8, 4)).astype(np.float32)
    x[:, :4] = 0.0
    w = rng.randn(2, 4, 4, 4).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_db._max_pool(
        a, jax_config.ModelCfg()) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    (F.max_pool2d(tx, 2, 2) * torch.from_numpy(w).permute(0, 3, 1, 2)
     ).sum().backward()
    np.testing.assert_array_equal(tx.grad.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _optax_steps(ref_cfg, params, grads_per_step):
    tx = jax_loop.make_optimizer(ref_cfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(p)
    norms = []
    for grads in grads_per_step:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            st, p)
        norms.append(float(jax_loop.optax.global_norm(upd)))
        p = jax_loop.optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}, norms


@pytest.mark.parametrize("case", ["plain", "exploding", "no_clip",
                                  "decay_boundary"])
def test_sgd_update_matches_optax_chain(case):
    """Clip -> weight decay -> momentum -> staircase lr against the JAX
    package's optax chain over 4 steps: parameters within 1e-6 relative to
    their size, update norms within 1e-5 relative."""
    kw = {"no_clip": dict(grad_clip_norm=0.0),
          "decay_boundary": dict(lr_decay_steps=2)}.get(case, {})
    port, ref = _cfgs(**kw)
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    scale = 1e9 if case == "exploding" else 1.0
    grads = [{k: (rng.randn(*v.shape) * scale * (20 if i == 1 else 1))
              .astype(np.float32) for k, v in params.items()}
             for i in range(4)]
    want, want_norms = _optax_steps(ref, params, grads)
    tp = [torch.from_numpy(v.copy()) for v in params.values()]
    mom = [torch.zeros_like(p) for p in tp]
    norms = [float(sgd_update(tp, [torch.from_numpy(g[k]) for k in params],
                              mom, port, step)) for step, g in enumerate(grads)]
    for got, k in zip(tp, params):
        np.testing.assert_allclose(got.numpy(), want[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    if case == "exploding":     # bounded by lr * clip norm (+ weight decay)
        assert max(norms) <= 3e-3 * 10.0 * 2.0
    if case == "decay_boundary":
        assert learning_rate(port, 1) == 3e-3
        assert learning_rate(port, 2) == 1.5e-3
        assert learning_rate(port, 4) == 0.75e-3


def _capture_dropout(masks):
    """A stand-in for ``jax_db.fused_relu_dropout`` that also records the
    keep mask JAX draws from the key it is given."""
    real = jax_db.fused_relu_dropout

    def factory(rate, bits8=False):
        f = real(rate, bits8=bits8)
        thresh, keep_prob = dropout_plan(rate)

        def wrapped(y, key):
            masks.append(np.asarray(
                jax.random.bits(key, y.shape, jnp.uint8) >= thresh if bits8
                else jax.random.bernoulli(key, keep_prob, y.shape)))
            return f(y, key)
        return wrapped
    return factory


def _jax_step_with_grads(jmodel, ref, state, batch):
    """One JAX train step (eager), its gradients and the dropout mask it
    drew."""
    masks = []
    with mock.patch.object(jax_db, "fused_relu_dropout",
                           _capture_dropout(masks)):
        new_state, metrics = jax_loop.make_train_step(jmodel, ref)(state, batch)
        step_key = jax.random.fold_in(state.key, state.step)
        k_drop, k_loss = jax.random.split(step_key)
        gts = jax_rasterize(batch["boxes"], batch["box_valid"], ref.label,
                            batch.get("landmarks"), batch.get("lm_valid"),
                            backend="pallas")

        def loss_fn(params):
            out = jmodel.apply(params, batch["image"], train=True,
                               rngs={"dropout": k_drop})
            return jax_loop.densebox_loss(out, gts, k_loss, ref.loss)[0], out
        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    assert all(np.array_equal(masks[0], m) for m in masks)
    return new_state, metrics, grads, masks[0], k_loss, gts, out


def _trace(opt_state):
    return opt_state[-1][0].trace


@pytest.mark.parametrize("landmarks,refine", [(0, False), (3, True)],
                         ids=["det", "lm_refine"])
def test_train_step_matches_jax(landmarks, refine):
    port_cfg, ref = _cfgs(landmarks, refine)
    b, k = 4, 3
    jmodel = JaxDenseBox(ref.model)
    batches = [jax_synthetic_batch(jax.random.key(i), b, ref.label,
                                   max_boxes=k, num_landmarks=landmarks)
               for i in range(4)]
    jstate = jax_loop.create_train_state(jmodel, ref, batches[0]["image"])
    # one JAX step first, so that the momentum carried across is not zero
    jstate, _ = jax_loop.make_train_step(jmodel, ref)(jstate, batches[0])

    model = DenseBox(port_cfg.model, device="cpu")
    state = create_train_state(model, port_cfg, device="cpu")
    state.load(*state_from_jax(jax.tree.map(np.asarray, jstate.params),
                               jax.tree.map(np.asarray, _trace(jstate.opt_state)),
                               int(jstate.step), port_cfg.model))
    assert state.step == 1
    step = make_train_step(model, port_cfg, device="cpu")
    p = port_cfg.label.map_size ** 2

    for batch in batches[1:]:
        jstate, want, jgrads, keep, k_loss, jgts, jout = _jax_step_with_grads(
            jmodel, ref, jstate, batch)
        tbatch = {kk: torch.from_numpy(np.array(v)) for kk, v in batch.items()}
        # GT maps: identical
        gts = rasterize(tbatch["boxes"], tbatch["box_valid"], port_cfg.label,
                        tbatch.get("landmarks"), tbatch.get("lm_valid"))
        assert set(gts) == set(jgts)
        for name in jgts:
            np.testing.assert_array_equal(gts[name].numpy(),
                                          np.asarray(jgts[name]), err_msg=name)
        # OHEM mask: identical when fed the same squared errors
        k_cls, k_ref = jax.random.split(k_loss)
        draws = {"dropout_keep": torch.from_numpy(keep),
                 "ohem_score": torch.from_numpy(kernel_uniforms(k_cls, b, p))}
        if refine:
            draws["ohem_refined"] = torch.from_numpy(
                kernel_uniforms(k_ref, b, p))
        sq = np.asarray((jout["score"] - jgts["score"]) ** 2).reshape(b, -1)
        pos = np.asarray(jgts["score"] > 0.5).reshape(b, -1)
        ign = np.asarray(jgts["ignore"] > 0.5).reshape(b, -1)
        jmask = ohem_mask_pallas(jnp.asarray(sq), jnp.asarray(pos),
                                 jnp.asarray(ign), k_cls, ref.loss)
        mask = ohem_select(torch.from_numpy(sq), torch.from_numpy(pos),
                           torch.from_numpy(ign), draws["ohem_score"],
                           1.0, 0.5, 16)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))

        state, got = step(state, tbatch, draws=draws)
        assert set(got) == set(want)
        assert float(got["n_sampled"]) == float(want["n_sampled"])
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-5, err_msg=name)
        flat = state_from_jax(jax.tree.map(np.asarray, jgrads),
                              jax.tree.map(np.asarray, jgrads), 0,
                              port_cfg.model)[0]
        for name, prm in model.named_parameters():
            w = flat[name].numpy()
            np.testing.assert_allclose(prm.grad.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)

    assert state.step == int(jstate.step) == 4
    sd, mom, _ = state_from_jax(jax.tree.map(np.asarray, jstate.params),
                                jax.tree.map(np.asarray, _trace(jstate.opt_state)),
                                4, port_cfg.model)
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), sd[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(state.momentum[name].numpy(),
                                   mom[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_state_from_jax_transposes_momentum_like_kernels():
    cfg = ModelCfg(width_mult=0.125)
    rng = np.random.RandomState(0)
    tree = {"conv1_1": {"kernel": rng.randn(3, 3, 3, 8).astype(np.float32),
                        "bias": rng.randn(8).astype(np.float32)}}
    model = DenseBox(cfg, device="meta")
    full = {}
    for name, prm in model.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        node = full
        for part in mod.split("."):
            node = node.setdefault(part, {})
        shape = tuple(prm.shape)
        node["kernel" if leaf == "weight" else "bias"] = rng.randn(
            *((shape[2], shape[3], shape[1], shape[0]) if leaf == "weight"
              else shape)).astype(np.float32)
    full["conv1_1"] = tree["conv1_1"]
    sd, mom, step = state_from_jax({"params": full}, full, np.int32(7), cfg)
    assert step == 7 and set(sd) == set(mom) == {
        n for n, _ in model.named_parameters()}
    np.testing.assert_array_equal(
        mom["conv1_1.weight"].numpy(),
        np.transpose(tree["conv1_1"]["kernel"], (3, 2, 0, 1)))


@pytest.mark.parametrize("landmarks,refine,canvas",
                         [(0, False, False), (4, True, True)],
                         ids=["patches", "canvas_lm_refine"])
def test_loss_decreases_over_50_steps(landmarks, refine, canvas):
    """Config-4 acceptance on the port's own generator: finite losses, the
    mean of the last 10 below 0.6 of the first 10; parameters move; the
    state's generator makes a run repeatable."""
    cfg, _ = _cfgs(landmarks, refine)
    if refine:
        cfg = dataclasses.replace(cfg, label=dataclasses.replace(
            cfg.label, lm_flip_perm=(1, 0, 3, 2)))
    data_label = (dataclasses.replace(cfg.label, patch_size=96)
                  if canvas else cfg.label)

    def run():
        model = DenseBox(cfg.model, device="cpu")
        state = create_train_state(model, cfg, device="cpu")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        make = make_canvas_train_step if canvas else make_train_step
        step = make(model, cfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        losses = []
        for _ in range(50):
            batch = synthetic_batch(gen, 4, data_label, max_boxes=3,
                                    num_landmarks=landmarks, device="cpu")
            state, metrics = step(state, batch)
            assert np.isfinite(float(metrics["update_norm"]))
            losses.append(float(metrics["loss_total"]))
        moved = max(float((v - before[k]).abs().max())
                    for k, v in model.state_dict().items())
        return losses, moved, state.step

    losses, moved, steps = run()
    assert steps == 50 and moved > 0 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.6 * np.mean(losses[:10]), losses
    assert run()[0] == losses


@pytest.mark.parametrize("landmarks,refine,canvas",
                         [(0, False, False), (4, True, True)],
                         ids=["patches", "canvas_lm_refine"])
def test_step_repeats_and_pins_cudnn_only_inside(landmarks, refine, canvas):
    """The same step from the same parameters, momentum and generator state
    gives the same parameters, momentum and metrics bit for bit (on the
    card this is what ``repeatable_kernels`` is for: chip_smoke.py phase 19
    and the GPU test hold it there). The cuDNN flag is set while the model
    runs forward and backward, and is put back after the step."""
    cfg, _ = _cfgs(landmarks, refine)
    if refine:
        cfg = dataclasses.replace(cfg, label=dataclasses.replace(
            cfg.label, lm_flip_perm=(1, 0, 3, 2)))
    data_label = (dataclasses.replace(cfg.label, patch_size=96)
                  if canvas else cfg.label)
    model = DenseBox(cfg.model, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    step = (make_canvas_train_step if canvas else make_train_step)(
        model, cfg, device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), 4, data_label,
                            max_boxes=3, num_landmarks=landmarks, device="cpu")
    step(state, batch)
    start = ({k: v.clone() for k, v in model.state_dict().items()},
             {k: v.clone() for k, v in state.momentum.items()},
             state.generator.get_state())
    seen = []
    forward = model.forward

    def watching(*args, **kw):
        seen.append(torch.backends.cudnn.deterministic)
        return forward(*args, **kw)

    runs = []
    assert torch.backends.cudnn.deterministic is False
    with mock.patch.object(model, "forward", watching):
        for _ in range(2):
            state.load(start[0], start[1], 1)
            state.generator.set_state(start[2])
            _, metrics = step(state, batch)
            runs.append(({k: v.clone() for k, v in model.state_dict().items()},
                         {k: v.clone() for k, v in state.momentum.items()},
                         dict(metrics)))
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic is False
    for first, second in zip(runs[0], runs[1]):
        for k in first:
            assert torch.equal(first[k], second[k]), k
    with pytest.raises(ZeroDivisionError), repeatable_kernels():
        1 / 0
    assert torch.backends.cudnn.deterministic is False


def test_repeatable_kernels_overlapping_in_two_threads():
    """Two steps inside at once, leaving in the order they came in: the
    flag stays set until the last is out and ends as it was found."""
    import threading

    inside, leave = threading.Event(), threading.Event()
    seen = []

    def other():
        with repeatable_kernels():
            inside.set()
            leave.wait(10)
        seen.append(torch.backends.cudnn.deterministic)

    assert torch.backends.cudnn.deterministic is False
    with repeatable_kernels():
        thread = threading.Thread(target=other)
        thread.start()
        assert inside.wait(10)
    # the first one in is out, the second still inside
    assert torch.backends.cudnn.deterministic is True
    leave.set()
    thread.join(10)
    assert seen == [False]
    assert torch.backends.cudnn.deterministic is False


def test_entry_points_default_to_the_card():
    """Without a card the train entry points raise instead of carrying on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg, _ = _cfgs()
    model = DenseBox(cfg.model, device="cpu")
    for call in (lambda: create_train_state(model, cfg),
                 lambda: make_train_step(model, cfg),
                 lambda: make_canvas_train_step(model, cfg),
                 lambda: synthetic_batch(torch.Generator(), 2, cfg.label),
                 lambda: DenseBox(cfg.model),
                 lambda: QuantDenseBox(cfg.model),
                 lambda: DetectServer(model, cfg.infer, cfg.label)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    state = create_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown draws"):
        step(state, {}, draws={"dropout": None})
    other = DenseBox(cfg.model, device="cpu")
    with pytest.raises(ValueError, match="another model"):
        make_train_step(other, cfg, device="cpu")(state, {})
