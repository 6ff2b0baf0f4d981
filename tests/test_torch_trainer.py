"""The port's trainer (``fit``, exact resume, ``TrainingDiverged``,
``MetricsLogger``) on the CPU, against the JAX package's ``fit`` and against
itself.

Tiny shapes (width 0.125, 64 px patches, B = 2 to 4), ``device="cpu"``,
step-keyed synthetic batches. Bars: against JAX's ``fit`` (run without jit,
the same weights carried across by ``state_from_jax``, JAX's draws fed
through ``draws``) ``loss_total`` within 1e-5 relative and parameters
within 1e-5 absolute after 3 steps, the bars of
``tests/test_torch_train_step.py`` (float32 sums taken in another order);
a run resumed from a checkpoint equals the uninterrupted run bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from densebox_tpu.data import synthetic_batch as jax_synthetic_batch
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import densebox as jax_db
from densebox_tpu.train import loop as jax_loop
from densebox_tpu.train import trainer as jax_trainer
from densebox_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from densebox_tpu_torch import kitti_vehicle, malf_face
from densebox_tpu_torch.data import synthetic_batch
from densebox_tpu_torch.models import DenseBox, state_from_jax
from densebox_tpu_torch.train import (TrainingDiverged, create_train_state,
                                      fit, make_manager, step_seed, trainer)
from densebox_tpu_torch.utils.logging import MetricsLogger
from test_torch_ohem import kernel_uniforms
from test_torch_train_step import _capture_dropout, _cfgs, _trace
import torch_threads  # noqa: F401  (sets torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(preset, **train_kw):
    """The preset cut to width 0.125, 64 px patches, B = 2, K = 3."""
    cfg = preset()
    train = dict(batch_size=2, max_boxes=3, log_every=2, ckpt_every=2,
                 ckpt_keep=2)
    train.update(train_kw)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, width_mult=0.125),
        label=dataclasses.replace(cfg.label, patch_size=64,
                                  std_height_px=20.0),
        train=dataclasses.replace(cfg.train, **train))


def _stream(cfg, canvas):
    """A ``step -> batch`` stream keyed by the step: patches, or 96 px
    canvases for the step to crop."""
    label = (dataclasses.replace(cfg.label, patch_size=96) if canvas
             else cfg.label)

    def batches(step):
        return synthetic_batch(
            torch.Generator().manual_seed(1000 + step), cfg.train.batch_size,
            label, cfg.train.max_boxes, cfg.model.num_landmarks, device="cpu")
    return batches


def _same(a, b):
    return (set(a) == set(b)
            and all(torch.equal(a[k], b[k]) for k in a))


@pytest.mark.parametrize("landmarks,refine", [(0, False), (3, True)],
                         ids=["det", "lm_refine"])
def test_fit_matches_jax_fit(landmarks, refine):
    """3 steps of both packages' ``fit`` from the same weights on the same
    step-keyed batches with the same draws."""
    port_cfg, ref = _cfgs(landmarks, refine)
    b, steps = 4, 3
    p = port_cfg.label.map_size ** 2
    batches = [jax_synthetic_batch(jax.random.key(10 + i), b, ref.label,
                                   max_boxes=3, num_landmarks=landmarks)
               for i in range(steps)]
    jmodel = JaxDenseBox(ref.model)
    jstate = jax_loop.create_train_state(jmodel, ref, batches[0]["image"])
    start = state_from_jax(jax.tree.map(np.asarray, jstate.params),
                           jax.tree.map(np.asarray, _trace(jstate.opt_state)),
                           int(jstate.step), port_cfg.model)
    masks = []
    with jax.disable_jit(), mock.patch.object(jax_db, "fused_relu_dropout",
                                              _capture_dropout(masks)):
        want = jax_trainer.fit(ref, lambda s: batches[s], None,
                               num_steps=steps, sample_from_canvas=False,
                               use_mesh=False, init_state=jstate)
    per_step = len(masks) // steps
    assert per_step >= 1 and len(masks) == per_step * steps

    def draws(step):
        # the key chain of the JAX trainer's step (three keys a step, the
        # first for the patch crops it does not take here)
        step_key = jax.random.fold_in(jstate.key, step)
        _, _, k_loss = jax.random.split(step_key, 3)
        k_cls, k_ref = jax.random.split(k_loss)
        out = {"dropout_keep": torch.from_numpy(np.array(masks[step * per_step])),
               "ohem_score": torch.from_numpy(kernel_uniforms(k_cls, b, p))}
        if refine:
            out["ohem_refined"] = torch.from_numpy(kernel_uniforms(k_ref, b, p))
        return out

    model = DenseBox(port_cfg.model, device="cpu")
    state = create_train_state(model, port_cfg, device="cpu")
    state.load(*start)
    got = fit(port_cfg,
              lambda s: {k: torch.from_numpy(np.array(v))
                         for k, v in batches[s].items()},
              None, num_steps=steps, sample_from_canvas=False,
              init_state=state, draws=draws, device="cpu")
    assert got.state.step == int(want.state.step) == steps
    assert set(got.last_metrics) == set(want.last_metrics)
    for name, value in want.last_metrics.items():
        np.testing.assert_allclose(got.last_metrics[name], value, rtol=1e-5,
                                   err_msg=name)
    sd, _, _ = state_from_jax(
        jax.tree.map(np.asarray, want.state.params),
        jax.tree.map(np.asarray, _trace(want.state.opt_state)), steps,
        port_cfg.model)
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), sd[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("preset,canvas", [(kitti_vehicle, False),
                                           (malf_face, True)],
                         ids=["kitti_vehicle", "malf_face_canvas"])
def test_resume_is_bit_exact_and_salt_changes_it(preset, canvas, tmp_path):
    """5 steps straight equal 3 steps, a restart from the checkpoint into a
    fresh state, and 2 more: parameters, momentum and metrics bit for bit.
    The same restart with ``run_salt=1`` draws other numbers."""
    cfg = _tiny(preset)
    kw = dict(sample_from_canvas=canvas, device="cpu")
    straight = fit(cfg, _stream(cfg, canvas), str(tmp_path / "a"),
                   num_steps=5, **kw)
    for salted in (False, True):
        work = str(tmp_path / f"b{int(salted)}")
        fetched = []

        def batches(step):
            fetched.append(step)
            return _stream(cfg, canvas)(step)

        part = fit(cfg, batches, work, num_steps=3, **kw)
        assert part.state.step == 3 and fetched == [0, 1, 2]
        assert make_manager(work + "/ckpt").all_steps() == [2, 3]
        del fetched[:]
        resumed = fit(cfg, batches, work, num_steps=5,
                      run_salt=int(salted), **kw)
        # the first batch is always asked for; then the stream goes on at
        # the step the checkpoint holds
        assert fetched == [0, 3, 4]
        assert resumed.state.model is not part.state.model
        assert resumed.state.step == 5
        same = (_same(straight.state.model.state_dict(),
                      resumed.state.model.state_dict())
                and _same(straight.state.momentum, resumed.state.momentum))
        metrics = {k: v for k, v in resumed.last_metrics.items()
                   if k != "steps_per_sec"}
        if salted:
            assert not same and resumed.state.salt != 0
        else:
            assert same and resumed.state.salt == 0
            assert metrics == {k: straight.last_metrics[k] for k in metrics}
    # resume=False starts over in a directory that holds checkpoints
    fresh = fit(cfg, _stream(cfg, canvas), str(tmp_path / "b0"), num_steps=1,
                resume=False, **kw)
    assert fresh.state.step == 1


def test_step_draws_depend_on_seed_salt_and_step_only():
    seeds = {step_seed(s, t, n) for s in range(4) for t in range(4)
             for n in range(64)}
    assert len(seeds) == 4 * 4 * 64
    assert all(0 <= v < 2 ** 63 for v in seeds)
    assert step_seed(3, 0, 7) == step_seed(3, 0, 7)
    cfg = _tiny(kitti_vehicle)
    batch = _stream(cfg, False)(0)
    runs = []
    for used in (0, 5):
        model = DenseBox(cfg.model, device="cpu")
        state = create_train_state(model, cfg, device="cpu")
        # what the generator gave before the step does not matter
        torch.rand(used, generator=state.generator)
        step = trainer.make_canvas_train_step(model, cfg, False, device="cpu")
        runs.append({k: float(v) for k, v in step(state, batch)[1].items()})
    assert runs[0] == runs[1]


@pytest.mark.parametrize("poison", ["loss", "update_norm"])
def test_training_diverged_before_any_checkpoint_write(poison, tmp_path):
    """A non-finite loss (a NaN pixel at step 2, which poisons the
    parameters) and a finite loss with a non-finite update norm both raise
    at the next boundary, step 4, and no checkpoint of that step exists."""
    cfg = _tiny(kitti_vehicle)
    stream = _stream(cfg, False)

    def batches(step):
        batch = stream(step)
        if poison == "loss" and step == 2:
            batch["image"][0, 0, 0, 0] = float("nan")
        return batch

    real = trainer.make_canvas_train_step

    def make(*args, **kw):
        step_fn = real(*args, **kw)

        def wrapped(state, batch, draws=None):
            state, metrics = step_fn(state, batch, draws=draws)
            if poison == "update_norm" and state.step == 4:
                assert np.isfinite(float(metrics["loss_total"]))
                metrics["update_norm"] = torch.tensor(float("inf"))
            return state, metrics
        return wrapped

    work = str(tmp_path / "run")
    with mock.patch.object(trainer, "make_canvas_train_step", make), \
            pytest.raises(TrainingDiverged, match="at step 4"):
        fit(cfg, batches, work, num_steps=6, sample_from_canvas=False,
            device="cpu")
    mngr = make_manager(work + "/ckpt")
    assert mngr.all_steps() == [2]
    assert sorted(os.listdir(mngr.directory)) == ["step_00000002.pt"]


def test_fit_boundaries_iterator_and_last_metrics(tmp_path, capsys):
    """Logs at ``log_every`` and the last step, checkpoints at
    ``ckpt_every`` and the last step, batches from an iterator, floats in
    ``last_metrics``; without a workdir nothing is written or logged."""
    cfg = _tiny(kitti_vehicle, log_every=3, ckpt_every=4, ckpt_keep=5)
    stream = _stream(cfg, False)
    res = fit(cfg, iter([stream(s) for s in range(7)]), str(tmp_path / "w"),
              num_steps=7, sample_from_canvas=False, device="cpu")
    out = capsys.readouterr().out
    assert [ln.split("]")[0] for ln in out.splitlines()] == [
        "[train step 3", "[train step 6", "[train step 7"]
    assert make_manager(str(tmp_path / "w/ckpt")).all_steps() == [4, 7]
    assert all(type(v) is float for v in res.last_metrics.values())
    assert {"loss_total", "update_norm", "steps_per_sec"} <= set(
        res.last_metrics)
    bare = fit(cfg, stream, None, num_steps=2, sample_from_canvas=False,
               device="cpu")
    assert capsys.readouterr().out == ""
    assert all(type(v) is float for v in bare.last_metrics.values())
    assert "steps_per_sec" not in bare.last_metrics
    assert os.listdir(tmp_path) == ["w"]


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = _tiny(kitti_vehicle)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        fit(cfg, _stream(cfg, False), None, num_steps=1)


def test_metrics_logger_line_and_floats(capsys):
    """The same console line as the JAX package's logger for the same
    values (but for the rate), floats returned."""
    metrics = {"loss_total": np.float32(1.2345678), "n_pos": 12,
               "update_norm": 3.25e-5}
    want = JaxMetricsLogger(None).log(7, metrics)
    want_line = capsys.readouterr().out.strip()
    got = MetricsLogger(None).log(7, {k: torch.tensor(v)
                                      for k, v in metrics.items()})
    line = capsys.readouterr().out.strip()

    def without_rate(text):
        return " ".join(w for w in text.split()
                        if not w.startswith("steps_per_sec="))

    assert without_rate(line) == without_rate(want_line)
    assert line.startswith("[train step 7] loss_total=1.235 n_pos=12 ")
    assert set(got) == set(want) and "steps_per_sec" in got
    assert all(type(v) is float for v in got.values())
    assert got["loss_total"] == want["loss_total"]
    again = MetricsLogger(None).log(0, {"a": 1}, prefix="eval")
    assert again == {"a": 1.0}
    assert capsys.readouterr().out == "[eval step 0] a=1\n"


def test_metrics_logger_loads_no_tensorflow(tmp_path):
    """With a log directory the logger writes through whatever writer is
    installed, or only to the console, and never loads tensorflow."""
    script = (
        "import sys\n"
        "from densebox_tpu_torch.utils.logging import MetricsLogger\n"
        f"log = MetricsLogger({str(tmp_path / 'tb')!r})\n"
        "log.log(1, {'loss_total': 2.0}); log.close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tensorflow', 'jax', 'orbax'))\n"
        "print('LOADED', bad)\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
    assert "[train step 1] loss_total=2" in res.stdout
