"""BASELINE config 5 in the port: data- and tensor-parallel train steps
over ``torch.distributed`` (one process per device; here CPU processes over
gloo, spawned with ``torch.multiprocessing``), against the single-device
step and against the JAX package's sharded step.

The invariant (``docs/DESIGN.md`` §3, the bars of JAX's
``tests/test_parallel.py``): a DP or DP x TP step equals the single-device
step on the same global batch, parameters within 2e-6 and loss within 1e-5.
What remains between them is the order of float32 sums (the gradient's
sum over ranks, the global norm over shards). Ranks stay bit-equal with
each other. Each spawn joins with a timeout, so a collective that hangs
fails the test instead of stalling the suite.

Tiny shapes, as ``__graft_entry__.py``'s dryrun: width 0.125, 64 px
patches, 3 box slots.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from densebox_tpu import config as jax_config
from densebox_tpu.data import synthetic_batch as jax_synthetic_batch
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.parallel import make_mesh as jax_make_mesh
from densebox_tpu.parallel import \
    make_sharded_train_step as jax_make_sharded_train_step
from densebox_tpu.train import loop as jax_loop
from densebox_tpu_torch import cli
from densebox_tpu_torch.models import DenseBox, state_from_jax
from densebox_tpu_torch.parallel import Mesh, multihost, shard_batch
from densebox_tpu_torch.parallel.multihost import run_processes
from densebox_tpu_torch.train import (create_train_state, fit,
                                      make_canvas_train_step, make_train_step)
from test_torch_ohem import kernel_uniforms
from torch_parallel_workers import (fit_rank, global_batches, tiny_cfg,
                                    train_rank)
import torch_threads  # noqa: F401  (sets torch's threads)

PARAM_BAR, LOSS_BAR = 2e-6, 1e-5        # JAX's tests/test_parallel.py
CASES = {"det": (0, False, False), "lm4_refine_canvas": (4, True, True)}


def _single(cfg, batches, canvas=False, state_dict=None, momentum=None,
            draws=None):
    """The single-device port step over the global batches."""
    model = DenseBox(cfg.model, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    if state_dict is not None:
        state.load(state_dict, momentum, 0)
    step = (make_canvas_train_step if canvas else make_train_step)(
        model, cfg, device="cpu")
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, b, draws=draws[i] if draws else None)
        metrics.append({k: float(v) for k, v in m.items()})
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            metrics)


def _spawn(tmp_path, world, fn, *args):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    run_processes(fn, world, (world, str(tmp_path / "pg"), str(out)) + args,
                  timeout=120)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def _assert_like_single(ranks, sd, metrics):
    for got in ranks:
        assert _max_diff(got["sd"], sd) < PARAM_BAR
        for g, w in zip(got["metrics"], metrics):
            assert abs(g["loss_total"] - w["loss_total"]) < LOSS_BAR
            assert g["n_sampled"] == w["n_sampled"]
            assert g["n_pos"] == w["n_pos"]
            assert set(g) == set(w)
    for got in ranks[1:]:       # every rank holds the same state
        for k in ranks[0]["sd"]:
            assert torch.equal(got["sd"][k], ranks[0]["sd"][k]), k
            assert torch.equal(got["mom"][k], ranks[0]["mom"][k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_single_device(tmp_path, case):
    lm, refine, canvas = CASES[case]
    cfg = tiny_cfg(lm, refine, batch=4)
    batches = global_batches(cfg, 1, canvas)
    ranks = _spawn(tmp_path, 2, train_rank, cfg, batches, 1, canvas)
    assert ranks[0]["mesh"] == {"data": 2, "model": 1}
    _assert_like_single(ranks, *_single(cfg, batches, canvas))


def test_dp_multi_step_stays_in_sync(tmp_path):
    cfg = tiny_cfg(batch=8)
    batches = global_batches(cfg, 3, seed=10)
    ranks = _spawn(tmp_path, 2, train_rank, cfg, batches, 1, False)
    assert all(r["step"] == 3 for r in ranks)
    assert all(np.isfinite(m["loss_total"]) for m in ranks[0]["metrics"])
    _assert_like_single(ranks, *_single(cfg, batches))


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_2x2_matches(tmp_path, case):
    lm, refine, canvas = CASES[case]
    cfg = tiny_cfg(lm, refine, batch=4)
    batches = global_batches(cfg, 2, canvas, seed=20)
    ranks = _spawn(tmp_path, 4, train_rank, cfg, batches, 2, canvas)
    assert ranks[0]["mesh"] == {"data": 2, "model": 2}
    width = cfg.model.scaled(cfg.model.head_width)
    shapes = ranks[0]["local_shapes"]
    assert shapes["det.det_conv1.weight"][0] == width // 2    # sharded
    assert shapes["det.det_conv2.weight"][1] == width         # replicated
    assert ranks[0]["sd"]["det.det_conv1.weight"].shape[0] == width
    _assert_like_single(ranks, *_single(cfg, batches, canvas))


def test_uneven_batch_rejected():
    mesh = Mesh(n_data=4, n_model=1, data_index=1, model_index=0,
                data=None, model=None)
    batch = {"image": torch.arange(16.0).reshape(8, 2)}
    assert torch.equal(shard_batch(batch, mesh)["image"],
                       batch["image"][2:4])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"image": torch.zeros(6, 2)}, mesh)


def test_fit_data_parallel_checkpoints_once_and_resumes(tmp_path):
    """fit(use_mesh=True) over 2 ranks: rank 0 alone writes the
    checkpoints and logs; a run resumed from step 4 ends bit-equal to the
    straight run; both equal the single-device fit within the bars."""
    cfg = tiny_cfg(batch=4, log_every=2, ckpt_every=2, ckpt_keep=2)
    batches = global_batches(cfg, 6, seed=30)
    out = tmp_path / "out"
    out.mkdir()

    def run(workdir, steps, tag):
        run_processes(fit_rank, 2, (2, str(tmp_path / f"pg_{tag}"), str(out),
                                    cfg, batches, str(tmp_path / workdir),
                                    steps, tag), timeout=120)
        return [torch.load(out / f"rank{r}_{tag}.pt") for r in range(2)]

    straight = run("straight", 6, "straight")
    run("resumed", 4, "first")
    resumed = run("resumed", 6, "resumed")
    assert straight[0]["ranks"] == 2
    assert straight[0]["writes"] == [2, 4, 6] and straight[1]["writes"] == []
    assert sorted(os.listdir(tmp_path / "straight" / "ckpt")) == [
        "step_00000004.pt", "step_00000006.pt"]
    assert "[train step 6]" in straight[0]["printed"]
    assert straight[1]["printed"] == ""
    assert "resumed from step 4" in resumed[0]["printed"]
    assert resumed[1]["printed"] == ""
    for a, b in zip(straight, resumed):
        for k in a["sd"]:
            assert torch.equal(a["sd"][k], b["sd"][k]), k
            assert torch.equal(a["mom"][k], b["mom"][k]), k
        assert a["last"]["loss_total"] == b["last"]["loss_total"]
    single = fit(cfg, lambda s: batches[s], None, num_steps=6,
                 sample_from_canvas=False, device="cpu")
    want = single.state.model.state_dict()
    assert _max_diff(straight[0]["sd"], want) < PARAM_BAR
    assert abs(straight[0]["last"]["loss_total"]
               - single.last_metrics["loss_total"]) < LOSS_BAR


def test_fit_disables_dp_when_the_batch_does_not_divide(tmp_path):
    cfg = tiny_cfg(batch=3, log_every=2, ckpt_every=2)
    batches = global_batches(cfg, 2, seed=40)
    out = tmp_path / "out"
    out.mkdir()
    run_processes(fit_rank, 2, (2, str(tmp_path / "pg"), str(out), cfg,
                                batches, str(tmp_path / "w"), 2, "odd"),
                  timeout=120)
    ranks = [torch.load(out / f"rank{r}_odd.pt") for r in range(2)]
    assert ranks[0]["ranks"] == 1
    assert "DP mesh disabled: global batch 3 not divisible by 2" in \
        ranks[0]["printed"]
    assert ranks[1]["printed"] == ""
    assert ranks[0]["writes"] == [2] and ranks[1]["writes"] == []
    single = fit(cfg, lambda s: batches[s], None, num_steps=2,
                 sample_from_canvas=False, device="cpu")
    for r in ranks:
        assert _max_diff(r["sd"], single.state.model.state_dict()) < PARAM_BAR


def test_port_dp_step_matches_jax_sharded_step(tmp_path):
    """The port's DP 2 step against JAX's ``make_sharded_train_step`` on a
    2-device CPU mesh, jitted, from the same parameters with the same OHEM
    uniforms (rebuilt from JAX's key chain). Dropout is off: under jit the
    key ``fused_relu_dropout`` receives cannot be captured. Bars of
    ``tests/test_torch_train_step.py``: loss 1e-5 relative, parameters 1e-5
    absolute (JAX's jit contracts some products and sums into FMAs, which
    the port rounds apart)."""
    b, k = 4, 3
    model_kw = dict(width_mult=0.125, dropout_rate=0.0)
    label_kw = dict(patch_size=64, std_height_px=20.0)
    train_kw = dict(batch_size=b, learning_rate=1e-2, max_boxes=k)
    ref = jax_config.DenseBoxConfig(
        model=jax_config.ModelCfg(**model_kw),
        label=jax_config.LabelCfg(**label_kw),
        train=jax_config.TrainCfg(**train_kw))
    cfg = tiny_cfg(batch=b, dropout=0.0)
    jmodel = JaxDenseBox(ref.model)
    batch = jax_synthetic_batch(jax.random.key(0), b, ref.label, max_boxes=k)
    jstate = jax_loop.create_train_state(jmodel, ref, batch["image"][:1])
    mesh = jax_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    step, place_state, place_batch = jax_make_sharded_train_step(
        jmodel, ref, mesh, jstate)
    jnew, jm = step(place_state(jstate), place_batch(batch))

    sd, mom, _ = state_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.opt_state[-1][0].trace), 0, cfg.model)
    step_key = jax.random.fold_in(jstate.key, jstate.step)
    k_cls, _ = jax.random.split(jax.random.split(step_key)[1])
    draws = [{"ohem_score": torch.from_numpy(
        kernel_uniforms(k_cls, b, cfg.label.map_size ** 2))}]
    tb = [{kk: torch.from_numpy(np.array(v)) for kk, v in batch.items()}]
    ranks = _spawn(tmp_path, 2, train_rank, cfg, tb, 1, False, sd, mom,
                   draws)
    want, _, _ = state_from_jax(jax.tree.map(np.asarray, jnew.params),
                                jax.tree.map(np.asarray, jnew.params), 1,
                                cfg.model)
    for got in ranks:
        m = got["metrics"][0]
        assert m["n_sampled"] == float(jm["n_sampled"])
        assert m["n_pos"] == float(jm["n_pos"])
        np.testing.assert_allclose(m["loss_total"], float(jm["loss_total"]),
                                   rtol=1e-5)
        for name in want:
            np.testing.assert_allclose(got["sd"][name].numpy(),
                                       want[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


def test_ensure_distributed_env_resolution(monkeypatch):
    """torchrun's variables > nothing; explicit arguments beat them; one
    init; a second call that matches is a no-op, one that conflicts
    raises."""
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.ensure_distributed(device="cpu")
    assert calls == [{"backend": "gloo", "init_method": "env://",
                      "world_size": 4, "rank": 2}]
    assert multihost.local_device() == torch.device("cuda", 1)
    assert multihost.default_backend() == "nccl"
    assert multihost.default_backend("cuda:1") == "nccl"

    multihost.ensure_distributed(backend="gloo", rank=0, world_size=2,
                                 init_method="file:///x")
    assert calls[1]["rank"] == 0 and calls[1]["world_size"] == 2
    assert calls[1]["init_method"] == "file:///x"

    # the group is up: a matching request is a no-op, a conflicting one
    # raises
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(multihost.dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 2)
    assert multihost.ensure_distributed(device="cpu")
    assert len(calls) == 2
    with pytest.raises(RuntimeError, match="backend 'gloo'.*'nccl'"):
        multihost.ensure_distributed(backend="nccl")
    with pytest.raises(RuntimeError, match="world size 4"):
        multihost.ensure_distributed(device="cpu", world_size=8)
    assert not multihost.is_primary()
    assert multihost.world_size() == 4


def test_ensure_distributed_noop_without_torchrun(monkeypatch):
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")       # not read
    assert not dist.is_initialized()
    assert multihost.ensure_distributed() is False
    assert calls == []
    assert multihost.is_primary() and multihost.world_size() == 1
    assert multihost.local_device() == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="RANK"):
        multihost.ensure_distributed(world_size=2)


def test_cli_joins_the_group_before_anything_else(monkeypatch):
    seen = []
    monkeypatch.setattr(multihost, "ensure_distributed",
                        lambda **kw: seen.append(kw))
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    with pytest.raises(SystemExit):      # detect runs as one process
        cli.main(["detect", "--workdir", "w", "--image", "a.png",
                  "--device", "cpu"])
    assert seen == [{"device": "cpu"}]
