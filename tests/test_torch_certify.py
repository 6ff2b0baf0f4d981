"""The port's quality certification (``densebox_tpu_torch/certify.py``) against
the JAX repository's ``tools/certify_quality.py`` and
``tools/probes/nme_dist.py``, on the CPU.

The JAX tools are read, never imported or run (they train on the TPU): their
config rows and command flags come from the source through ``ast``. The
landmark error distribution is held to ``nme_dist.py``'s arithmetic over the
JAX package's ``cli._match_landmarks`` on the same seeded numpy detections.
Then the tool's functions run end to end at a tiny size (width 0.125, 2
train steps at batch 2 on 256 px canvases, one eval batch), one det-only
and one four-landmark row.
"""

import ast
import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from densebox_tpu import cli as jax_cli
from densebox_tpu_torch import certify
import torch_threads  # noqa: F401  (sets torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "certify_quality.py")


def _jax_tool():
    return ast.parse(open(JAX_TOOL).read(), JAX_TOOL)


def _strings(node):
    """The string constants of a list literal, in order."""
    return [e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)]


def _jax_lists():
    """(CONFIGS, {landmarks: train flags}, train command's strings, eval
    command's strings) of the JAX tool."""
    configs, lm_flags, train, evals = None, {}, None, None
    for node in ast.walk(_jax_tool()):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name == "CONFIGS":
                configs = ast.literal_eval(node.value)
            elif name == "cmd" and isinstance(node.value, ast.List):
                if "train" in _strings(node.value):
                    train = _strings(node.value)
                elif "eval" in _strings(node.value):
                    evals = _strings(node.value)
        elif isinstance(node, ast.If) and isinstance(node.test, ast.Compare) \
                and getattr(node.test.left, "id", None) == "lm":
            n = node.test.comparators[0].value
            lm_flags[n] = ast.literal_eval(node.body[0].value)
            if node.orelse and isinstance(node.orelse[0], ast.If):
                inner = node.orelse[0]
                lm_flags[inner.test.comparators[0].value] = \
                    ast.literal_eval(inner.body[0].value)
    return configs, lm_flags, train, evals


def test_configs_and_flags_equal_the_jax_tool():
    configs, lm_flags, train, evals = _jax_lists()
    assert certify.CONFIGS == configs
    assert certify.LM_FLAGS == lm_flags == {
        4: ["--lm-flip-perm", "1,0,3,2", "--lm-anchors", "0,0,1,0,1,1,0,1"],
        5: ["--lm-flip-perm", "1,0,2,4,3"]}
    # every fixed string of the JAX tool's commands, in order, with the
    # port's command line in place of the JAX package's
    for port_cmd, jax_strings in (
            (certify.train_command(configs[2], "W", 1500, "cuda"), train),
            (certify.eval_command("W", True, 8, "cuda"), evals + ["--quantize"])):
        want = ["densebox_tpu_torch.cli" if s == "densebox_tpu.cli" else s
                for s in jax_strings]
        it = iter(port_cmd)
        assert all(s in it for s in want), (want, port_cmd)
    assert certify.train_command(configs[2], "W", 1500, "cuda")[-4:] == \
        lm_flags[4]


def test_defaults_equal_the_jax_tool_and_out_is_outside_the_repo():
    """--steps 1500 and --eval-batches 8 as the JAX tool; the work root lies
    in the temporary directory and no report path points into the
    repository; an unknown config name is refused."""
    defaults = {}
    for node in ast.walk(_jax_tool()):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            if isinstance(kw.get("default"), ast.Constant):
                defaults[node.args[0].value] = kw["default"].value
    args = certify.parser().parse_args([])
    assert (args.steps, args.eval_batches) == (
        defaults["--steps"], defaults["--eval-batches"]) == (1500, 8)
    assert args.out is None and args.device is None
    assert args.workroot.startswith(tempfile.gettempdir())
    assert not os.path.abspath(args.workroot).startswith(REPO)
    with pytest.raises(SystemExit):
        certify.main(["--device", "cpu", "--configs", "nope"])


def _seeded_detections(seed=3, b=3, k=6, d=10, num_lm=4):
    """Detections near (and some far from) seeded GT boxes, with landmarks,
    decode masks and GT visibility, as numpy."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (b, k, 2))
    wh = rng.uniform(20, 60, (b, k, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gt_valid = rng.rand(b, k) < 0.8
    gt_valid[:, 0] = True
    gt_lm = (xy[:, :, None] + rng.uniform(0, 1, (b, k, num_lm, 2))
             * wh[:, :, None]).astype(np.float32)
    src = rng.randint(0, k, (b, d))
    near = np.take_along_axis(gt, src[..., None], 1)
    boxes = (near + rng.normal(0, 3, near.shape)).astype(np.float32)
    far = rng.rand(b, d) < 0.25
    boxes[far] += 150.0
    lm = (np.take_along_axis(gt_lm, src[..., None, None], 1)
          + rng.normal(0, 6, (b, d, num_lm, 2))).astype(np.float32)
    dets = {"boxes": boxes, "valid": rng.rand(b, d) < 0.85,
            "lm_points": lm, "lm_valid": rng.rand(b, d, num_lm) < 0.9}
    batch = {"boxes": gt, "box_valid": gt_valid, "landmarks": gt_lm,
             "lm_valid": rng.rand(b, k, num_lm) < 0.85}
    return dets, batch


def _nme_dist_arithmetic(matches):
    """``tools/probes/nme_dist.py`` lines 27-40, without the rounding of its
    prints, over the matches of the JAX package's ``_match_landmarks``."""
    errs = []
    for pred, gt, h, vis in matches:
        e = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1) / h
        e = np.where(np.asarray(vis), e, np.nan)
        errs.append(e)
    errs = np.stack(errs)
    flat = errs.ravel()
    flat = flat[~np.isnan(flat)]
    out = {"n": flat.size, "mean": float(flat.mean())}
    for q in (50, 75, 90, 95, 99):
        out[f"p{q}"] = float(np.percentile(flat, q))
    out["frac_gt_0.25"] = float((flat > 0.25).mean())
    out["frac_gt_0.5"] = float((flat > 0.5).mean())
    out["per_landmark_mean"] = np.nanmean(errs, axis=0).tolist()
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_nme_distribution_equals_nme_dist(seed):
    dets, batch = _seeded_detections(seed)
    want = _nme_dist_arithmetic(jax_cli._match_landmarks(dets, batch))
    got = certify.nme_stats(certify.landmark_errors(
        {k: torch.from_numpy(v) for k, v in dets.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert want["n"] > 20 and 0 < want["frac_gt_0.25"] < 1
    assert set(got) == set(want) and got["n"] == want["n"]
    for key in certify.STATS:
        assert abs(got[key] - want[key]) <= 1e-6, key
    np.testing.assert_allclose(got["per_landmark_mean"],
                               want["per_landmark_mean"], rtol=0, atol=1e-6)


def test_nme_stats_without_matches():
    out = certify.nme_stats([])
    assert out["n"] == 0 and all(out[k] is None for k in certify.STATS)


TINY = [("tiny-s2d2-w0.125", "s2d", 3, 0.125, 0),
        ("tiny-s2d2-w0.125-lm4", "s2d", 3, 0.125, 4)]


def test_tiny_certification_end_to_end(tmp_path, monkeypatch, capsys):
    """``main`` over two tiny rows on the CPU: each trains (2 steps, batch
    2, 64 px patches from 256 px canvases), evaluates bf16 and int8 and,
    for the landmark row, adds both distributions; one JSON row per config
    on standard output with finite APs; the report has the JAX table's
    columns."""
    real_train = certify.train_command

    def tiny_train(row, workdir, steps, device, batch_size=32):
        return real_train(row, workdir, steps, device, batch_size=2) + [
            "--patch-size", "64", "--std-height", "20"]

    monkeypatch.setattr(certify, "CONFIGS", TINY)
    monkeypatch.setattr(certify, "train_command", tiny_train)
    monkeypatch.setattr(certify, "NME_BATCHES", 1)
    out = tmp_path / "CERT.md"
    assert certify.main(["--steps", "2", "--eval-batches", "1", "--device",
                         "cpu", "--workroot", str(tmp_path / "w"),
                         "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu" and lines[-1] == f"wrote {out}"
    rows = [json.loads(ln) for ln in lines[1:-1]]
    assert [r["config"] for r in rows] == [r[0] for r in TINY]
    for r in rows:
        assert r["steps"] == 2 and r["card"] == "cpu"
        for key in ("bf16", "int8_ptq"):
            assert math.isfinite(r[key]["ap@0.50"]) and r[key]["n_images"] == 8
        assert r["delta_ap"] == r["int8_ptq"]["ap@0.50"] - r["bf16"]["ap@0.50"]
        assert set(r["seconds"]) >= {"train", "eval_bf16", "eval_int8_ptq",
                                     "row"}
    assert "nme_dist" not in rows[0]
    assert set(rows[1]["nme_dist"]) == {"bf16", "int8"}
    assert "landmark_nme" not in rows[0]["bf16"]
    report = out.read_text()
    header = next(ln for ln in open(os.path.join(REPO, "docs", "QUALITY.md"))
                  if ln.startswith("| config |"))
    assert header.strip() in report.splitlines()
    assert all(r[0] in report for r in TINY)
    assert os.path.exists(tmp_path / "w" / f"{TINY[1][0]}.log")
