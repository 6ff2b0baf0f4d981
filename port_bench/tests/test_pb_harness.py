"""The harness: found by name, data-driven, and free of the JAX package."""

import ast
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from port_bench import harness
from port_bench.traffic.arrivals import poisson_due, scene_order

FORBIDDEN = set(harness.FORBIDDEN)


def test_catalog_finds_every_name_of_the_benchmark():
    bench = harness.benchmark()
    found = harness.catalog()
    assert found["workloads"] == [w["name"] for w in bench["workloads"]]
    assert found["configs"] == [c["name"] for c in bench["configs"]]
    assert found["metrics"] == [m["name"] for m in bench["per_layer"]]


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in harness.benchmark()["workloads"]:
        c = harness.cell(w["name"])
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        # an exact comparison (rank_gap) has the limit 0
        assert c.spec["limits"] and all(
            isinstance(v, float) and v >= 0
            for v in c.spec["limits"].values())


def test_a_new_cell_config_and_metric_are_found_by_their_files(tmp_path):
    """A later cell brings only new files and entries: a copy of the
    folder with a new configuration, mix, cell and metric lists them, and
    no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*")
              if p.is_file()}
    bench = harness.benchmark()
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "kitti_vehicle.json").read_text())
    cfg["name"] = "kitti_vehicle_w05"
    cfg["config"]["model"]["width_mult"] = 0.5
    (pb / "configs" / "kitti_vehicle_w05.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "mixes" / "offline_b64.json").read_text())
    mix["batch"] = 16
    (pb / "mixes" / "offline_b16.json").write_text(json.dumps(mix))
    (pb / "workloads" / "w05_int8_offline.json").write_text(
        (pb / "workloads" / "kitti_int8_offline.json").read_text())
    (pb / "metrics" / "calls.offline.py").write_text(
        "def read(ctx):\n    return float(ctx['calls'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="kitti_vehicle_w05",
                                 file="port_bench/configs/"
                                      "kitti_vehicle_w05.json"))
    bench["workloads"].append({"name": "w05_int8_offline",
                               "config": "kitti_vehicle_w05",
                               "traffic": "offline_b16", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "calls.offline", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "detect call",
                               "moves": "images_per_s",
                               "workloads": ["w05_int8_offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    found = harness.catalog(root)
    assert "w05_int8_offline" in found["workloads"]
    assert "kitti_vehicle_w05" in found["configs"]
    assert "offline_b16" in found["traffic"]
    assert "calls.offline" in found["metrics"]
    c = harness.cell("w05_int8_offline", root)
    assert c.traffic["batch"] == 16
    assert c.config["config"]["model"]["width_mult"] == 0.5
    assert [m["name"] for m in c.per_layer] == ["calls.offline"]
    assert harness.reader("calls.offline", root)({"calls": 3}) == 3.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in (harness.ROOT / "port_bench").rglob("*.py")
                 if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.ROOT))
                              for p in SOURCES])
def test_the_harness_names_no_jax_module(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "port_bench" / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "densebox_tpu_torch" not in names, path
        assert not names & FORBIDDEN, path
    # nor does anything the reference imports in turn
    code = ("import sys, port_bench.reference.model, "
            "port_bench.reference.detect, port_bench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert "densebox_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_run_refuses_without_a_card_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "kitti_int8_offline", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_refuses_an_unknown_cell():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "nope",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        cwd=harness.ROOT)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_every_seed_offers_the_same_arrivals_in_another_order():
    a = poisson_due(150.0, 20.0, np.random.default_rng(1))
    b = poisson_due(150.0, 20.0, np.random.default_rng(2**33 + 7))
    assert len(a) == len(b) == 3000 and a[0] == b[0] == 0.0
    # n - 1 gaps of one set of n quantiles, shuffled
    shared = np.intersect1d(np.round(np.diff(a), 12), np.round(np.diff(b), 12))
    assert len(shared) >= len(a) - 5
    assert not np.allclose(np.diff(a), np.diff(b))
    assert abs(a[-1] - 20.0) < 1.0
    s = scene_order(3000, 256, np.random.default_rng(3))
    assert np.bincount(s, minlength=256).min() >= 11


def test_subseed_takes_large_seeds_and_separates_streams():
    big = 2**31 + 12345
    assert harness.subseed(big, "a") != harness.subseed(big, "b")
    assert harness.subseed(big, "a") == harness.subseed(big, "a")
    assert 0 <= harness.subseed(2**40, "weights") < 2**63
