"""Finds a cell's files by the names ``BENCHMARK.json`` gives, runs its
driver and builds the result line.

A cell ``<name>`` of ``BENCHMARK.json`` is made of:

* ``port_bench/workloads/<name>.json``: what the cell runs the program at
  (precision, calibration, how many answers are compared) and the limit of
  each number compared;
* its configuration's ``file`` (``port_bench/configs/<config>.json``): the
  model and detector configuration as run, its source and what it assumed;
* ``port_bench/mixes/<traffic>.json``: the traffic mix, whose ``mode``
  names the driver ``port_bench/drivers/<mode>.py``;
* ``port_bench/metrics/<metric>.py`` for each per-layer metric, a reader
  ``read(ctx) -> float | None`` of what the driver recorded.

A later cell, configuration, mix or metric is a new file beside these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import zlib
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
# top-level module names no run may hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "densebox_tpu")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run (weights, scenes, order...)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) % 2**64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % 2**64
    return (x ^ (x >> 31)) >> 1


def process_age_s() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the cell's entry of BENCHMARK.json
    spec: dict            # port_bench/workloads/<name>.json
    config: dict          # its configuration's file
    traffic: dict         # port_bench/mixes/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _by_name(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = _by_name(bench["workloads"], name, "workload")
    cfg = _by_name(bench["configs"], entry["config"], "config")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    pkg = root / "port_bench"
    return Cell(name, entry, _load(pkg / "workloads" / f"{name}.json"),
                _load(root / cfg["file"]),
                _load(pkg / "mixes" / f"{entry['traffic']}.json"),
                e2e, per_layer, root)


def _module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The per-layer metric's ``read(ctx)``."""
    return _module(root / "port_bench" / "metrics" / f"{name}.py",
                   f"port_bench_metric_{name}").read


def driver(mode: str, root: Path = ROOT):
    return _module(root / "port_bench" / "drivers" / f"{mode}.py",
                   f"port_bench_driver_{mode}")


def catalog(root: Path = ROOT) -> Dict[str, List[str]]:
    """Every name of ``BENCHMARK.json`` with the file it was found by;
    raises where one is missing."""
    bench = benchmark(root)
    out = {"workloads": [], "configs": [], "traffic": [], "metrics": []}
    for c in bench["configs"]:
        if not (root / c["file"]).is_file():
            raise FileNotFoundError(c["file"])
        out["configs"].append(c["name"])
    for w in bench["workloads"]:
        c = cell(w["name"], root)
        driver(c.traffic["mode"], root)
        out["workloads"].append(w["name"])
        if w["traffic"] not in out["traffic"]:
            out["traffic"].append(w["traffic"])
    for m in bench["per_layer"]:
        reader(m["name"], root)
        out["metrics"].append(m["name"])
    return out


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: counts, the end-to-end values, what the
    per-layer readers read (``ctx``), the numbers compared and the
    device's readings.

    ``count`` cards: ``memory_peak_bytes`` is the fullest card's peak and
    ``traces`` holds one trace ``Summary`` a card (None without a trace).
    The line's busy time and window are the cards' means, and its
    breakdown, like the readers' ``ctx["trace"]``, is that of the card busy
    longest; the readers find every card's in ``ctx["traces"]``."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    ctx: dict
    numbers: Dict[str, float]
    memory_peak_bytes: int
    device_kind: str
    traces: list = dataclasses.field(default_factory=list)
    count: int = 1


def merged(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested groups merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, overrides: Optional[dict] = None) -> dict:
    """Run one cell and return its result line (a dict). ``overrides``
    (tests) replace keys of the cell's files: ``config``, ``traffic``,
    ``spec``."""
    c = cell(name, root)
    over = overrides or {}
    c.config = merged(c.config, over.get("config"))
    c.traffic = merged(c.traffic, over.get("traffic"))
    c.spec = merged(c.spec, over.get("spec"))
    res: Outcome = driver(c.traffic["mode"], root).run(
        c, int(seed), float(seconds), bool(trace), device)
    return result_line(c, res, bool(trace), root)


def result_line(c: Cell, res: Outcome, trace: bool, root: Path = ROOT
                ) -> dict:
    """The result line of a driver's ``Outcome``: the cell's end-to-end
    metrics, or with ``trace`` its per-layer ones, the device, and the
    numbers compared beside their limits (``checks``, last)."""
    from port_bench.reference.compare import judge

    correct, checks = judge(res.numbers, c.spec["limits"])
    traces = [t for t in res.traces if t is not None]
    summ = max(traces, key=lambda t: t.busy_s()) if traces else None
    metrics = {}
    wanted = c.per_layer if trace else c.end_to_end
    for m in wanted:
        v = (reader(m["name"], root)(dict(res.ctx, trace=summ,
                                          traces=traces)) if trace
             else res.end_to_end.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": res.device_kind, "count": res.count,
           "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": dev}
    if trace and summ is not None:
        dev["busy_s"] = sum(t.busy_s() for t in traces) / len(traces)
        dev["window_s"] = sum(t.window_s for t in traces) / len(traces)
        line["breakdown"] = summ.breakdown()
    line["checks"] = checks
    return line


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
