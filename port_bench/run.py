"""Run one cell of ``BENCHMARK.json`` on this machine's card:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the numbers compared beside their limits as the last lines of
standard error, and the result as one JSON object on the last line of
standard output. Exits non-zero and prints no result when there is no CUDA
card (or fewer than the cell asks for), when a file of the cell is
missing, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from port_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (the program's own
    # nvcc builds go to densebox_tpu_torch/_build)
    cache = harness.ROOT / ".port_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    import torch

    try:
        cell = harness.cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"port_bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda"))
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: modules of {bad} were loaded", file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
