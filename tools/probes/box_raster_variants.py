#!/usr/bin/env python3
"""Time variants of the box rasterizer's kernel side by side on a CUDA card.

    python3 tools/probes/box_raster_variants.py      # from the repository root

Builds ``box_raster_variants.cu`` (beside this file) with nvcc for sm_90a
into the port's build directory, runs every variant at the training shape
(B=32, K=16, M=60; the rows of ``chip_smoke.py`` phase 17), holds each
against ``rasterize_boxes_reference`` bit for bit (the two floors skip work
and are not compared), and prints, twice, a dict of variant -> (device time
in microseconds by ``chip_smoke.py:device_ms``, equal). See the source for
what each variant is. Without a CUDA card it exits 1 and prints no result.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# variant number in the source's switch -> name
VARIANTS = {
    0: "pixel a thread, all rows staged", 1: "+ dy2 skip",
    8: "floor: launch and stores", 7: "floor: launch, load and stores",
    2: "128 threads", 3: "512 threads", 15: "1024 threads",
    13: "dy2 skip, 128 threads",
    4: "shuffles, 1 px", 6: "shuffles, 2 px", 5: "shuffles, 4 px",
    9: "shuffles, 1 px, 128 threads", 10: "shuffles, 2 px, 128 threads",
    11: "shuffles, 4 px, 128 threads", 14: "shuffles, 4 px, 64 threads",
    16: "float4 rows, index kept", 17: "float4 rows, dy2 skip",
    18: "2 px in sequence", 19: "2 px in sequence, dy2 skip",
    20: "4 px in sequence, dy2 skip", 24: "8 px in sequence, 128 threads",
    30: "4 rows a step", 31: "8 rows a step", 38: "8 rows a step, 128 threads",
    41: "16 rows a step, 128 threads",
    32: "rows over 2 threads", 33: "rows over 2 threads, 4 rows a step",
    34: "rows over 4 threads", 36: "rows over 4 threads, 4 rows a step",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("box_raster_variants: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from densebox_tpu_torch.ops.kernels import build
    from densebox_tpu_torch.ops.kernels import labels as kl

    build.BUILD_DIR.mkdir(exist_ok=True)
    lib = build.BUILD_DIR / "libbox_raster_variants.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    os.path.join(HERE, "box_raster_variants.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).exp_boxes
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    print(smoke.card_line(), flush=True)
    _, b, k, m, num_lm = smoke.RASTER_CASES[0]
    rows = torch.from_numpy(smoke.label_rows(
        np.random.RandomState(17), b, k, m, num_lm)[0]).cuda()
    inv = float(np.float32(0.08))
    want = kl.rasterize_boxes_reference(rows, m, inv)
    score = torch.empty((b, m, m, 1), device="cuda")
    ignore = torch.empty_like(score)
    loc = torch.empty((b, m, m, 4), device="cuda")
    for _ in range(2):
        out = {}
        for variant, name in VARIANTS.items():
            def launch():
                rc = fn(variant, rows.data_ptr(), score.data_ptr(),
                        loc.data_ptr(), ignore.data_ptr(), b, k, m, inv,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"variant {variant}: CUDA error {rc}")
            launch()
            torch.cuda.synchronize()
            equal = variant in (7, 8) or all(
                smoke.bits_equal(g, w)
                for g, w in zip((score, loc, ignore), want))
            out[name] = (round(smoke.device_ms(launch) * 1e3, 3), equal)
        smoke.emit({"probe": "box_raster_variants", "shape": [b, k, m],
                    "device_us_and_equal": out})
    return 0


if __name__ == "__main__":
    sys.exit(main())
