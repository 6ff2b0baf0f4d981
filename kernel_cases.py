"""The port's kernels' cases and bounds: the inputs at which the gpu-marked
tests (``tests/test_torch_kernels.py``, ``tests/test_torch_nms_schedule.py``,
``tests/test_torch_labels.py``), ``chip_smoke.py``'s kernels phase and
``profile_port.py`` call each kernel, and the least time the card could take
for each call.

Data only: it imports numpy at the top and torch and the port inside its
functions, and neither script. A bound is the larger of the bytes over the
memory rate and the operations over the peak rate of their type, from the
published peaks of an H100 SXM (``bound``).
"""

from __future__ import annotations

import numpy as np

# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): the
# yardsticks of ``bound``
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str = "f32"):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the peak rate
    of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")



# --- each kernel's bound at a call ---------------------------------------------

def qconv_bound(b, h, w, cin, cout, k, f32_out=False):
    """``qconv_int8`` with int8 codes in: the input, the weights, three float
    vectors and the output (int8 codes, or float32 from the heads' conv2)
    once; two int8 operations per multiply-add."""
    return bound(b * h * w * (cin + cout * (4 if f32_out else 1))
                 + cout * k * k * cin + 12 * cout,
                 2 * b * h * w * cin * cout * k * k, "int8")


def requant_bound(n, cout, f32_out=False):
    """``requant_epilogue`` over ``n`` int32 accumulators of ``cout``
    channels: int8 or float32 out, three float vectors; five float
    operations an element."""
    return bound(n * (4 + (4 if f32_out else 1)) + 12 * cout, n * 5)


def neck_bound(levels):
    """A call of ``int8_neck`` over ``levels`` ((f3, f4) pairs): f3 codes and
    f4 in float32 read, 256 + 512 codes written a position; per code written
    at most eight float operations (the upsample's two products and sum in
    each direction, the quantise). Returns (bound_ms, bound_by, bytes)."""
    n_out = sum(f3.numel() * 3 for f3, _ in levels)
    nbytes = sum(f3.numel() * 4 + f4.numel() * 4 for f3, f4 in levels)
    return bound(nbytes, n_out * 8) + (nbytes,)


def window_bound(b, num_lm, d, win):
    """``gather_windows`` of ``d`` detections a sample in bf16: the windows
    read and written, and the int32 indices."""
    return bound(2 * b * d * num_lm * win * win * 2
                 + b * d * (1 + 2 * num_lm) * 4, 0)


def ohem_bound(b, p):
    """``ohem_select`` over ``b`` x ``p`` pixels: 10 bytes read and 1 written
    a pixel; three 40-step bisections, each step one compare and one add a
    pixel."""
    return bound(b * p * 11, b * p * 3 * 40 * 2)


def rasterizer_bounds(rows, lm_rows, m, num_lm):
    """(box, landmark) bounds of the two rasterizers on these rows: the box
    kernel tests every pixel against the rows that can be positive or gray
    (12 operations each), the landmark kernel the pixels within a disc's
    reach for each row with r2 >= 0 (7 operations each); both write every
    output once."""
    b = rows.shape[0]
    live = int(((rows[..., 2] >= 0) | (rows[..., 3] >= 0)).sum())
    lm_live = lm_rows[lm_rows[..., 2] >= 0]
    lm_tests = float(((2 * lm_live[:, 2].sqrt().ceil() + 1) ** 2).sum())
    return (bound(rows.numel() * 4 + b * m * m * 6 * 4, live * m * m * 12),
            bound(lm_rows.numel() * 4 + b * m * m * num_lm * 4, lm_tests * 7))


# --- the kernels' cases --------------------------------------------------------

def random_case(rng, b, k):
    """Clustered boxes (many overlaps) with score ties and invalid slots."""
    ctr = rng.uniform(0, 640, (b, k, 2)) * np.array([1.0, 0.75])
    ctr = np.round(ctr / 40) * 40 + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(8, 120, (b, k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (b, k)), 2).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.15
    return boxes, scores, valid


def threshold_case(rng, b, k, integer_frac=0.5):
    """Pairs whose IoU is 0.5 in exact arithmetic: integer pairs where f32
    gives exactly 0.5 (kept), and float pairs shifted by a third of their
    width, which f32 rounds to either side of 0.5."""
    n = k // 2
    x = rng.uniform(0, 600, (b, n)).astype(np.float32)
    y = rng.uniform(0, 400, (b, n)).astype(np.float32)
    w = rng.uniform(6, 90, (b, n)).astype(np.float32)
    h = rng.uniform(6, 90, (b, n)).astype(np.float32)
    integer = rng.uniform(size=(b, n)) < integer_frac
    x, y, w, h = (np.where(integer, np.round(v), v) for v in (x, y, w, h))
    w = np.where(integer, 3 * np.maximum(np.round(w / 3), 1), w)
    a = np.stack([x, y, x + w, y + h], -1)
    s = (w / 3).astype(np.float32)       # IoU(a, a + s) = (w-s)/(w+s) = 1/2
    p = np.stack([x + s, y, x + w + s, y + h], -1)
    boxes = np.stack([a, p], 2).reshape(b, 2 * n, 4)
    if k > 2 * n:
        boxes = np.concatenate([boxes, np.zeros((b, k - 2 * n, 4))], 1)
    scores = np.linspace(1.0, 0.0, k, dtype=np.float32)[None].repeat(b, 0)
    return boxes.astype(np.float32), scores, np.ones((b, k), bool)


NMS_SETS = ("random", "disjoint", "identical", "chain", "threshold",
            "interleaved_invalid", "all_invalid")
# (B, K) of the NMS calls timed: serving at B=8, the bench's turbo and paper
NMS_SHAPES = ((8, 256), (8, 512), (8, 1024), (256, 256), (64, 512))


def nms_set(name, b, k, seed=0):
    """(boxes (B, K, 4) f32 in score order, valid (B, K) bool) of one of the
    NMS kernel's test sets (``NMS_SETS``): ``random_case``; no two boxes
    overlapping (all kept); one box K times (the first kept); a chain of
    10-pixel boxes 2 pixels apart, each suppressing the next (IoU 2/3) and
    not the one after (3/7), so every other box stays and the greedy order
    is one chain K long; ``threshold_case`` (pairs at IoU 0.5); the chain
    with every third box invalid; and every box invalid."""
    rng = np.random.RandomState(seed)
    if name in ("random", "all_invalid"):
        boxes, _, valid = random_case(rng, b, k)
        return boxes, valid & (name == "random")
    if name == "threshold":
        boxes, _, valid = threshold_case(rng, b, k)
        return boxes, valid
    n = np.arange(k, dtype=np.float32)
    y = rng.randint(0, 400, (b, 1)).astype(np.float32) + 0 * n
    step = {"disjoint": 4, "identical": 0}.get(name, 2)
    x = rng.randint(0, 100, (b, 1)).astype(np.float32) + step * n
    size = 2 if name == "disjoint" else 10
    boxes = np.stack([x, y, x + size, y + size], -1).astype(np.float32)
    valid = np.ones((b, k), bool)
    if name == "interleaved_invalid":
        valid[:, 1::3] = False
    return boxes, valid


def nms_bound(valid):
    """(bound_ms, bound_by) of one ``greedy_keep`` call: boxes and flags in,
    the keep mask out, and 16 float operations for the IoU test of each pair
    of valid boxes (the kernel tests no other pair)."""
    b, k = valid.shape
    n = valid.sum(1).astype(np.float64)
    return bound(b * k * (16 + 1 + 1), float((n * (n - 1) / 2).sum()) * 16)


# (name, B, H, W, Cin, Cout, k): every int8 conv shape of the turbo model at
# the serving batch (trunk at 120x160 and, after the pool, 60x80; the heads'
# 1x1 convs), then kitti's offline launches at B=64 (the warpgroup variant)
QCONV_CASES = [
    ("turbo_conv1_1", 8, 120, 160, 48, 16, 3),
    ("turbo_conv1_2", 8, 120, 160, 16, 16, 3),
    ("turbo_conv2_1", 8, 120, 160, 16, 32, 3),
    ("turbo_conv2_2", 8, 120, 160, 32, 32, 3),
    ("turbo_conv3_1", 8, 120, 160, 32, 64, 3),
    ("turbo_conv3_2", 8, 120, 160, 64, 64, 3),
    ("turbo_conv4_1", 8, 60, 80, 64, 128, 3),
    ("turbo_conv4_2", 8, 60, 80, 128, 128, 3),
    ("turbo_head_conv1", 8, 120, 160, 192, 128, 1),
    ("turbo_det_conv2", 8, 120, 160, 128, 1, 1),
    ("turbo_loc_conv2", 8, 120, 160, 128, 4, 1),
    ("kitti_conv2_2", 64, 240, 320, 128, 128, 3),
    ("kitti_conv3_2", 64, 120, 160, 256, 256, 3),
    ("kitti_conv4_2", 64, 60, 80, 512, 512, 3),
    ("kitti_head_conv1", 64, 120, 160, 768, 512, 1),
]
KITTI_OFFLINE = ("kitti_conv2_2", "kitti_conv3_2", "kitti_conv4_2",
                 "kitti_head_conv1")
# how often a device call of the turbo int8 model launches each turbo shape
# (conv3_2 = conv3_3, conv4_2 = conv4_3, det and loc conv1): 14 in all; the
# output mode it runs in is the model's (f32 from the heads' conv2)
TURBO_LAUNCHES = {"turbo_conv1_1": 1, "turbo_conv1_2": 1, "turbo_conv2_1": 1,
                  "turbo_conv2_2": 1, "turbo_conv3_1": 1, "turbo_conv3_2": 2,
                  "turbo_conv4_1": 1, "turbo_conv4_2": 2,
                  "turbo_head_conv1": 2, "turbo_det_conv2": 1,
                  "turbo_loc_conv2": 1}


def qconv_inputs(rng, b, h, w, cin, cout, k, dev):
    """Int8 activations and weights over the whole code range, and epilogue
    vectors that put y at a few units, so that int8 outputs round and
    clip."""
    import torch

    x = rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    spread = 127.0 * 127.0 * np.sqrt(k * k * cin)
    vecs = [rng.uniform(1.0, 3.0, cout) / spread, rng.uniform(-0.5, 0.5, cout),
            rng.uniform(20.0, 40.0, cout)]
    return [torch.from_numpy(a).to(dev)
            for a in [x, wq] + [v.astype(np.float32) for v in vecs]]


def neck_levels(b, seed):
    """The int8 neck's inputs at kitti's four scales of a 480 x 640 canvas,
    batch ``b``, on the card: f3 codes (256 channels) over the whole int8
    range, f4 (512 channels) mostly a ReLU's output with a few negatives."""
    import torch

    from densebox_tpu_torch import kitti_vehicle
    from densebox_tpu_torch.infer.detector import pyramid_shapes

    g = torch.Generator(device="cuda").manual_seed(seed)
    levels = []
    for h, w, _, _ in pyramid_shapes(480, 640, kitti_vehicle().infer.scales):
        f3 = torch.randint(-127, 128, (b, h // 4, w // 4, 256), generator=g,
                           device="cuda", dtype=torch.int8)
        f4 = torch.rand((b, h // 8, w // 8, 512), generator=g,
                        device="cuda") * 5.0
        f4 = torch.where(torch.rand(f4.shape, generator=g, device="cuda")
                         < 0.3, 0.0, f4) - 0.05
        levels.append((f3, f4))
    return levels


# (case, B, S, L, Hm, Wm, D, win, shared origins): the MALF serve shape (the
# 5-scale pyramid of a 480x640 canvas; scale 1.4142 gives the largest map,
# 170x228) and the bench's lm4 shape (one scale, 120x160, anchor-less)
WINDOW_CASES = [("malf", 8, 5, 5, 170, 228, 64, 32, False),
                ("lm4", 8, 1, 4, 120, 160, 64, 32, True)]


def window_inputs(rng, b, s, num_lm, hm, wm, d, win, shared, dtype):
    import torch

    maps = torch.from_numpy(rng.standard_normal((b, s, num_lm, hm, wm))
                            .astype(np.float32)).cuda().to(dtype)
    lo = 1 if shared else num_lm
    idx = [rng.randint(0, s, (b, d)), rng.randint(0, hm - win + 1, (b, d, lo)),
           rng.randint(0, wm - win + 1, (b, d, lo))]
    return [maps] + [torch.from_numpy(a.astype(np.int32)).cuda() for a in idx]


# (B, K, M, L) of a train step's rasterizer call: 32 patches, 16 boxes, a
# 60 x 60 map, 5 landmarks
TRAIN_RASTER = (32, 16, 60, 5)
LM_R2 = (0.0, 0.25, 1.0, 2.25, 6.25)     # squared radii of the edge cases


def label_rows(rng, b, k, m, num_lm, quarter=False):
    """Packed rasterizer rows: box rows (B, K, 8) = [cx, cy, rc2, rg2, x1,
    y1, x2, y2] and landmark rows (B, K*L, 3) = [lx, ly, r2], float32. Half
    the centres and radii are integers, so that pixels lie exactly on a
    disc's rim (d2 == rc2); a quarter of the slots are never positive (out
    of band), an eighth never gray either (invalid); patch 0 is empty; patch
    1 holds two boxes with one centre and two whose centres are equidistant
    from a column of pixels. With ``quarter`` every centre and radius lies
    on the quarter-pixel grid (rims everywhere) and the landmarks' squared
    radii come from ``LM_R2``."""
    c = rng.uniform(0, m, (b, k, 2))
    r = rng.uniform(0.5, m / 4, (b, k))
    integer = rng.rand(b, k) < 0.5
    c = np.where(integer[..., None], np.round(c), c)
    r = np.where(integer, np.maximum(np.round(r), 1), r)
    if quarter:
        c, r = np.round(c * 4) / 4, np.maximum(np.round(r * 4) / 4, 0.25)
    kind = rng.rand(b, k)
    rc2 = np.where(kind < 0.25, -1.0, r * r)
    rg2 = np.where(kind < 0.125, -1.0, (r + 2) ** 2)
    half = rng.uniform(1, m / 3, (b, k, 2))
    rows = np.stack([c[..., 0], c[..., 1], rc2, rg2,
                     c[..., 0] - half[..., 0], c[..., 1] - half[..., 1],
                     c[..., 0] + half[..., 0], c[..., 1] + half[..., 1]], -1)
    rows[0, :, 2:4] = -1.0
    if b > 1 and k >= 4:
        rows[1, 0, :4] = [m // 2, m // 2, 9.0, 25.0]
        rows[1, 1, :4] = rows[1, 0, :4]
        rows[1, 2, :4] = [2.0, 3.0, 16.0, 36.0]
        rows[1, 3, :4] = [6.0, 3.0, 16.0, 36.0]
    n = k * num_lm
    r2 = (rng.choice(LM_R2, (b, n, 1)) if quarter else np.ones((b, n, 1)))
    lm = np.concatenate([rng.uniform(-2, m + 2, (b, n, 2)),
                         np.where(rng.rand(b, n, 1) < 0.3, -1.0, r2)], -1)
    lm[:, ::2, :2] = np.round(lm[:, ::2, :2])      # rim-exact: d2 == 1
    if quarter:
        lm[..., :2] = np.round(lm[..., :2] * 4) / 4
    return rows.astype(np.float32), lm.astype(np.float32)


def landmark_edge_rows(m, num_lm, k, chunk):
    """Landmark rows (B, K*L, 3) that put a centre at every quarter pixel
    from 3 above to 3 below each map row where a block's chunk of ``chunk``
    output floats ends, at columns inside, on the rim of and outside the
    map, with every squared radius of ``LM_R2``."""
    row_len = m * num_lm
    edges = sorted({e // row_len for e in range(chunk, m * row_len, chunk)}
                   | {0, m - 1})
    xs = (-2.0, -0.25, 0.0, 0.25, m / 2 + 0.5, m - 1.0, m - 0.75, m + 2.0)
    rows = [(x, e + q / 4, r2) for e in edges for q in range(-12, 13)
            for r2 in LM_R2 for x in xs]
    per = k * num_lm
    b = -(-len(rows) // per)
    out = np.full((b * per, 3), -1.0, np.float32)
    out[:len(rows)] = rows
    return out.reshape(b, per, 3)


def ohem_forward_case(b):
    """``ohem_select`` inputs from a real forward: the squared errors of the
    paper model's score map on a synthetic batch of ``b`` patches (P=3600),
    its positives and gray zone, and uniforms drawn on the card."""
    import torch

    from densebox_tpu_torch import kitti_vehicle
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.models import DenseBox, init_params
    from densebox_tpu_torch.ops.labels import rasterize

    cfg = kitti_vehicle()
    gen = torch.Generator(device="cuda").manual_seed(18)
    batch = synthetic_batch(gen, b, cfg.label, cfg.train.max_boxes)
    gts = rasterize(batch["boxes"], batch["box_valid"], cfg.label)
    model = DenseBox(cfg.model, device="cuda")
    model.load_state_dict(init_params(cfg.model, torch.Generator().manual_seed(0)))
    with torch.inference_mode():
        score = model.eval()(batch["image"])["score"]
    p = score[0].numel()
    return [((score - gts["score"]) ** 2).reshape(b, p).contiguous(),
            (gts["score"] > 0.5).reshape(b, p), (gts["ignore"] > 0.5).reshape(b, p),
            torch.rand((b, p), device="cuda", generator=gen)]
