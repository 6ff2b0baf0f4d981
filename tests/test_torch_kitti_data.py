"""The port's KITTI data path (``data/kitti.py``, ``data/pipeline.py``,
``native/``) against the JAX package's on files the tests write.

Bars: label parsing, ``load_dataset``, ``canvas_batch`` (both host
backends, float32 and bfloat16, images smaller and larger than the canvas,
landmark lanes), the first batches of ``PrefetchLoader`` (one and two
shards) and ``write_result_file``'s bytes are all equal to JAX's, bit for
bit. bfloat16 is held against ``ml_dtypes`` (JAX's cast) by its bits.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from densebox_tpu.data import kitti as jax_kitti
from densebox_tpu.data import pipeline as jax_pipeline
from densebox_tpu.native import native_available as jax_native_available
from densebox_tpu_torch.data import kitti, pipeline
from densebox_tpu_torch.native import load_canvas_native, native_available

BASE = "{cls} {trunc} {occ} -1.58 {b} 1.57 1.73 4.15 1.00 1.75 13.22 -1.62"


def _label_lines(rng, n_obj, num_lm):
    lines = []
    for j in range(n_obj):
        cls = rng.choice(["Car", "Van", "Truck", "Pedestrian", "Cyclist"])
        x1, y1 = rng.uniform(0, 120), rng.uniform(0, 60)
        w, h = rng.uniform(8, 60), rng.uniform(8, 50)
        if j == 0:
            w = -w                          # a degenerate box is skipped
        b = f"{x1:.2f} {y1:.2f} {x1 + w:.2f} {y1 + h:.2f}"
        trunc = f"{rng.uniform(0, 1):.2f}" if j != 1 else "x"   # malformed
        line = BASE.format(cls=cls, trunc=trunc, occ=rng.randint(0, 4), b=b)
        if num_lm and j % 3:
            pts = rng.uniform(0, 100, (rng.randint(1, num_lm + 2), 2))
            pts[0] = -1.0                   # an invisible keypoint
            line += " " + " ".join(f"{v:.2f}" for v in pts.ravel())
        lines.append(line)
    lines.append("DontCare -1 -1 -10 1.50 2.00 30.25 40.00 -1 -1 -1 -1000 "
                 "-1000 -1000 -10")
    lines.append("Car 0 0")                 # too short: ignored
    return lines


def _write_dataset(root, shapes, num_lm=0, seed=0):
    """A KITTI-style directory: PNG images of ``shapes`` (written by cv2)
    and their label files; one label file has no image."""
    import cv2

    rng = np.random.RandomState(seed)
    img_dir, lab_dir = root / "image_2", root / "label_2"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    for i, (h, w) in enumerate(shapes):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        img[h // 4:h // 2, w // 4:w // 2] = 230
        assert cv2.imwrite(str(img_dir / f"{i:06d}.png"), img)
        (lab_dir / f"{i:06d}.txt").write_text(
            "\n".join(_label_lines(rng, rng.randint(0, 7), num_lm)))
    (lab_dir / "999999.txt").write_text(BASE.format(
        cls="Car", trunc=0, occ=0, b="1 2 3 4"))
    return str(img_dir), str(lab_dir)


SHAPES = [(60, 90), (64, 96), (100, 150), (37, 200), (90, 41), (64, 64)]
CANVAS = (64, 96)


def _same(a, b, what):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a, b = np.asarray(a), np.asarray(b)
    if b.dtype == ml_dtypes.bfloat16:
        assert a.dtype == np.int16, what    # bfloat16 bits as int16
        b = b.view(np.int16)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _batch_numpy(batch):
    return {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            .numpy() for k, v in batch.items()}


def _same_batch(got, want):
    got = _batch_numpy(got)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("num_lm", [0, 4])
@pytest.mark.parametrize("meta", [False, True])
def test_parse_label_file_equals_jax(tmp_path, num_lm, meta):
    rng = np.random.RandomState(num_lm + 10 * meta)
    for i in range(6):
        p = tmp_path / f"{i}.txt"
        p.write_text("\n".join(_label_lines(rng, rng.randint(0, 8), num_lm)))
        for classes in (kitti.VEHICLE_CLASSES, ("Pedestrian",)):
            got = kitti.parse_label_file(str(p), classes, num_lm, meta)
            want = jax_kitti.parse_label_file(str(p), classes, num_lm, meta)
            assert len(got) == len(want)
            _same(got[0], want[0], "boxes")
            if num_lm:
                _same(got[1], want[1], "landmarks")
            else:
                assert got[1] is None and want[1] is None
            if meta:
                assert set(got[2]) == set(want[2])
                for k in want[2]:
                    _same(got[2][k], want[2][k], k)


@pytest.mark.parametrize("num_lm", [0, 4])
def test_load_dataset_equals_jax(tmp_path, num_lm):
    img_dir, lab_dir = _write_dataset(tmp_path, SHAPES, num_lm)
    got = kitti.load_dataset(img_dir, lab_dir, num_landmarks=num_lm)
    want = jax_kitti.load_dataset(img_dir, lab_dir, num_landmarks=num_lm)
    assert len(got) == len(want) == len(SHAPES)
    for g, w in zip(got, want):
        assert g.image_path == w.image_path
        for field in ("boxes", "landmarks", "truncation", "occlusion",
                      "dontcare"):
            gv, wv = getattr(g, field), getattr(w, field)
            if wv is None:
                assert gv is None, field
            else:
                _same(gv, wv, field)
    with pytest.raises(FileNotFoundError):
        kitti.load_dataset(img_dir, str(tmp_path))


def test_write_result_file_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    for n in (0, 1, 7):
        boxes = rng.uniform(0, 500, (n, 4)).astype(np.float32)
        scores = rng.uniform(-1, 1, n).astype(np.float32)
        for cls in ("Car", "Van"):
            a, b = tmp_path / "a.txt", tmp_path / "b.txt"
            kitti.write_result_file(str(a), boxes, scores, cls)
            jax_kitti.write_result_file(str(b), boxes, scores, cls)
            assert a.read_bytes() == b.read_bytes()


def _backend(name):
    if name == "native" and not (native_available()
                                 and jax_native_available()):
        pytest.skip("no g++ or OpenCV development files on this machine")
    return name


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_lm", [0, 4])
def test_canvas_batch_equals_jax(tmp_path, backend, image_dtype, num_lm):
    """Every key bit for bit, with images smaller than, equal to and larger
    than the canvas (downscaled by INTER_AREA: boxes and landmarks follow),
    against JAX's canvas_batch on the same backend."""
    backend = _backend(backend)
    img_dir, lab_dir = _write_dataset(tmp_path, SHAPES, num_lm, seed=1)
    samples = kitti.load_dataset(img_dir, lab_dir, num_landmarks=num_lm)
    jax_samples = jax_kitti.load_dataset(img_dir, lab_dir,
                                         num_landmarks=num_lm)
    got = pipeline.canvas_batch(samples, CANVAS, 5, num_lm, backend=backend,
                                image_dtype=image_dtype)
    want = jax_pipeline.canvas_batch(jax_samples, CANVAS, 5, num_lm,
                                     backend=backend, image_dtype=image_dtype)
    assert got["image"].dtype == getattr(torch, image_dtype)
    assert not any(v.is_pinned() for v in got.values())
    _same_batch(got, want)
    assert (got["scale"] < 1).any() and (got["scale"] == 1).any()


def test_native_and_python_backends_equal_without_resize(tmp_path):
    _backend("native")
    img_dir, lab_dir = _write_dataset(tmp_path, SHAPES[:2] + SHAPES[-1:],
                                      seed=2)
    samples = kitti.load_dataset(img_dir, lab_dir)
    a = pipeline.canvas_batch(samples, CANVAS, 4, backend="python")
    b = pipeline.canvas_batch(samples, CANVAS, 4, backend="native")
    _same_batch(a, _batch_numpy(b))


def test_native_fills_a_given_buffer(tmp_path):
    _backend("native")
    img_dir, lab_dir = _write_dataset(tmp_path, SHAPES[:2], seed=4)
    paths = [s.image_path for s in kitti.load_dataset(img_dir, lab_dir)]
    buf = np.zeros((2,) + CANVAS + (3,), np.float32)
    images, scales, status = load_canvas_native(paths, CANVAS, images=buf)
    assert images is buf and status == [0, 0] and buf.any()
    want = jax_pipeline.canvas_batch(
        jax_kitti.load_dataset(img_dir, lab_dir), CANVAS, 1,
        backend="native")
    _same(buf, want["image"], "image")
    _same(scales, want["scale"], "scale")
    with pytest.raises(ValueError, match="C-contiguous float32"):
        load_canvas_native(paths, CANVAS, images=buf[:1])


def test_resolve_backend():
    assert pipeline.resolve_backend("python") == "python"
    assert pipeline.resolve_backend("auto") in ("native", "python")
    with pytest.raises(ValueError, match="backend"):
        pipeline.resolve_backend("cv2")


def _first_batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("num_shards", [1, 2])
def test_prefetch_loader_first_batches_equal_jax(tmp_path, num_shards):
    """The same seed, samples and shard give JAX's first three batches
    (two epochs: 10 samples, global batch 4), each shard its slice."""
    shapes = [(40 + 3 * i, 80 - 2 * i) for i in range(10)]
    img_dir, lab_dir = _write_dataset(tmp_path, shapes, num_lm=2, seed=5)
    samples = kitti.load_dataset(img_dir, lab_dir, num_landmarks=2)
    jax_samples = jax_kitti.load_dataset(img_dir, lab_dir, num_landmarks=2)
    for shard in range(num_shards):
        kw = dict(batch_size=4, canvas_hw=(64, 80), max_boxes=3, seed=7,
                  num_landmarks=2, num_shards=num_shards, shard_index=shard)
        loader = pipeline.PrefetchLoader(samples, device="cpu", **kw)
        got = _first_batches(loader, 3)
        want = _first_batches(jax_pipeline.PrefetchLoader(jax_samples, **kw),
                              3)
        for g, w in zip(got, want):
            assert g["image"].shape[0] == 4 // num_shards
            assert all(v.device.type == "cpu" for v in g.values())
            _same_batch(g, {k: np.asarray(v) for k, v in w.items()})
        assert loader.backend == pipeline.resolve_backend("auto")
        assert loader.stats["batches"] == 3
        assert 1 <= loader.stats["waited"] <= 3


def test_prefetch_loader_bfloat16_batches(tmp_path):
    img_dir, lab_dir = _write_dataset(tmp_path, SHAPES, seed=6)
    samples = kitti.load_dataset(img_dir, lab_dir)
    kw = dict(batch_size=3, canvas_hw=CANVAS, max_boxes=2, seed=1,
              image_dtype="bfloat16")
    got = _first_batches(pipeline.PrefetchLoader(samples, device="cpu",
                                                 **kw), 2)
    want = _first_batches(jax_pipeline.PrefetchLoader(
        jax_kitti.load_dataset(img_dir, lab_dir), **kw), 2)
    for g, w in zip(got, want):
        _same_batch(g, {k: np.asarray(v) for k, v in w.items()})


@pytest.mark.parametrize("backend", ["python", "native"])
def test_missing_image_raises(tmp_path, backend):
    """A missing image raises FileNotFoundError from canvas_batch on either
    backend, and fails the loader's consumer with RuntimeError (from the
    producer's error) instead of leaving it blocked."""
    backend = _backend(backend)
    samples = [kitti.Sample(image_path=str(tmp_path / "missing.png"),
                            boxes=np.zeros((0, 4), np.float32))] * 2
    with pytest.raises(FileNotFoundError, match="missing.png"):
        pipeline.canvas_batch(samples, (32, 32), 2, backend=backend)
    loader = pipeline.PrefetchLoader(samples, batch_size=2,
                                     canvas_hw=(32, 32), max_boxes=2,
                                     device="cpu")
    with pytest.raises(RuntimeError, match="producer thread failed") as e:
        next(iter(loader))
    assert isinstance(e.value.__cause__, FileNotFoundError)


def test_prefetch_loader_refuses_uneven_shards_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.PrefetchLoader([], batch_size=3, canvas_hw=(8, 8),
                                max_boxes=1, num_shards=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            pipeline.PrefetchLoader([], batch_size=2, canvas_hw=(8, 8),
                                    max_boxes=1)


def test_canvas_batch_downscale_needs_cv2(tmp_path):
    """Without cv2 an image larger than the canvas raises ImportError
    naming cv2; one that fits is read by the port's PNG decoder and equals
    the cv2 batch."""
    import sys
    from unittest import mock

    img_dir, lab_dir = _write_dataset(tmp_path, SHAPES, seed=8)
    samples = kitti.load_dataset(img_dir, lab_dir)
    want = pipeline.canvas_batch(samples[:2], CANVAS, 3, backend="python")
    with mock.patch.dict(sys.modules, {"cv2": None}):
        got = pipeline.canvas_batch(samples[:2], CANVAS, 3, backend="python")
        with pytest.raises(ImportError, match="cv2"):
            pipeline.canvas_batch(samples[2:3], CANVAS, 3, backend="python")
    _same_batch(got, _batch_numpy(want))
    assert os.path.basename(samples[2].image_path) == "000002.png"
