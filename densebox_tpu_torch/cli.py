"""Command line of the port (port of ``densebox_tpu/cli.py``): ``train``,
``detect``, ``quantize``, ``serve`` and ``eval``, with the JAX package's
flags, less those of its TPU backends.

  python -m densebox_tpu_torch.cli train --data-dir <kitti_root> --workdir run
  python -m densebox_tpu_torch.cli train --synthetic --workdir run --steps 200
  python -m densebox_tpu_torch.cli eval --workdir run --data-dir <kitti_root>
  python -m densebox_tpu_torch.cli quantize --workdir run --out run_int8
  python -m densebox_tpu_torch.cli detect --workdir run --image a.png
  python -m densebox_tpu_torch.cli serve --workdir run --port 8471

(``densebox-torch`` once the package is installed.) Every subcommand runs
on the card unless ``--device`` names another device (``--device cpu``);
without a card and without ``--device`` it raises.

``train`` runs data-parallel under ``torchrun`` (one process per card, or
per CPU process with ``--device cpu``; ``parallel/multihost.py``):

  torchrun --nproc_per_node 2 -m densebox_tpu_torch.cli train --synthetic \
      --workdir run --device cpu

each rank loads its rows of every global batch, rank 0 alone prints and
writes checkpoints. Images are read by
``data/imageio.py``: without cv2 only PNG, and no image larger than the
canvas; ``detect --video`` and the annotated images of ``detect --image``
need cv2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _merged_infer_cfg(base, args):
    """Layer ONLY the explicitly passed inference flags over ``base`` (the
    checkpoint's InferCfg at detect/eval/serve time, the defaults at train
    time), so the config stored in every checkpoint is honoured."""
    over = {}
    if args.scales is not None:
        over["scales"] = tuple(float(s) for s in args.scales.split(","))
    if args.thresh is not None:
        over["score_thresh"] = args.thresh
    if args.nms_iou is not None:
        over["nms_iou"] = args.nms_iou
    if args.max_dets is not None:
        over["max_dets"] = args.max_dets
    if args.topk_per_scale is not None:
        over["topk_per_scale"] = args.topk_per_scale
    if args.lm_decode is not None:
        over["lm_decode"] = args.lm_decode
    if args.lm_topk is not None:
        over["lm_topk"] = args.lm_topk
    if args.lm_dtype is not None:
        over["lm_dtype"] = args.lm_dtype
    return dataclasses.replace(base, **over)


def _parse_lm_anchors(spec, num_landmarks=None):
    """'0,0,1,0,1,1,0,1' -> ((0,0),(1,0),(1,1),(0,1)); None passes through."""
    if not spec:
        return None
    vals = [float(v) for v in spec.split(",")]
    if len(vals) % 2:
        raise SystemExit("--lm-anchors needs an even number of values "
                         "(ax,ay per landmark)")
    anchors = tuple((vals[i], vals[i + 1]) for i in range(0, len(vals), 2))
    if num_landmarks is not None and len(anchors) != num_landmarks:
        raise SystemExit(f"--lm-anchors has {len(anchors)} points but the "
                         f"model has {num_landmarks} landmarks")
    return anchors


def _build_cfg(args):
    from densebox_tpu_torch.config import (DenseBoxConfig, InferCfg,
                                           LabelCfg, ModelCfg, TrainCfg)

    return DenseBoxConfig(
        model=ModelCfg(num_landmarks=args.landmarks,
                       use_refine=args.landmarks > 0,
                       width_mult=args.width_mult,
                       stem=args.stem,
                       trunk_depth=args.trunk_depth,
                       compute_dtype=args.dtype,
                       **({"refine_width": args.refine_width}
                          if args.refine_width is not None else {})),
        label=LabelCfg(patch_size=args.patch_size,
                       std_height_px=args.std_height,
                       lm_flip_perm=(tuple(int(i) for i in
                                     args.lm_flip_perm.split(","))
                                     if args.lm_flip_perm else None),
                       lm_anchors=_parse_lm_anchors(args.lm_anchors,
                                                    args.landmarks)),
        infer=_merged_infer_cfg(InferCfg(), args),
        train=TrainCfg(batch_size=args.batch_size,
                       learning_rate=args.lr,
                       num_steps=args.steps,
                       max_boxes=args.max_boxes,
                       ckpt_every=args.ckpt_every,
                       log_every=args.log_every,
                       seed=args.seed))


def _synthetic_canvas_batches(cfg, device, num_shards=1, shard_index=0):
    """Step-keyed synthetic full-image batches on ``device`` (the batch of
    step N is drawn from a generator seeded with N, so a resumed run sees
    the batches an uninterrupted one does); with ``num_shards`` > 1 the
    ``shard_index``-th block of rows of each global batch."""
    from densebox_tpu_torch.config import resolved_canvas_dtype
    from densebox_tpu_torch.data import synthetic_batch

    canvas_cfg = type(cfg.label)(
        patch_size=4 * cfg.label.patch_size,
        std_height_px=cfg.label.std_height_px, stride=cfg.label.stride)
    image_dtype = getattr(torch, resolved_canvas_dtype(cfg))

    rows = cfg.train.batch_size // num_shards
    lo = shard_index * rows

    def fetch(step: int) -> dict:
        gen = torch.Generator(device=device).manual_seed(step)
        batch = synthetic_batch(gen, cfg.train.batch_size, canvas_cfg,
                                max_boxes=cfg.train.max_boxes,
                                num_landmarks=cfg.model.num_landmarks,
                                image_dtype=image_dtype, device=device)
        return {k: v[lo:lo + rows] for k, v in batch.items()}

    return fetch


def cmd_train(args) -> int:
    from densebox_tpu_torch.parallel.multihost import is_primary
    from densebox_tpu_torch.train import fit
    from densebox_tpu_torch.train.trainer import data_parallel_ranks
    from densebox_tpu_torch.utils.logging import (enable_debug_checks,
                                                  maybe_profile)

    dev = _device(args)
    cfg = _build_cfg(args)
    if args.debug_nans:
        enable_debug_checks()
    say = print if is_primary() else (lambda *a, **k: None)
    # data parallelism: this rank's rows of every global batch
    shards = data_parallel_ranks(cfg)
    shard = torch.distributed.get_rank() if shards > 1 else 0

    if args.synthetic:
        batches = _synthetic_canvas_batches(cfg, dev, shards, shard)
    else:
        from densebox_tpu_torch.config import resolved_canvas_dtype
        from densebox_tpu_torch.data.kitti import load_dataset
        from densebox_tpu_torch.data.pipeline import PrefetchLoader

        samples = load_dataset(os.path.join(args.data_dir, "image_2"),
                               os.path.join(args.data_dir, "label_2"),
                               num_landmarks=cfg.model.num_landmarks)
        say(f"loaded {len(samples)} samples from {args.data_dir}")
        loader = PrefetchLoader(samples, cfg.train.batch_size,
                                canvas_hw=tuple(args.canvas),
                                max_boxes=cfg.train.max_boxes,
                                seed=cfg.train.seed,
                                num_landmarks=cfg.model.num_landmarks,
                                num_shards=shards, shard_index=shard,
                                image_dtype=resolved_canvas_dtype(cfg),
                                device=dev)
        say(f"loader backend: {loader.backend}", flush=True)
        batches = iter(loader)

    # Failure recovery: periodic checkpoints and resume from the latest;
    # --max-restarts re-enters the loop after a failed step, restoring the
    # last checkpoint.
    attempts = 0
    with maybe_profile(f"{args.workdir}/profile" if args.profile else None):
        while True:
            try:
                result = fit(cfg, batches, workdir=args.workdir,
                             num_steps=args.steps,
                             resume=not args.no_resume or attempts > 0,
                             run_salt=attempts, device=dev)
                break
            except Exception as e:  # noqa: BLE001 - restart boundary
                attempts += 1
                if attempts > args.max_restarts:
                    raise
                # run_salt=attempts: fresh dropout/OHEM/patch draws per
                # retry, so a deterministic divergence is not replayed
                say(f"[restart {attempts}/{args.max_restarts}] "
                      f"step failed: {type(e).__name__}: {e}; resuming from "
                      f"last checkpoint with salted draws", flush=True)
    say(f"done at step {int(result.state.step)}: "
        f"{json.dumps(result.last_metrics)}")
    return 0


def _device(args):
    """``--device``, else the card: under torchrun this rank's card."""
    from densebox_tpu_torch.device import resolve_device
    from densebox_tpu_torch.parallel.multihost import local_device, world_size

    if args.device is None and world_size() > 1:
        return local_device()
    return resolve_device(args.device)


def _maybe_override_label(cfg, args):
    """Layer an explicitly passed --lm-anchors over the checkpoint's
    LabelCfg."""
    if args.lm_anchors:
        cfg = dataclasses.replace(
            cfg, label=dataclasses.replace(
                cfg.label, lm_anchors=_parse_lm_anchors(
                    args.lm_anchors, cfg.model.num_landmarks)))
    return cfg


def _load_bundle(workdir, device):
    """(cfg, model with its weights on ``device``, is_quantized) from a
    training run or a ``quantize`` int8 export (recognized by its marker
    file)."""
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.train import checkpoint as ck

    ckpt = os.path.join(workdir, "ckpt")
    if ck.is_quantized_dir(ckpt):
        from densebox_tpu_torch.models.quant import QuantDenseBox

        cfg, qparams, calibration = ck.load_quantized(ckpt, device)
        print(f"int8 checkpoint (calibration: {calibration})",
              file=sys.stderr)
        model = QuantDenseBox(cfg.model, device=device)
        model.load_state_dict(qparams)
        return cfg, model, True
    cfg, params = ck.load_for_inference(ckpt, device)
    model = DenseBox(cfg.model, device=device)
    model.load_state_dict(params)
    return cfg, model, False


def _no_checkpoint(e) -> int:
    print(f"error: {e} — train first or point --workdir at a training run",
          file=sys.stderr)
    return 2


def _calib_dir(args, device):
    """(images, source) of --calib-dir for int8 calibration, or (None,
    None) when it is not given."""
    if not args.calib_dir:
        return None, None
    return (_calib_dir_images(args.calib_dir, device),
            f"--calib-dir {args.calib_dir}")


def cmd_quantize(args) -> int:
    """Export a deployable int8-PTQ checkpoint: calibrate once, save the
    int8 state and the config; detect/eval/serve then load it directly."""
    from densebox_tpu_torch.device import resolve_device
    from densebox_tpu_torch.train.checkpoint import save_quantized

    dev = resolve_device(args.device)
    try:
        cfg, model, quantized = _load_bundle(args.workdir, dev)
    except FileNotFoundError as e:
        return _no_checkpoint(e)
    if quantized:
        print(f"error: {args.workdir} is already an int8 export",
              file=sys.stderr)
        return 2
    calib, src = _calib_dir(args, dev)
    qmodel = _quantize(model, cfg, calib, src, dev)
    src = src or "synthetic canvases (hermetic fallback)"
    save_quantized(os.path.join(args.out, "ckpt"), qmodel.state_dict(), cfg,
                   calibration=src)
    print(f"wrote int8 checkpoint to {args.out} (calibration: {src})")
    return 0


def _detect_video(args, cfg, detect, dev) -> int:
    """Frame-batched video detection: decoded frames go in fixed-shape
    batches of ``--video-batch`` through the detect function; an annotated
    MJPG video comes out."""
    try:
        import cv2
    except ImportError:
        print("error: --video needs OpenCV (cv2) to read and write video, "
              "and cv2 is not installed", file=sys.stderr)
        return 2

    from densebox_tpu_torch.utils.viz import draw_detections

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        print(f"error: cannot open video {args.video}", file=sys.stderr)
        return 2
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    stem = os.path.splitext(os.path.basename(args.video))[0]
    out_path = os.path.join(args.out, stem + "_dets.avi")
    m = cfg.model.min_divisor
    bs = args.video_batch
    writer = None
    n_frames = total_dets = 0

    def flush(frames):
        nonlocal writer, n_frames, total_dets
        if not frames:
            return
        h, w = frames[0].shape[:2]
        # fixed (bs, padded H, padded W); a short final batch pads with zero
        # frames whose results are dropped
        x = np.zeros((bs, h + (-h % m), w + (-w % m), 3), np.float32)
        for i, f in enumerate(frames):
            x[i, :h, :w] = f / 255.0
        out = detect(torch.from_numpy(x).to(dev))
        dets = {k: v.cpu().numpy() for k, v in out.items()}
        for i, f in enumerate(frames):
            vis = draw_detections(f, dets, batch_index=i)
            if writer is None:
                writer = cv2.VideoWriter(
                    out_path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
            writer.write(cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
            total_dets += int(dets["valid"][i].sum())
            n_frames += 1

    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        if len(frames) == bs:
            flush(frames)
            frames = []
    flush(frames)
    cap.release()
    if writer is None:
        print(f"error: {args.video} contained no frames", file=sys.stderr)
        return 2
    writer.release()
    print(f"{args.video}: {n_frames} frames, {total_dets} detections "
          f"-> {out_path}")
    return 0


def cmd_detect(args) -> int:
    from densebox_tpu_torch.data.imageio import imread
    from densebox_tpu_torch.device import resolve_device
    from densebox_tpu_torch.infer import make_detect_fn
    from densebox_tpu_torch.models import DenseBox

    if not args.image and not args.video:
        print("error: one of --image / --video is required", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    try:
        cfg, model, quantized = _load_bundle(args.workdir, dev)
    except FileNotFoundError as e:
        return _no_checkpoint(e)
    cfg = _maybe_override_label(cfg, args)
    if quantized and args.dtype is not None:
        print("note: --dtype is ignored on an int8 checkpoint export "
              "(the int8 path has its own dtypes)", file=sys.stderr)
    if not quantized and args.dtype is not None:
        float_model = DenseBox(dataclasses.replace(
            cfg.model, compute_dtype=args.dtype), device=dev)
        float_model.load_state_dict(model.state_dict())
        model = float_model
    if args.quantize and not quantized:
        if args.dtype is not None:
            print("note: --dtype is ignored with --quantize (the int8 path "
                  "has its own dtypes)", file=sys.stderr)
        calib, src = _calib_dir(args, dev)
        if calib is None and args.image:
            calib, src = _load_calib_images(args.image, dev), "the input images"
        model = _quantize(model, cfg, calib, src, dev)
    icfg = _merged_infer_cfg(cfg.infer, args)
    detect = make_detect_fn(model, icfg, cfg.label)

    os.makedirs(args.out, exist_ok=True)
    if args.video:
        return _detect_video(args, cfg, detect, dev)
    m = cfg.model.min_divisor
    for path in args.image:
        img = imread(path)
        if img is None:
            print(f"error: cannot read image {path}", file=sys.stderr)
            return 2
        h, w = img.shape[:2]
        padded = np.pad(img, ((0, -h % m), (0, -w % m), (0, 0)))
        x = torch.from_numpy(padded.astype(np.float32)[None] / 255.0)
        out = detect(x.to(dev))
        dets = {k: v.cpu().numpy() for k, v in out.items()}
        n = int(dets["valid"][0].sum())
        print(f"{path}: {n} detections")
        for i in np.nonzero(dets["valid"][0])[0]:
            print("  box=%s score=%.3f" % (
                np.round(dets["boxes"][0, i], 1).tolist(),
                dets["scores"][0, i]))
        _save_annotated(args.out, path, img, dets)
        if args.save_kitti:
            from densebox_tpu_torch.data.kitti import write_result_file

            os.makedirs(args.save_kitti, exist_ok=True)
            stem = os.path.splitext(os.path.basename(path))[0]
            v = dets["valid"][0]
            txt = os.path.join(args.save_kitti, stem + ".txt")
            write_result_file(txt, dets["boxes"][0][v],
                              dets["scores"][0][v])
            print(f"  wrote {txt}")
    return 0


def _save_annotated(out_dir, path, img, dets) -> None:
    """Write ``img`` with its detections drawn into ``out_dir``; without cv2
    say on stderr that none was written."""
    try:
        import cv2  # noqa: F401  (drawing and writing need it)
    except ImportError:
        print(f"  note: no annotated image written for {path} (drawing "
              "needs OpenCV, cv2, which is not installed)", file=sys.stderr)
        return
    from densebox_tpu_torch.utils.viz import draw_detections, save_image

    out_path = os.path.join(out_dir, os.path.basename(path))
    save_image(out_path, draw_detections(img, dets))
    print(f"  wrote {out_path}")


def cmd_serve(args) -> int:
    from densebox_tpu_torch.device import resolve_device
    from densebox_tpu_torch.serve import (DetectServer, make_http_server,
                                          serve_forever)

    dev = resolve_device(args.device)
    try:
        cfg, model, quantized = _load_bundle(args.workdir, dev)
    except FileNotFoundError as e:
        return _no_checkpoint(e)
    cfg = _maybe_override_label(cfg, args)
    if args.quantize and not quantized:
        calib, src = _calib_dir(args, dev)
        model = _quantize(model, cfg, calib, src, dev)
    icfg = _merged_infer_cfg(cfg.infer, args)
    server = DetectServer(model, icfg, cfg.label,
                          canvas_hw=tuple(args.canvas),
                          max_batch=args.max_batch,
                          batch_window_ms=args.batch_window_ms, device=dev)
    info = {"canvas": list(args.canvas), "max_batch": args.max_batch,
            "quantized": bool(args.quantize or quantized),
            "landmarks": cfg.model.num_landmarks,
            "scales": list(icfg.scales), "device": str(dev)}
    httpd = make_http_server(server, args.host, args.port, info)
    print(f"serving on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]}  (POST /detect, GET /healthz)",
          flush=True)
    try:
        serve_forever(httpd)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def cmd_eval(args) -> int:
    from densebox_tpu_torch.device import resolve_device
    from densebox_tpu_torch.eval import (detections_to_numpy,
                                         evaluate_detections)
    from densebox_tpu_torch.infer import make_detect_fn

    dev = resolve_device(args.device)
    try:
        cfg, model, quantized = _load_bundle(args.workdir, dev)
    except FileNotFoundError as e:
        return _no_checkpoint(e)
    cfg = _maybe_override_label(cfg, args)
    samples = None
    if not args.synthetic:
        from densebox_tpu_torch.data.kitti import load_dataset

        samples = load_dataset(os.path.join(args.data_dir, "image_2"),
                               os.path.join(args.data_dir, "label_2"),
                               num_landmarks=cfg.model.num_landmarks)
    if args.quantize and not quantized:
        # real data calibrates on the eval images, synthetic eval on the
        # synthetic canvases
        calib, src = _calib_dir(args, dev)
        if calib is None and samples is not None:
            calib = _load_calib_images([s.image_path for s in samples], dev)
            src = f"the first {calib.shape[0]} eval images"
        model = _quantize(model, cfg, calib, src, dev)
    # Eval's own default: a low threshold keeps the PR curve's low-score
    # tail, so AP is not cut at the checkpoint's detection threshold (0.5).
    if args.thresh is None:
        args.thresh = 0.3
    icfg = _merged_infer_cfg(cfg.infer, args)
    detect = make_detect_fn(model, icfg, cfg.label)

    per_image = []
    kitti_items = []
    nme_samples = []
    num_lm = cfg.model.num_landmarks
    if args.synthetic:
        from densebox_tpu_torch.data import synthetic_batch

        canvas_cfg = type(cfg.label)(
            patch_size=4 * cfg.label.patch_size,
            std_height_px=cfg.label.std_height_px)
        for i in range(args.eval_batches):
            gen = torch.Generator(device=dev).manual_seed(1_000_000 + i)
            b = synthetic_batch(gen, args.batch_size, canvas_cfg,
                                max_boxes=cfg.train.max_boxes,
                                num_landmarks=num_lm, device=dev)
            dets = detect(b["image"])
            per_image += detections_to_numpy(dets, b["boxes"],
                                             b["box_valid"])
            if num_lm and "lm_points" in dets:
                nme_samples += _match_landmarks(dets, b)
    else:
        from densebox_tpu_torch.data.pipeline import canvas_batch

        for i in range(0, len(samples) - args.batch_size + 1,
                       args.batch_size):
            b = canvas_batch(samples[i:i + args.batch_size],
                             tuple(args.canvas), max_boxes=64,
                             num_landmarks=num_lm)
            dets = detect(b["image"].to(dev))
            d_np = detections_to_numpy(dets, b["boxes"], b["box_valid"])
            per_image += d_np
            if args.protocol == "kitti":
                # the protocol runs in ORIGINAL image coordinates: its
                # difficulty bins are defined on annotation-pixel heights
                for k, s in enumerate(samples[i:i + args.batch_size]):
                    f = float(b["scale"][k])
                    item = {"pred_boxes": d_np[k]["pred_boxes"] / f,
                            "pred_scores": d_np[k]["pred_scores"],
                            "gt_boxes": s.boxes}
                    for key, v in (("gt_truncation", s.truncation),
                                   ("gt_occlusion", s.occlusion),
                                   ("dontcare", s.dontcare)):
                        if v is not None:
                            item[key] = v
                    kitti_items.append(item)
            if num_lm and "lm_points" in dets and "landmarks" in b:
                nme_samples += _match_landmarks(dets, b)
    res = evaluate_detections(per_image, iou_thresh=args.eval_iou)
    summary = {"ap@%.2f" % args.eval_iou: round(res["ap"], 4),
               "n_images": len(per_image),
               "n_gt": int(res["n_gt"]),
               "n_pred": int(res["n_pred"])}
    if args.protocol == "kitti":
        from densebox_tpu_torch.eval import evaluate_kitti

        # synthetic eval has no truncation/occlusion metadata: every GT is
        # fully visible and the bins differ only by height
        kres = evaluate_kitti(kitti_items or per_image, iou_thresh=0.7)
        for d in ("easy", "moderate", "hard"):
            v = kres[f"ap_{d}"]
            summary[f"kitti_ap_{d}@0.70"] = (round(v, 4)
                                             if v == v else None)
            summary[f"kitti_n_gt_{d}"] = int(kres[f"n_gt_{d}"])
    if nme_samples:
        from densebox_tpu_torch.eval import landmark_nme

        pred = np.stack([s[0] for s in nme_samples])
        gt = np.stack([s[1] for s in nme_samples])
        norm = np.asarray([s[2] for s in nme_samples])
        vis = np.stack([s[3] for s in nme_samples])
        summary["landmark_nme"] = round(
            landmark_nme(pred, gt, norm, mask=vis), 4)
        summary["n_lm_matched"] = len(nme_samples)
    print(json.dumps(summary))
    return 0


_CALIB_MAX_IMAGES = 16


def _load_calib_images(paths, device, multiple=8, limit=_CALIB_MAX_IMAGES):
    """Deployment-domain calibration batch on ``device``: up to ``limit``
    readable images, zero-padded onto a shared model-divisible canvas
    (absmax calibration cares about activation magnitudes, not geometry).
    None if no image reads."""
    from densebox_tpu_torch.data.imageio import imread

    imgs = []
    for p in list(paths)[:limit]:
        img = imread(p)
        if img is not None:
            imgs.append(img.astype(np.float32) / 255.0)
    if not imgs:
        return None
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    h += -h % multiple
    w += -w % multiple
    out = np.zeros((len(imgs), h, w, 3), np.float32)
    for i, im in enumerate(imgs):
        out[i, :im.shape[0], :im.shape[1]] = im
    return torch.from_numpy(out).to(device)


def _quantize(model, cfg, calib, source, device):
    """Int8 PTQ of the float ``model``: activation absmax scales calibrated
    on the deployment inputs (``calib``: the images being processed or
    --calib-dir) when given, else on two synthetic canvases. The source is
    printed so that runs are auditable. Returns the ``QuantDenseBox``."""
    from densebox_tpu_torch.models.quant import (QuantDenseBox,
                                                 quantize_densebox)

    if calib is None:
        from densebox_tpu_torch.data import synthetic_batch

        canvas_cfg = type(cfg.label)(patch_size=4 * cfg.label.patch_size,
                                     std_height_px=cfg.label.std_height_px)
        gen = torch.Generator(device=device).manual_seed(42)
        calib = synthetic_batch(gen, 2, canvas_cfg,
                                max_boxes=cfg.train.max_boxes,
                                num_landmarks=cfg.model.num_landmarks,
                                device=device)["image"]
        source = source or "synthetic canvases (hermetic fallback)"
    print(f"int8 calibration: {calib.shape[0]} images from {source}",
          file=sys.stderr)
    qmodel = QuantDenseBox(cfg.model, device=device)
    qmodel.load_state_dict(quantize_densebox(model.state_dict(), cfg.model,
                                             calib))
    return qmodel


def _calib_dir_images(calib_dir, device):
    files = sorted(
        os.path.join(calib_dir, f) for f in os.listdir(calib_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    calib = _load_calib_images(files, device)
    if calib is None:
        raise SystemExit(f"--calib-dir {calib_dir}: no readable images")
    return calib


def _match_landmarks(dets, batch):
    """Pair each valid detection with the GT box of highest IoU (at least
    0.5) and collect (pred_landmarks, gt_landmarks, box_height, gt_visible)
    NME samples."""
    from densebox_tpu_torch.eval import as_numpy
    from densebox_tpu_torch.ops.kernels.nms import iou_matrix

    out = []
    boxes = as_numpy(dets["boxes"])
    valid = as_numpy(dets["valid"])
    lm_pts = as_numpy(dets["lm_points"])
    # detections past the lm_topk decode cap carry zeroed lm_points with
    # lm_valid all False: leave them out of the NME
    pred_lm_valid = (as_numpy(dets["lm_valid"]) if "lm_valid" in dets
                     else np.ones(lm_pts.shape[:2], bool))
    if pred_lm_valid.ndim == 3:
        pred_lm_valid = pred_lm_valid.any(axis=-1)
    gt_boxes = as_numpy(batch["boxes"])
    gt_valid = as_numpy(batch["box_valid"])
    gt_lms = as_numpy(batch["landmarks"])
    gt_lm_valid = (as_numpy(batch["lm_valid"]) if "lm_valid" in batch
                   else np.ones(gt_lms.shape[:3], bool))
    for i in range(boxes.shape[0]):
        gv = gt_valid[i]
        if not gv.any() or not valid[i].any():
            continue
        ious = iou_matrix(torch.from_numpy(boxes[i]),
                          torch.from_numpy(gt_boxes[i])).numpy().copy()
        ious[:, ~gv] = -1.0
        for d in np.nonzero(valid[i] & pred_lm_valid[i])[0]:
            j = int(np.argmax(ious[d]))
            if ious[d, j] < 0.5:
                continue
            h = gt_boxes[i, j, 3] - gt_boxes[i, j, 1]
            out.append((lm_pts[i, d], gt_lms[i, j], h, gt_lm_valid[i, j]))
    return out


def _add_common_flags(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card, "
                        "an error without one; 'cpu' for the CPU)")


def _add_infer_flags(p) -> None:
    """Inference settings. Default None = "not passed": detect/eval/serve
    fall back to the checkpoint's InferCfg, train to the InferCfg defaults
    (which are then stored in every checkpoint of the run)."""
    p.add_argument("--scales", default=None,
                   help="comma-separated pyramid scales "
                        "(default: checkpoint InferCfg)")
    p.add_argument("--thresh", type=float, default=None,
                   help="score threshold (default: checkpoint InferCfg)")
    p.add_argument("--nms-iou", type=float, default=None)
    p.add_argument("--max-dets", type=int, default=None)
    p.add_argument("--topk-per-scale", type=int, default=None)
    p.add_argument("--lm-dtype",
                   choices=("auto", "float32", "bfloat16"), default=None,
                   help="landmark heatmap dtype through window gather and "
                        "peak decode (default: checkpoint InferCfg)")
    p.add_argument("--lm-topk", type=int, default=None,
                   help="decode landmarks for only the top-K detections by "
                        "score (0 = all max_dets slots)")
    p.add_argument("--lm-decode", choices=("std", "source", "finest"),
                   default=None,
                   help="pyramid level for landmark decode per detection: "
                        "std = scale bringing the box nearest the standard "
                        "object height, source = the detection's own "
                        "scale, finest = largest scale")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="densebox-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a DenseBox detector")
    t.add_argument("--data-dir", help="KITTI-style root (image_2/, label_2/)")
    t.add_argument("--synthetic", action="store_true",
                   help="train on the procedural rectangle set")
    t.add_argument("--workdir", required=True)
    t.add_argument("--steps", type=int, default=10000)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--width-mult", type=float, default=1.0)
    t.add_argument("--stem", choices=("conv", "s2d", "s2d4"), default="conv",
                   help="s2d = space-to-depth stem; s2d4 = whole trunk at "
                        "output stride")
    t.add_argument("--trunk-depth", type=int, default=4,
                   help="convs per conv3/conv4 block (4=VGG19 paper, 3=fast)")
    t.add_argument("--dtype", default="float32")
    t.add_argument("--patch-size", type=int, default=240)
    t.add_argument("--std-height", type=float, default=50.0)
    t.add_argument("--landmarks", type=int, default=0)
    t.add_argument("--lm-flip-perm", default=None,
                   help="comma-separated landmark channel permutation under "
                        "horizontal flip, e.g. '1,0,3,2' for box corners")
    t.add_argument("--lm-anchors", default=None,
                   help="box-relative expected landmark positions, flat "
                        "ax,ay list (e.g. '0,0,1,0,1,1,0,1' for corners); "
                        "restricts each channel's decode-time peak search "
                        "near its expected spot (stored in checkpoints)")
    t.add_argument("--max-boxes", type=int, default=16)
    t.add_argument("--canvas", type=int, nargs=2, default=(384, 1248),
                   help="host canvas H W for full images")
    t.add_argument("--ckpt-every", type=int, default=1000)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--no-resume", action="store_true")
    t.add_argument("--max-restarts", type=int, default=0,
                   help="restart from the last checkpoint after a failed "
                        "step, up to N times")
    t.add_argument("--refine-width", type=int, default=None,
                   help="refine-branch conv width")
    t.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace under WORKDIR/profile")
    t.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection (slow)")
    _add_infer_flags(t)
    _add_common_flags(t)
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("detect", help="run detection on images or video")
    d.add_argument("--workdir", required=True)
    d.add_argument("--image", nargs="+", default=None)
    d.add_argument("--video", default=None,
                   help="video file (needs cv2): frames run in fixed-shape "
                        "batches; writes an annotated video")
    d.add_argument("--video-batch", type=int, default=8,
                   help="frames per device batch for --video")
    d.add_argument("--out", default="detections")
    d.add_argument("--save-kitti", default=None, metavar="DIR",
                   help="also write per-image KITTI result txts (the "
                        "official devkit format) into DIR")
    d.add_argument("--dtype", default=None,
                   help="override inference compute dtype (e.g. bfloat16)")
    d.add_argument("--quantize", action="store_true",
                   help="int8 post-training-quantized inference path "
                        "(calibrated on the input images; see --calib-dir)")
    d.add_argument("--calib-dir", default=None,
                   help="directory of representative images for int8 "
                        "activation-scale calibration (default: the images "
                        "being processed, up to 16)")
    d.add_argument("--lm-anchors", default=None,
                   help="override the checkpoint's box-relative landmark "
                        "anchors (flat ax,ay list)")
    _add_infer_flags(d)
    _add_common_flags(d)
    d.set_defaults(fn=cmd_detect)

    q = sub.add_parser("quantize", help="export a deployable int8-PTQ "
                                        "checkpoint (calibrate once; "
                                        "detect/eval/serve load it "
                                        "directly)")
    q.add_argument("--workdir", required=True,
                   help="training run to quantize")
    q.add_argument("--out", required=True,
                   help="output directory for the int8 checkpoint")
    q.add_argument("--calib-dir", default=None,
                   help="directory of representative images for activation "
                        "calibration (default: synthetic canvases)")
    _add_common_flags(q)
    q.set_defaults(fn=cmd_quantize)

    s = sub.add_parser("serve", help="batched HTTP inference server "
                                     "(POST /detect, GET /healthz)")
    s.add_argument("--workdir", required=True,
                   help="training run (or int8 checkpoint export) to serve")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8471)
    s.add_argument("--canvas", type=int, nargs=2, default=(480, 640),
                   help="fixed serving canvas H W (requests letterbox onto "
                        "it)")
    s.add_argument("--max-batch", type=int, default=8,
                   help="device batch: concurrent requests coalesce up to "
                        "this many per call")
    s.add_argument("--batch-window-ms", type=float, default=15.0,
                   help="how long the first queued request waits for "
                        "companions before its device call")
    s.add_argument("--quantize", action="store_true",
                   help="serve the int8 PTQ path (calibrated on --calib-dir, "
                        "else on synthetic canvases)")
    s.add_argument("--calib-dir", default=None)
    s.add_argument("--lm-anchors", default=None)
    _add_infer_flags(s)
    _add_common_flags(s)
    s.set_defaults(fn=cmd_serve)

    e = sub.add_parser("eval", help="compute detection AP on a dataset")
    e.add_argument("--workdir", required=True)
    e.add_argument("--data-dir")
    e.add_argument("--synthetic", action="store_true")
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--eval-batches", type=int, default=8,
                   help="synthetic eval batches")
    e.add_argument("--canvas", type=int, nargs=2, default=(384, 1248))
    e.add_argument("--eval-iou", type=float, default=0.5)
    e.add_argument("--protocol", default="voc", choices=["voc", "kitti"],
                   help="voc: continuous-interpolation AP at --eval-iou; "
                        "kitti: the official devkit protocol, AP|R40 at "
                        "IoU 0.7 per difficulty bin (easy/moderate/hard "
                        "over bbox height, occlusion, truncation), with "
                        "ignore and DontCare semantics, evaluated in "
                        "original-image coordinates (eval.py)")
    e.add_argument("--quantize", action="store_true",
                   help="evaluate the int8 PTQ path; real-data eval "
                        "calibrates on the eval images, synthetic eval on "
                        "synthetic canvases")
    e.add_argument("--calib-dir", default=None,
                   help="directory of representative images for int8 "
                        "activation-scale calibration")
    e.add_argument("--lm-anchors", default=None,
                   help="override the checkpoint's box-relative landmark "
                        "anchors (flat ax,ay list)")
    _add_infer_flags(e)
    _add_common_flags(e)
    e.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    from densebox_tpu_torch.parallel.multihost import (ensure_distributed,
                                                       world_size)

    p = _parser()
    args = p.parse_args(argv)
    # join torchrun's process group (NCCL on the card, gloo with --device
    # cpu); without torchrun's variables this does nothing
    ensure_distributed(device=args.device)
    if world_size() > 1 and args.cmd != "train":
        p.error(f"{args.cmd} runs as one process; only train runs "
                f"data-parallel under torchrun")
    if args.cmd in ("eval", "train") and not (args.synthetic
                                              or args.data_dir):
        p.error(f"{args.cmd} requires --data-dir or --synthetic")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
