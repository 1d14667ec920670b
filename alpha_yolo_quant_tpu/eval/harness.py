"""Batched COCO-val evaluation harness (the stage-3/4/8 loops).

One jitted step runs forward + decode + NMS for a whole batch; detections
come back as fixed-shape (B, max_det, 6) arrays and are turned into metric
rows on host. With a device mesh the batch axis shards over the devices
(parallel.mesh) — the reference loops images one at a time on host
(stage_4.py:975-1011).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import jax
import numpy as np

from alpha_yolo_quant_tpu.data.coco import CocoValDataset, batches
from alpha_yolo_quant_tpu.eval.metrics import map50_95
from alpha_yolo_quant_tpu.eval.records import (
    annotation_rows, detection_rows, to_metric_arrays,
)


@dataclasses.dataclass
class EvalResult:
    map50_95: float
    per_iou: Dict[float, float]
    n_images: int
    images_per_s: float          # device-step time only
    images_per_s_wall: float = 0.0   # host-inclusive: decode+feed+metrics
    wall_s: float = 0.0
    # raw metric rows, kept for the reference's CSV archival contract
    # (records.save_csv_tables; stage_3.py:48-49, stage_8_torch.py:1026)
    ann_rows: List[list] = dataclasses.field(default_factory=list)
    det_rows: List[list] = dataclasses.field(default_factory=list)


def evaluate(step: Callable, ds: CocoValDataset, batch_size: int = 16,
             image_size: int = 640, box_descale: float = 1.0,
             conf_scale: float = 1.0, progress: bool = False,
             prefetch: bool = False) -> EvalResult:
    """step(images f32 (B,3,S,S)) -> (det (B,max_det,6), n_det (B,)).

    Boxes are expected in the model frame; annotations are normalized by
    the original image size per the reference convention (detections stay
    in the 640 frame because the reference's `orig_img` is the resized
    tensor — stage_4.py:476, utils/coco.py:152-175).

    prefetch: decode/stage the next batches on background threads while the
    device computes (data.prefetch), AND pipeline the result fetch — the
    next batch dispatches before the previous batch's detections are
    fetched and turned into metric rows, so host metric work overlaps
    device compute (JAX dispatch is async). In this mode images_per_s
    counts only the residual blocked-on-device time and wall is the
    meaningful figure.
    """
    ann_rows: List[list] = []
    det_rows: List[list] = []
    n_img = 0
    t_dev = 0.0
    t_wall0 = time.perf_counter()
    if prefetch:
        from alpha_yolo_quant_tpu.data.prefetch import prefetch_batches

        batch_iter = prefetch_batches(ds, batch_size, image_size)
    else:
        batch_iter = batches(ds, batch_size, image_size)

    def drain(out, samples):
        nonlocal n_img, t_dev
        t0 = time.perf_counter()
        det, n_det = jax.device_get(out)
        t_dev += time.perf_counter() - t0
        for b, s in enumerate(samples):
            if s is None:
                continue
            n_img += 1
            ann_rows.extend(annotation_rows(s.image_id, s.boxes_xywh,
                                            s.classes, s.orig_hw))
            det_rows.extend(detection_rows(s.image_id, np.asarray(det[b]),
                                           int(n_det[b]),
                                           frame=float(image_size)))
        if progress:
            print(f"\r{n_img}/{len(ds)}", end="", flush=True)

    pending = None
    for imgs, samples in batch_iter:
        out = step(imgs)            # async dispatch
        if prefetch:
            if pending is not None:
                drain(*pending)
            pending = (out, samples)
        else:
            drain(out, samples)
    if pending is not None:
        drain(*pending)
    if progress:
        print()
    ann, det_arr = to_metric_arrays(ann_rows, det_rows)
    m, per_iou = map50_95(ann, det_arr)
    wall = time.perf_counter() - t_wall0
    return EvalResult(map50_95=m, per_iou=per_iou, n_images=n_img,
                      images_per_s=n_img / t_dev if t_dev else 0.0,
                      images_per_s_wall=n_img / wall if wall else 0.0,
                      wall_s=wall, ann_rows=ann_rows, det_rows=det_rows)
