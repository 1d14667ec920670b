"""Detect-head decode: anchors, DFL, dist2bbox, class sigmoid.

Float path equivalent to reference stage_2.py:653-668 (torch) and
stage_6.py:598-634 (numpy). The anchor layout note: for square feature maps
the reference's numpy make_anchors (utils/bbox_cls_functions.py:4-15, which
meshes (sy,sx) in 'xy' indexing and stacks (y,x)) coincides with the torch
version (stage_2.py:89-100); we implement the torch/ultralytics (x,y)
convention, which is identical at 640x640.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

STRIDES = (8, 16, 32)
GRID_CELL_OFFSET = 0.5
REG_MAX = 16
NUM_CLASSES = 80


def make_anchors(shapes: List[Tuple[int, int]], strides=STRIDES,
                 offset: float = GRID_CELL_OFFSET):
    """Anchor centers (2, N) + per-anchor stride (1, N) for the FPN levels."""
    points, strs = [], []
    for (h, w), s in zip(shapes, strides):
        sx = jnp.arange(w, dtype=jnp.float32) + offset
        sy = jnp.arange(h, dtype=jnp.float32) + offset
        gy, gx = jnp.meshgrid(sy, sx, indexing="ij")
        points.append(jnp.stack((gx.reshape(-1), gy.reshape(-1)), 0))
        strs.append(jnp.full((1, h * w), s, jnp.float32))
    return jnp.concatenate(points, 1), jnp.concatenate(strs, 1)


def dist2bbox(distance, anchor_points, xywh: bool = True):
    """ltrb distances -> xywh (or xyxy) boxes; dim 1 layout (B,4,N)
    (reference utils/bbox_cls_functions.py:32-42)."""
    lt, rb = jnp.split(distance, 2, axis=1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        c_xy = (x1y1 + x2y2) / 2
        wh = x2y2 - x1y1
        return jnp.concatenate((c_xy, wh), 1)
    return jnp.concatenate((x1y1, x2y2), 1)


def decode_float(outputs: Dict[str, jnp.ndarray], dfl_w) -> jnp.ndarray:
    """Decode the six raw head maps into (B, 4+80, N) predictions.

    box: concat (B,64,N) -> view (B,4,16,N) -> softmax over the 16 bins ->
    DFL 1x1 conv (weights arange(16)) -> dist2bbox * strides
    (reference stage_2.py:653-668).
    """
    boxes = [outputs[f"{l}_box"] for l in ("p3", "p4", "p5")]
    clss = [outputs[f"{l}_cls"] for l in ("p3", "p4", "p5")]
    b = boxes[0].shape[0]
    shapes = [(t.shape[2], t.shape[3]) for t in boxes]
    anchors, strides = make_anchors(shapes)

    box = jnp.concatenate([t.reshape(b, 4 * REG_MAX, -1) for t in boxes], 2)
    n = box.shape[2]
    # (B,4,16,N) -> softmax over bins -> expectation via the DFL weights.
    bins = box.reshape(b, 4, REG_MAX, n)
    probs = jax.nn.softmax(bins, axis=2)
    w = dfl_w.reshape(REG_MAX)
    dfl = jnp.einsum("bcrn,r->bcn", probs, w,
                     precision=jax.lax.Precision.HIGHEST)   # no TF32
    dbox = dist2bbox(dfl, anchors[None]) * strides

    cls = jnp.concatenate([t.reshape(b, NUM_CLASSES, -1) for t in clss], 2)
    cls = jax.nn.sigmoid(cls)
    return jnp.concatenate((dbox, cls), 1)
