"""Activation calibration: capture (stage-4 analog) and statistics
reduction (stage-5 analog).

Capture runs the jitted float forward with tap recording, BATCHED on the
accelerator — the reference loops COCO image-by-image on the host
(stage_4.py:975-1011); here a whole batch contributes per-image maxima in
one device step and only the (44,) stat vector returns to the host.

Reduction modes (reference utils/stage_5_common_func.py:11-26, stage_5.py):
  max | mode | median | std (mean+3*sample-std) | n=<i> (i-th largest
  unique; NOTE the reference never parses the integer and always uses its
  default n=1 — we do parse it) | min_mae (sigma-coefficient search
  minimizing |sum(x - dequant(quant(x)))|/N, reference stage_5.py:34-89).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import jax
import numpy as np

from alpha_yolo_quant_tpu.models.forward import forward_float
from alpha_yolo_quant_tpu.models.graph import Graph


def collect_stats(graph: Graph, params: Dict,
                  batches: Iterable[np.ndarray],
                  dp: Optional[int] = None) -> Dict[str, List[float]]:
    """Run calibration batches; returns tap -> list of per-image maxima.

    ``dp`` shards each batch over the first N local devices (shard_map;
    params replicate). Per-IMAGE maxima come back gathered, so every
    stage-5 reduction mode (mode/median/n=…) sees the same list as the
    single-device run — unlike the global-max all-reduce of
    parallel.mesh.sharded_forward_fn, which only serves ``max``."""

    def tap_fn(images):
        _, taps = forward_float(graph, params, images, collect_taps=True)
        return taps

    if dp:
        from alpha_yolo_quant_tpu.parallel.mesh import (
            data_parallel_step, make_mesh,
        )

        step = data_parallel_step(tap_fn, make_mesh(dp))
    else:
        step = jax.jit(tap_fn)

    records: Dict[str, List[float]] = {}
    for batch in batches:
        taps = jax.device_get(step(batch))
        for name, v in taps.items():
            records.setdefault(name, []).extend(np.asarray(v).tolist())
    return records


def collect_samples(graph: Graph, params: Dict, batches: Iterable[np.ndarray],
                    taps: List[str]) -> Dict[str, np.ndarray]:
    """Full pre-activation tensors for the given taps — the analog of the
    reference's gzip'd per-layer activation dumps used by the min_mae
    search (utils/save_weights.py:13-21)."""
    out: Dict[str, List[np.ndarray]] = {t: [] for t in taps}
    walk = jax.jit(lambda params, x: sample_walk(graph, taps, params, x))
    for batch in batches:
        captured = jax.device_get(walk(params, batch))
        for t in taps:
            out[t].append(np.asarray(captured[t]))
    return {t: np.concatenate(v, 0) for t, v in out.items()}


def sample_walk(graph: Graph, taps: List[str], params: Dict, x
                ) -> Dict[str, jax.Array]:
    """The float forward of collect_samples: returns the full
    pre-activation tensor of each conv whose tap is in ``taps``."""
    from alpha_yolo_quant_tpu.models.graph import (
        ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
        UpsampleNode,
    )
    from alpha_yolo_quant_tpu.ops.nn import (
        conv2d_f32, maxpool2d, silu, upsample_nearest,
    )

    env = {graph.input_edge: x}
    captured = {}
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            p = params[node.key]
            pre = conv2d_f32(env[node.src], p["w"], p["b"], node.stride,
                             node.padding)
            if node.tap in taps:
                captured[node.tap] = pre
            env[node.dst] = silu(pre) if node.silu else pre
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[1] // 2
            env[node.dst1] = env[node.src][:, :h]
            env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            env[node.dst] = env[node.src] + env[node.base]
        elif isinstance(node, ConcatNode):
            env[node.dst] = jax.numpy.concatenate(
                [env[e] for e in node.srcs], 1)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = maxpool2d(env[node.src], node.kernel,
                                      node.stride, node.padding)
        elif isinstance(node, UpsampleNode):
            env[node.dst] = upsample_nearest(env[node.src], node.factor)
    return captured


def save_batches(out_dir: str, samples: Dict[str, np.ndarray]) -> None:
    """Persist per-image activation dumps in the reference's artifact
    format: {out}/batches/{tap}/b_{i}.pickle, gzip compresslevel=3,
    pickle protocol 4 (reference utils/save_weights.py:13-21 save_batch).
    Each file holds one image's (1, C, H, W) pre-activation tensor."""
    import gzip
    import os
    import pickle

    for tap, arr in samples.items():
        d = os.path.join(out_dir, "batches", tap)
        os.makedirs(d, exist_ok=True)
        for i in range(arr.shape[0]):
            with gzip.open(os.path.join(d, f"b_{i}.pickle"), "wb",
                           compresslevel=3) as f:
                pickle.dump(arr[i:i + 1], f, protocol=4)


def load_batches(out_dir: str, taps: List[str]
                 ) -> Optional[Dict[str, np.ndarray]]:
    """Reload activation dumps for a RESUMABLE min_mae reduction (the
    reference re-reads them in stage 5: utils/stage_5_common_func.py:41-42
    load_from_file). Returns None if any tap's dump directory is missing
    or empty."""
    import gzip
    import os
    import pickle
    import re

    out: Dict[str, np.ndarray] = {}
    for tap in taps:
        d = os.path.join(out_dir, "batches", tap)
        if not os.path.isdir(d):
            return None
        files = sorted((f for f in os.listdir(d)
                        if re.fullmatch(r"b_\d+\.pickle", f)),
                       key=lambda f: int(f[2:-7]))
        if not files:
            return None
        parts = []
        for f in files:
            with gzip.open(os.path.join(d, f), "rb") as fh:
                parts.append(np.asarray(pickle.load(fh)))
        out[tap] = np.concatenate(parts, 0)
    return out


def _sample_std(v: np.ndarray) -> float:
    return float(np.std(v, ddof=1)) if len(v) > 1 else 0.0


# Layers whose min_mae sigma coefficient is NOT searched but fixed: the
# reference's stage 4 dumps no activation batches for the stem conv, and
# stage 5's std_koeff_update.txt writer hardcodes its coefficient
# (utils/stage_5_common_func.py:81 writes 'conv_p1: 3' ahead of the
# searched values). Taps listed here fall back to mean + koef*std when
# absent from the samples dict.
DEFAULT_MIN_MAE_KOEF = {"conv_p1": 3.0}


def reduce_stats(records: Dict[str, List[float]], mode: str = "max",
                 k: int = 8,
                 samples: Optional[Dict[str, np.ndarray]] = None,
                 ) -> Dict[str, float]:
    """Reduce per-image statistics to one calibration value per tap.

    Byte-gated against the reference's stage_5 executed from the mount
    for max/mode/median/std/n=1 and the (path-bug-healed) min_mae intent
    flow — tests/test_stage5_parity.py. The one deliberate divergence:
    ``n=<i>`` parses the integer; the reference's stage_5 never does and
    always uses its default n=1 (utils/stage_5_common_func.py:11 called
    from stage_5.py:33 with two arguments), so only n=1 is byte-gated.
    """
    out: Dict[str, float] = {"start": 1.0}
    mode_l = mode.lower()
    for name, values in records.items():
        if name.startswith("_") or name == "start":
            continue
        v = np.asarray(values, np.float64)
        if mode_l == "max":
            out[name] = float(np.abs(v).max())
        elif mode_l == "mode":
            # pandas value_counts().index[0] semantics (reference
            # utils/stage_5_common_func.py:18): among the values with
            # the top count, the one appearing FIRST in the sequence
            # wins (value_counts orders its hash table by first
            # appearance, then stable-sorts by count) — np.unique+argmax
            # would pick the smallest instead (byte-gate-proven).
            uniq, first, counts = np.unique(v, return_index=True,
                                            return_counts=True)
            top = counts == counts.max()
            out[name] = float(uniq[top][np.argmin(first[top])])
        elif mode_l == "median":
            out[name] = float(np.median(v))
        elif mode_l == "std":
            out[name] = float(v.mean() + 3 * _sample_std(v))
        elif mode_l.startswith("n="):
            n = int(mode_l[2:]) if mode_l[2:].isdigit() else 1
            uniq = np.unique(v)
            out[name] = float(uniq[max(-n - 1, -len(uniq))])
        elif mode_l == "min_mae":
            if samples is not None and name in samples:
                out[name] = min_mae_search(v, samples[name], k)[1]
            elif name in DEFAULT_MIN_MAE_KOEF:
                koef = DEFAULT_MIN_MAE_KOEF[name]
                out[name] = float(v.mean() + koef * _sample_std(v))
            else:
                raise ValueError(f"min_mae needs samples for {name}")
        else:
            raise ValueError(f"unknown calibration mode {mode}")
    return out


def min_mae_search(per_image_max: np.ndarray, acts: np.ndarray,
                   k: int, full: bool = False) -> tuple:
    """Sigma-coefficient sweep: a = mean + koef*std, koef in
    linspace(-2,4,50), minimizing |sum(x - dequant(quant(x, a)))| / N
    (reference stage_5.py:62-85 + utils/stage_5_common_func.py:50-61).
    Returns (best_koef, best_a); ties keep the LATER koef (the
    reference's ``<=`` update).

    DTYPE-FOLLOWING: the reference quantizes its f32 activation dumps in
    torch f32 (clip/scale/round all at f32 — stage_5_common_func.py:
    50-61; the int64 dequant divides back into torch's f32 default
    dtype), and promoting to f64 flips rounding ties, so every
    elementwise step here stays f32. Two documented seams that cannot be
    bit-matched and are argmin-invariant instead (margin-asserted in
    tests/test_stage5_parity.py): the f32 sum's reduction order (torch
    and numpy tree-reduce differently), and the normalization count (the
    reference divides by its fixed 500-row zero-padded buffer size,
    stage_5.py:54+74-76 — zeros quantize to 0 and add nothing to the
    sum, so N only rescales every candidate equally). A negative
    candidate ``a`` is evaluated, not skipped: the reference's
    sequential new_clip collapses the whole tensor to -a in that case
    and the MAE is still computed (stage_5_common_func.py:50-53).
    """
    qmax = 2 ** (k - 1) - 1
    v = np.asarray(per_image_max, np.float64)
    mean, std = v.mean(), _sample_std(v)
    x = np.ascontiguousarray(acts, np.float32)
    best_koef, best_a, best_err = None, None, np.inf
    errs = []
    for koef in np.linspace(-2, 4, 50):
        a = mean + koef * std          # f64, like the pandas column math
        scale = qmax / a
        a32, s32 = np.float32(a), np.float32(scale)
        # torch new_clip is SEQUENTIAL in-place: first v>a -> a, then
        # v<-a -> -a (for a<0 the second pass flattens everything to -a)
        m = np.where(x > a32, a32, x)
        m = np.where(m < -a32, -a32, m)
        q = np.rint(m * s32)           # f32 round-half-even, like torch
        deq = q.astype(np.int64).astype(np.float32) / s32
        err = float(np.abs(np.sum(x - deq) / np.float32(x.size)))
        errs.append(err)
        if err <= best_err:
            best_err, best_koef, best_a = err, float(koef), float(a)
    if full:
        return best_koef, best_a, errs
    return best_koef, best_a
