"""Batched, jittable NMS — float and integer (q_NMS) variants.

Functional equivalent of the reference's `coord`/`nms` and
`coord_quant`/`nms_quant` (quantisation/utils/bbox_cls_functions.py:49-250),
with two deliberate upgrades:
  * batched: the reference `return`s inside its batch loop and therefore only
    ever works for batch 1 (utils/bbox_cls_functions.py:192); here the whole
    pipeline is vmapped with fixed-size padding, so batched serving works.
  * O(max_det x N) vectorized greedy selection instead of a python while
    loop — identical keep-set to sequential greedy NMS.

q_NMS constants are DERIVED, not hard-coded: +412 is one pixel in anchor-
scale units (round(32767/79.5)), 2.22 approximates 1/iou_thres, and the
integer confidence threshold is conf_thres * (2^15-1) (reference
utils/bbox_cls_functions.py:82-117,195-250; see SURVEY.md §2.3.8).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class NmsParams:
    """Float-domain NMS parameters (reference utils/bbox_cls_functions.py:
    142-160)."""

    conf_thres: float = 0.25
    iou_thres: float = 0.45
    max_det: int = 300
    max_nms: int = 30000
    max_wh: float = 7680.0
    agnostic: bool = False
    # candidate pre-truncation: keep only the top-k scores before NMS.
    # None = all candidates (the reference float path); the reference q_NMS
    # itself truncates to 1000 (stage_8_torch_full_quant.py:260).
    pre_topk: int = None  # type: ignore[assignment]
    # greedy-NMS block width (power of two >= 128); purely a schedule
    # knob — the keep-set is block-size-invariant (tested)
    block: int = 128
    # Integer (q_NMS) mode: boxes are in anchor-scale units, scores in
    # 16-bit sigmoid units. `plus_one` is the +1 area term in those units.
    quantized: bool = False
    box_scale: float = 1.0       # divide boxes by this at the end
    score_scale: float = 1.0     # divide scores by this at the end
    plus_one: float = 1.0
    # DEPLOYED-runtime quirk (off by default): the reference's torch
    # q_NMS truncates xyxy candidate boxes toward zero before NMS
    # (stage_8_torch_full_quant.py:316 `.to(torch.int)`), while its own
    # numpy twin does NOT (utils/bbox_cls_functions.py:209) — a
    # reference-internal divergence. Our serving default follows the
    # numpy twin; opt in for stage-8b detection-level parity
    # (tests/test_stage8_parity.py).
    trunc_boxes: bool = False
    # Candidate-selection flavor A/B switches (all bit-identical keep
    # sets — tested; the default co-sort wins e2e, r3_sparse2/r5 select
    # logs). None = inherit the deprecated module globals below, so two
    # pipelines in one process can hold different flavors without
    # mutating process state.
    select_gather: bool = None           # type: ignore[assignment]
    select_topk_merge: bool = None       # type: ignore[assignment]


# Deprecated process-wide defaults for the selection flavors — kept so
# old probes still run; new code should set NmsParams.select_gather /
# .select_topk_merge per pipeline instead.
SELECT_GATHER = False
SELECT_TOPK_MERGE = False


def conf_sort_key(conf, n: int):
    """Packed q_NMS candidate-selection key: ``(conf + 2^15) << 14 |
    (n - 1 - index)`` — a descending sort of it reproduces the stable
    argsort's descending-score, lowest-index-first order. Requires
    n <= 2^14 and |conf| < 2^15 (17 + 14 bits in int32). The last axis
    of ``conf`` is the candidate axis; leading batch dims broadcast.

    EVERY producer of selection keys (the fast paths in
    _select_candidates and runtime.interpreter.decode_select_sparse)
    must build keys through this function — the preselected-NMS
    contract depends on the bit layout staying identical everywhere."""
    return ((conf.astype(jnp.int32) + (1 << 15)) << 14) \
        | (n - 1 - jnp.arange(n, dtype=jnp.int32))


def conf_from_key(skey):
    """Inverse of conf_sort_key's score field."""
    return (skey >> 14) - (1 << 15)


def index_from_key(skey, n: int):
    """Inverse of conf_sort_key's index field."""
    return (n - 1) - (skey & ((1 << 14) - 1))


def _co_exchange(key, vals, d, length):
    """One bitonic clean stage (descending) at distance d on the last
    axis (length L): compare-exchange elements i and i+d within blocks
    of 2d, carrying vals by the key's swap mask."""
    shape = key.shape[:-1]

    def split(t):
        return t.reshape(shape + (length // (2 * d), 2, d))

    k2 = split(key)
    swap = k2[..., 0, :] < k2[..., 1, :]
    k_hi = jnp.where(swap, k2[..., 1, :], k2[..., 0, :])
    k_lo = jnp.where(swap, k2[..., 0, :], k2[..., 1, :])
    key = jnp.stack((k_hi, k_lo), axis=-2).reshape(shape + (length,))
    out_vals = []
    for v in vals:
        v2 = split(v)
        v_hi = jnp.where(swap, v2[..., 1, :], v2[..., 0, :])
        v_lo = jnp.where(swap, v2[..., 0, :], v2[..., 1, :])
        out_vals.append(jnp.stack((v_hi, v_lo), axis=-2)
                        .reshape(shape + (length,)))
    return key, out_vals


def _select_topk_merge(key, vals, m_keep):
    """Exact descending top-m_keep of (key (N,), vals [(N,), ...]) via
    segment sorts + bitonic top-k merges.

    One full-width lax.sort runs ~log^2(N_pad) compare stages at full
    width. Here: pad to S segments of m_keep, co-sort
    each segment (full width but only log^2(m_keep) stages), then
    log2(S) bitonic merge levels, each keeping the top m_keep of a pair
    (a bitonic merge of two sorted runs fully sorts them, so the final
    run is exactly the global top-m_keep in descending key order —
    unique keys, so order is total).

    m_keep must be a power of two. Works on batched inputs too (leading
    dims broadcast). Returns (key (m_keep,), vals sorted alongside).
    """
    n = key.shape[-1]
    s = -(-n // m_keep)
    s = 1 << (s - 1).bit_length()              # segments, power of two
    n_pad = s * m_keep
    lead = key.shape[:-1]

    def pad(t, fill):
        if n_pad == n:
            return t
        cfg = [(0, 0)] * len(lead) + [(0, n_pad - n)]
        return jnp.pad(t, cfg, constant_values=fill)

    # pad key 0 sorts after every real key (real keys are >= 2^14 > 0)
    key = pad(key, 0).reshape(lead + (s, m_keep))
    vals = [pad(v, 0).reshape(lead + (s, m_keep)) for v in vals]
    srt = jax.lax.sort((-key,) + tuple(vals), num_keys=1,
                       dimension=key.ndim - 1)
    key, vals = -srt[0], list(srt[1:])
    while s > 1:
        s //= 2

        def halves(t):
            t = t.reshape(lead + (s, 2, m_keep))
            # [a desc, reverse(b) asc] is bitonic
            return jnp.concatenate((t[..., 0, :], t[..., 1, ::-1]),
                                   axis=-1)

        key = halves(key)
        vals = [halves(v) for v in vals]
        d = m_keep
        while d >= 1:
            key, vals = _co_exchange(key, vals, d, 2 * m_keep)
            d //= 2
        key = key[..., :m_keep]
        vals = [v[..., :m_keep] for v in vals]
    return key.reshape(lead + (m_keep,)), \
        [v.reshape(lead + (m_keep,)) for v in vals]


def quantized_iou_multiplier(iou_thres: float) -> float:
    """The q_NMS intersection multiplier, DERIVED from the IoU threshold:
    the reference hard-codes 2.22 = round(1/0.45, 2)
    (utils/bbox_cls_functions.py:108). Emitting exactly 2.22 at 0.45 keeps
    keep-set parity; any other threshold derives the same way."""
    return round(1.0 / float(iou_thres), 2)


def q_nms_params(anchor_scale: float, iou_thres: float = 0.45,
                 conf_thres_int: int = 8192,
                 score_scale: float = 32767.0) -> NmsParams:
    """Derive the q_NMS parameter set from the anchor scale (reference
    hard-codes 412 / 412.1635 / 8192 / 2.22 for K=16, anchors max 79.5)."""
    return NmsParams(conf_thres=float(conf_thres_int), iou_thres=iou_thres,
                     quantized=True, box_scale=float(anchor_scale),
                     score_scale=score_scale, pre_topk=1000,
                     plus_one=float(int(round(anchor_scale))))


def xywh2xyxy(x):
    """(..., 4) xywh -> xyxy (reference utils/bbox_cls_functions.py:120-139)."""
    dw = x[..., 2] / 2
    dh = x[..., 3] / 2
    return jnp.stack((x[..., 0] - dw, x[..., 1] - dh,
                      x[..., 0] + dw, x[..., 1] + dh), axis=-1)


def _suppress_slice(xyxya, xyxya_b, iou_thres, plus_one, quantized):
    """Pairwise suppress predicate between all candidates (n) and one
    block (blk): returns (n, blk) bf16 0/1 (exact — the mask is boolean).

    Quantized mode mirrors the reference op order: nms_quant mutates inter
    IN PLACE before the union (`inter *= 2.22`,
    utils/bbox_cls_functions.py:108-110 and the torch twin
    stage_8_torch_full_quant.py:280-283), so the union term uses the
    SCALED intersection: suppress when  m*inter > a_i + a_j - m*inter
    with m = round(1/iou_thres, 2) (2.22 at the reference's 0.45).
    f32 matches the deployed torch reference; the numpy f64 golden may
    differ within ~2^-24 of the boundary (the references disagree there
    too)."""
    x1, y1, x2, y2, areas = xyxya
    bx1, by1, bx2, by2, bareas = xyxya_b
    xx1 = jnp.maximum(x1[:, None], bx1[None, :])
    yy1 = jnp.maximum(y1[:, None], by1[None, :])
    xx2 = jnp.minimum(x2[:, None], bx2[None, :])
    yy2 = jnp.minimum(y2[:, None], by2[None, :])
    w = jnp.maximum(0.0, xx2 - xx1 + plus_one)
    h = jnp.maximum(0.0, yy2 - yy1 + plus_one)
    inter = w * h
    asum = areas[:, None] + bareas[None, :]
    if quantized:
        t = inter * jnp.float32(quantized_iou_multiplier(iou_thres))
        sup = t > asum - t
    else:
        sup = inter / (asum - inter) > iou_thres
    return sup.astype(jnp.bfloat16)


def _jacobi_keep(v_b, t_b, blk: int):
    """Resolve one block's internal suppression DAG by Jacobi iteration:
    fixpoint of k = v & ~(k @ t_b > 0.5), reached in chain-depth steps
    (bounded by blk). 4 steps per while iteration: convergence typically
    needs <= 5 and each while iteration carries fixed scheduling
    overhead — extra steps past the fixpoint are exact no-ops. Shared by
    the unrolled and scan block loops (their keep-sets must stay
    identical)."""

    def cond(c):
        k, prev, it = c
        return (it < blk) & jnp.any(k != prev)

    def body(c):
        k, _, it = c
        prev = k
        for _ in range(4):
            # 0/1 operands: exact in bf16 (and in TF32), only > 0 is read
            killed = (k.astype(jnp.bfloat16) @ t_b) > 0.5
            k, prev = v_b & ~killed, k
        return k, prev, it + 1

    k_b, _, _ = jax.lax.while_loop(
        cond, body, (v_b, jnp.zeros_like(v_b), jnp.int32(0)))
    return k_b


def _greedy_nms_mask(boxes, scores, valid, iou_thres, max_det, plus_one,
                     quantized, presorted: bool = False, block: int = 128):
    """Greedy NMS over score-sorted padded candidates.

    boxes: (N,4) xyxy (already class-offset); scores: (N,); valid: (N,)
    bool. Returns keep mask (N,) with at most max_det True — identical to
    sequential greedy NMS. presorted=True promises descending-score order
    with invalid candidates at the END (what _select_candidates emits) and
    skips the rank permutation (two N^2 gathers).

    Implementation: blocked greedy. Candidates are processed in score
    order in 128-wide blocks: each block is first pruned by everything
    already kept (one matvec), then its internal suppression
    DAG is resolved by Jacobi iteration — bounded by the block size
    instead of the GLOBAL chain depth (dense candidate sets have ~N-deep
    chains). The suppress matrix is
    built one (N, 128) slice at a time inside the loop — the full (N, N)
    matrix is never materialized.

    The outer block loop is a STATIC lax.scan over all blocks, not a
    while with a data-dependent trip count (XLA cannot schedule across
    a dynamic-trip while), and mostly-empty trailing blocks converge in
    one Jacobi step."""
    n = boxes.shape[0]
    if not presorted:
        perm = jnp.argsort(-jnp.where(valid, scores, -jnp.inf), stable=True)
        boxes = boxes[perm]
        valid = valid[perm]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + plus_one) * (y2 - y1 + plus_one)

    blk = block
    n_blocks = -(-n // blk)
    n_pad = n_blocks * blk

    def pad(v):
        return jnp.pad(v, (0, n_pad - v.shape[0]))

    x1p, y1p, x2p, y2p, areasp = (pad(v) for v in
                                  (x1, y1, x2, y2, areas))
    xyxya = (x1p, y1p, x2p, y2p, areasp)   # padded rows are never kept
    validp = pad(valid)
    tri = (jnp.arange(blk)[:, None] < jnp.arange(blk)[None, :]).astype(
        jnp.bfloat16)

    if n_blocks <= 16:
        # static unroll: block k only needs suppress rows [0, end) — rows
        # after the block have kept == 0 and contribute nothing to
        # pre_kill (exact; keep-set parity tested). The uniform-shape
        # scan below computes all n_pad rows for every block: the
        # (n_pad, blk) f32 slice builds were the NMS byte sink on the r3
        # profiler trace (2 x 67 MB per block at B=128). Triangle-shaped
        # slices cut pair bytes ~44% and drop the scan carry overhead.
        kept = areasp * jnp.float32(0)
        for bi in range(n_blocks):
            start, end = bi * blk, (bi + 1) * blk
            xyxya_cut = tuple(v[:end] for v in xyxya)
            xyxya_b = tuple(v[start:end] for v in xyxya)
            s_col = _suppress_slice(xyxya_cut, xyxya_b, iou_thres,
                                    plus_one, quantized)    # (end, blk)
            # 0/1 operands: exact in bf16 (and in TF32), only > 0 is read
            pre_kill = (kept[:end].astype(jnp.bfloat16) @ s_col) > 0.5
            v_b = validp[start:end] & ~pre_kill
            t_b = s_col[start:end] * tri
            k_b = _jacobi_keep(v_b, t_b, blk)
            kept = jax.lax.dynamic_update_slice(
                kept, k_b.astype(jnp.float32), (start,))
        keep_sorted = kept[:n] > 0.5
        within = jnp.cumsum(keep_sorted.astype(jnp.int32)) <= max_det
        keep_sorted = keep_sorted & within
        if not presorted:
            return jnp.zeros((n,), bool).at[perm].set(keep_sorted)
        return keep_sorted
    blkdat = tuple(v.reshape(n_blocks, blk)
                   for v in (x1p, y1p, x2p, y2p, areasp)) \
        + (validp.reshape(n_blocks, blk),
           jnp.arange(n_blocks, dtype=jnp.int32) * blk)

    def blk_body(kept, dat):
        bx1, by1, bx2, by2, bareas, v_row, start = dat
        xyxya_b = (bx1, by1, bx2, by2, bareas)
        s_col = _suppress_slice(xyxya, xyxya_b, iou_thres, plus_one,
                                quantized)                   # (n_pad, blk)
        # prune by everything already kept: kept rows all rank before
        # this block, so no explicit rank test is needed
        # 0/1 operands: exact in bf16 (and in TF32), only > 0 is read
        pre_kill = (kept.astype(jnp.bfloat16) @ s_col) > 0.5
        v_b = v_row & ~pre_kill
        # block-internal DAG: this block vs itself
        t_b = jax.lax.dynamic_slice(s_col, (start, 0), (blk, blk)) * tri
        k_b = _jacobi_keep(v_b, t_b, blk)
        kept = jax.lax.dynamic_update_slice(
            kept, k_b.astype(jnp.float32), (start,))
        return kept, None

    # carry init derived from the data (areasp*0) so its varying-axis
    # type matches the body output under shard_map
    kept, _ = jax.lax.scan(blk_body, areasp * jnp.float32(0), blkdat)
    keep_sorted = kept[:n] > 0.5
    # truncate the survivor list to max_det in score order
    # (reference coord: i = i[:max_det])
    within = jnp.cumsum(keep_sorted.astype(jnp.int32)) <= max_det
    keep_sorted = keep_sorted & within
    if not presorted:
        # scatter back to the caller's candidate order
        return jnp.zeros((n,), bool).at[perm].set(keep_sorted)
    return keep_sorted


def _select_candidates(pred, max_nms, conf_thres, pre_topk=None,
                       int_scores=False, select_gather=None,
                       select_topk_merge=None):
    """pred: (84, N) plane, or a pre-reduced (boxes_xywh (4,N), conf (N,),
    cls (N,)) tuple (decode_full_quant(reduce_cls=True) serving path) ->
    fixed-size top-k candidate set, score-sorted.
    Returns (boxes_xyxy (M,4), conf (M,), cls (M,), valid (M,))."""
    if isinstance(pred, tuple):
        bxywh, conf, cls = pred
        box = xywh2xyxy(bxywh.T)               # (N,4)
    else:
        box = xywh2xyxy(pred[:4].T)            # (N,4)
        cls_scores = pred[4:]                  # (80, N)
        conf = jnp.max(cls_scores, axis=0)
        cls = jnp.argmax(cls_scores, axis=0).astype(jnp.float32)
    n = conf.shape[0]
    m = min(pre_topk or max_nms, max_nms, n)
    if select_gather is None:
        select_gather = SELECT_GATHER
    if select_topk_merge is None:
        select_topk_merge = SELECT_TOPK_MERGE
    if int_scores and n <= (1 << 14) and select_topk_merge:
        key = conf_sort_key(conf, n)
        m_keep = 1 << (max(m, 2) - 1).bit_length()
        kk, vv = _select_topk_merge(
            key, [box[:, 0], box[:, 1], box[:, 2], box[:, 3], cls],
            m_keep)
        skey = kk[:m]
        conf_s = conf_from_key(skey).astype(conf.dtype)
        boxes_s = jnp.stack([v[:m] for v in vv[:4]], 1)
        return boxes_s, conf_s, vv[4][:m], conf_s > conf_thres
    if int_scores and n <= (1 << 14) and select_gather:
        # single-key sort + top-k gathers: sort ONLY the packed int key
        # (same order as the co-sort below) and gather the box columns /
        # class ids at the kept m indices. The 6-operand co-sort moves
        # every operand through all ~log^2(n) merge passes; the key-only
        # sort moves one operand and the (B,m)-sized gathers are small.
        key = conf_sort_key(conf, n)
        skey = -jax.lax.sort(-key)[:m]
        conf_s = conf_from_key(skey).astype(conf.dtype)
        idx = index_from_key(skey, n)
        return box[idx], conf_s, cls[idx], conf_s > conf_thres
    if int_scores and n <= (1 << 14):
        # q_NMS fast path: scores are integer-valued (16-bit sigmoid ints,
        # or pre-sigmoid requantized ints in [-(2^15-1), 2^15-1]). Pack
        # (score + 2^15) << 14 | (n-1-idx) into ONE int32 key (17+14 bits)
        # whose descending sort gives exactly the stable argsort's
        # descending-score, lowest-index-first order — and CO-SORT the box
        # columns and class ids as extra lax.sort operands, so no gathers
        # at all.
        key = conf_sort_key(conf, n)
        srt = jax.lax.sort(
            (-key, box[:, 0], box[:, 1], box[:, 2], box[:, 3], cls),
            num_keys=1)
        skey = -srt[0][:m]
        conf_s = conf_from_key(skey).astype(conf.dtype)
        boxes_s = jnp.stack([srt[i][:m] for i in (1, 2, 3, 4)], 1)
        # validity re-derived from sorted scores: the conf_thres cut is
        # monotone in score, so valid candidates still precede invalid
        return boxes_s, conf_s, srt[5][:m], conf_s > conf_thres
    valid = conf > conf_thres
    score_for_sort = jnp.where(valid, conf, -jnp.inf)
    # argsort-based top-k: XLA's batched TopK lowering is catastrophically
    # slow on this backend for large k (measured 19s vs 4.5ms at
    # (128, 8400) k=1000); a full descending sort is cheap and gives the
    # stable lowest-index tie order the NMS rank matrix assumes.
    idx = jnp.argsort(-score_for_sort)[:m]
    return box[idx], conf[idx], cls[idx], valid[idx]


def non_max_suppression(preds, params: NmsParams = NmsParams(),
                        score_map=None, preselected: bool = False):
    """Batched NMS.

    preds: (B, 4+nc, N) in xywh + class scores (float; for q_NMS these are
    integer-valued floats in anchor/sigmoid scale units), or the
    pre-reduced tuple (boxes_xywh (B,4,N), conf (B,N), cls (B,N)) from
    decode_full_quant(reduce_cls=True).

    preselected=True: preds is the already-selected candidate tuple
    (boxes_xyxy (B,m,4), conf (B,m), cls (B,m), valid (B,m)) in
    descending (conf, lowest-index-first) order — the output contract of
    runtime.interpreter.decode_select_sparse — and the per-image select
    stage is skipped.

    score_map: optional MONOTONE map applied to the kept rows' confidences
    before descaling (the serving path defers the 16-bit sigmoid LUT here —
    ranking and thresholding commute with a monotone map, so the result is
    unchanged up to the ordering of exact score ties, which the reference's
    unstable argsort does not define either).

    Returns (det, n_det): det is (B, max_det, 6) rows [x1,y1,x2,y2,conf,cls]
    (descaled for q_NMS), n_det (B,) the number of valid rows. Padding rows
    are zero.
    """
    p = params

    def single(pred):
        if preselected:
            boxes, conf, cls, valid = pred
        else:
            boxes, conf, cls, valid = _select_candidates(
                pred, p.max_nms, jnp.float32(p.conf_thres), p.pre_topk,
                int_scores=p.quantized, select_gather=p.select_gather,
                select_topk_merge=p.select_topk_merge)
        if p.trunc_boxes:
            boxes = jnp.trunc(boxes)
        offset = cls * (0.0 if p.agnostic else p.max_wh)
        shifted = boxes + offset[:, None]
        # _select_candidates returns descending-score candidates with the
        # invalid ones at the end — the presorted fast path applies
        keep = _greedy_nms_mask(shifted, conf, valid, p.iou_thres,
                                p.max_det, p.plus_one, p.quantized,
                                presorted=True, block=p.block)
        # compact kept rows to the front, at most max_det of them:
        # kept-first co-sort — one int key (keep << bits | reverse-rank)
        # carries the 6 row columns as extra lax.sort operands, replacing
        # the argsort + 3 gathers
        m = boxes.shape[0]
        sh = int(m).bit_length()
        key = (keep.astype(jnp.int32) << sh) \
            | (m - jnp.arange(m, dtype=jnp.int32))
        srt = jax.lax.sort((-key, boxes[:, 0], boxes[:, 1], boxes[:, 2],
                            boxes[:, 3], conf, cls), num_keys=1)
        keep_sorted = ((-srt[0]) >> sh) > 0
        conf_out = srt[5]
        if score_map is not None:
            conf_out = score_map(conf_out)
        rows = jnp.stack(
            (srt[1] / p.box_scale, srt[2] / p.box_scale,
             srt[3] / p.box_scale, srt[4] / p.box_scale,
             conf_out / p.score_scale, srt[6]), axis=1)
        rows = jnp.where(keep_sorted[:, None], rows, 0.0)
        n = jnp.sum(keep_sorted.astype(jnp.int32))
        if rows.shape[0] < p.max_det:   # fixed serving shape (B, max_det, 6)
            pad = jnp.zeros((p.max_det - rows.shape[0], 6), rows.dtype)
            rows = jnp.concatenate((rows, pad), 0)
        return rows[:p.max_det], n

    return jax.vmap(single)(preds)


def clip_boxes(boxes, hw):
    """Clip xyxy boxes to (h, w) (reference utils/bbox_cls_functions.py:
    258-273)."""
    h, w = hw
    return jnp.stack((jnp.clip(boxes[..., 0], 0, w),
                      jnp.clip(boxes[..., 1], 0, h),
                      jnp.clip(boxes[..., 2], 0, w),
                      jnp.clip(boxes[..., 3], 0, h)), axis=-1)


def scale_boxes(model_hw, boxes, orig_hw):
    """Map boxes from the model's letterboxed frame back to the original
    image (reference utils/bbox_cls_functions.py:276-308)."""
    gain = min(model_hw[0] / orig_hw[0], model_hw[1] / orig_hw[1])
    pad_x = round((model_hw[1] - orig_hw[1] * gain) / 2 - 0.1)
    pad_y = round((model_hw[0] - orig_hw[0] * gain) / 2 - 0.1)
    shifted = jnp.stack((boxes[..., 0] - pad_x, boxes[..., 1] - pad_y,
                         boxes[..., 2] - pad_x, boxes[..., 3] - pad_y),
                        axis=-1)
    return clip_boxes(shifted / gain, orig_hw)
