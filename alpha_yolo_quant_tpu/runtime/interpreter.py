"""Pure-jnp integer interpreter for the quantized network.

Bit-exact with the reference pipeline using int32 tensors, the emulated
widening requantizer (ops/intmath.py), and exact integer convolutions
(bf16 with exact f32 accumulation, or s8 x s8 -> s32; ops/nn.py). Jittable
end to end; the same function runs on the virtual CPU mesh in tests and on
the GPU.

The SiLU multiplier folding: requant2( sigma_q * acc ) is computed as
requantize_i32(acc, m = sigma_q * r2, s2) — exact because integer
multiplication is associative and m < 2^15 (see ops/intmath.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


import jax
import jax.numpy as jnp
import numpy as np

from alpha_yolo_quant_tpu.models.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from alpha_yolo_quant_tpu.models.head import dist2bbox, make_anchors
from alpha_yolo_quant_tpu.ops.intmath import (
    requantize_i32, requantize_i32_bigshift,
    requantize_i32_bigshift_folded, requantize_i32_direct,
    requantize_i32_small,
)
from alpha_yolo_quant_tpu.ops.nn import (
    conv2d_int_exact, maxpool2d, upsample_nearest,
)
from alpha_yolo_quant_tpu.quantize.transform import QuantizedModel


def device_plan(model: QuantizedModel) -> Dict:
    """Convert the host plan into a pytree of device arrays (the closure
    constants of the jitted forward). LUTs become validated arithmetic
    recomputations (ops/lutfast.py) that fuse into the elementwise
    epilogues instead of per-element gathers. LUT corrections are
    validated on the CURRENT default backend: call device_plan with the
    execution backend as the JAX default (a plan built on CPU is not
    bit-exact on the GPU; use FastLut.for_current_backend to re-validate
    after a backend switch)."""
    from alpha_yolo_quant_tpu.ops.lutfast import build_fast_lut

    plan: Dict = {"convs": {}, "requants": {},
                  "sig_lut": build_fast_lut(model.sig_lut, "sigmoid")}
    # the SiLU epilogue uses the mask-free apply_clipped: its domain
    # input is clipped to +-qmax, which the table must cover
    assert (model.sig_lut.lo <= -model.cfg.qmax
            and model.sig_lut.hi >= model.cfg.qmax), \
        "sigmoid LUT domain must cover the clipped requant range"
    for name, c in model.convs.items():
        d = {"w": jnp.asarray(c.w_q, jnp.int32),
             "w_hwio": jnp.asarray(c.w_q.transpose(2, 3, 1, 0), jnp.int32),
             "w_i8": jnp.asarray(c.w_q, jnp.int8),
             "w_hwio_i8": jnp.asarray(c.w_q.transpose(2, 3, 1, 0),
                                      jnp.int8),
             "b": jnp.asarray(c.b_q, jnp.int32).reshape(1, -1, 1, 1)}
        if (c.node.kernel == 3 and c.node.stride == 2
                and c.node.padding == 1 and c.w_q.shape[1] <= 16
                and c.bf16_single_ok):
            from alpha_yolo_quant_tpu.ops.nn import s2d_weights

            d["w_s2d_i8"] = jnp.asarray(s2d_weights(c.w_q), jnp.int8)
        if c.bf16_offset is not None:
            # offset-folded bf16 bias: b + c*sum(w) per out channel —
            # engine-side only (plan.b_q and every export stay the
            # reference values); see ConvPlan.bf16_offset
            sw = np.int64(c.w_q).reshape(c.w_q.shape[0], -1).sum(1)
            d["b_off"] = jnp.asarray(
                np.int64(c.b_q) + c.bf16_offset * sw,
                jnp.int32).reshape(1, -1, 1, 1)
        if c.node.silu:
            for f in ("r1", "s1", "r2", "s2"):
                d[f] = jnp.asarray(getattr(c, f), jnp.int32)
        plan["convs"][name] = d
    for key, r in model.requants.items():
        plan["requants"][key] = (jnp.int32(r.rescale), jnp.int32(r.shift))
    if model.head is not None:
        h = model.head
        plan["head"] = {
            "box_r": {k: jnp.asarray(v) for k, v in h.box_r.items()},
            "box_s": {k: jnp.asarray(v) for k, v in h.box_s.items()},
            "cls_r": {k: jnp.asarray(v) for k, v in h.cls_r.items()},
            "cls_s": {k: jnp.asarray(v) for k, v in h.cls_s.items()},
            "exp_lut": build_fast_lut(h.exp_lut, "exp"),
            "cls_sig_lut": build_fast_lut(h.cls_sigmoid_lut, "sigmoid"),
            "dfl_w": jnp.asarray(h.dfl_w_q, jnp.int32).reshape(16),
        }
    return plan


def quantize_input(x, k: int, per_image_amax: bool = False,
                   out_dtype=jnp.int8, s2d: bool = False):
    """Image -> int K-bit values.

    Default pins a=1 like the golden pipeline (reference
    utils/quant_matrix.py:70-72 start=True); per_image_amax reproduces the
    stage-8 runtime quirk of re-deriving a per image
    (stage_8_torch.py:510 with start=False).

    out_dtype: int8 by default; the bf16-storage engines request bf16
    directly (exact — every value is an integer <= 127), skipping an
    int8 materialize + convert pass at the stem.

    s2d=True emits the space-to-depth(2) view (B, 12, H/2, W/2) in one
    fused pass (the transpose rides the quantize read); int_forward's
    stem conv then consumes it via the exact 2x2 rewrite
    (ops/nn.conv2d_bf16_s2d_exact).

    uint8 ingest: x may be raw uint8 pixels (the serving-faithful input
    — JPEG decode yields u8, and shipping u8 to the device moves 4x
    fewer bytes than f32). The normalize x = u/255 runs HERE in f32 —
    IEEE division is correctly rounded, so the result is bit-identical
    to a host float loader computing u/255 and feeding f32 (the
    reference's dataloader contract). The divide fuses into the
    quantize pass: the fusion then reads 157 MB of u8 instead of 629 MB
    of f32 at B=128/640.
    """
    if x.dtype == jnp.uint8:
        x = x.astype(jnp.float32) / jnp.float32(255.0)
    if k > 8:
        raise ValueError(f"k={k}: quantized inputs are carried as int8; "
                         "K > 8 would silently wrap (QuantConfig enforces "
                         "the same ceiling)")
    qmax = 2 ** (k - 1) - 1
    if per_image_amax:
        a = jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True)
        s = qmax / a
    else:
        a, s = 1.0, float(qmax)
    q = jnp.round(jnp.clip(x, -a, a) * s).astype(out_dtype)
    if s2d:
        from alpha_yolo_quant_tpu.ops.nn import space_to_depth2

        q = space_to_depth2(q)
    return q


ENGINES = ("xla", "s8", "auto", "nhwc", "s8_nhwc")


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; engines: "
                         f"{', '.join(ENGINES)}")


# Auto conv-flavor: also run stride-2 3x3 layers as the exact
# single-pass bf16 conv where bf16_single_ok. Flag so probes can A/B it
# (bit-exact either way).
AUTO_BF16_S2 = True

# Space-to-depth rewrite of the narrow (C_in <= 16) stride-2 3x3 convs:
# 2x2 stride-1 conv over the (B, C*4, H/2, W/2) view with remapped
# weights (ops/nn.conv2d_bf16_s2d_exact). Bit-exact (integer partial
# sums < 2^24 make the f32 accumulation order-independent). A/B flag.
AUTO_S2D = False

# Sibling-conv merge: convs that read the SAME input edge with identical
# (kernel, stride, padding) geometry run as ONE conv with the weight
# tensors concatenated along C_out; each member's epilogue then reads
# its accumulator slice (slices fuse into the epilogue pass). Bit-exact:
# every output channel's dot product is computed identically — merging
# only adds independent channels. The win is structural: the shared
# input (the c2f15 edge for the p3 head pair) is read from device memory
# once instead of per-conv. In this graph the groups are the three
# detect-head stem pairs ({level}_up_0 / {level}_down_0). A/B flag, off:
# no measurement on the GPU has shown it winning yet.
AUTO_MERGE_SIBLINGS = False


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Per-pipeline engine A/B options.

    Each tri-state field defaults to ``None`` = inherit the deprecated
    module-level global of the same spelling (AUTO_BF16_S2 / AUTO_S2D /
    AUTO_MERGE_SIBLINGS), which preserves old probes; passing an explicit
    bool scopes the choice to ONE pipeline, so two pipelines with
    different flavors coexist in a process without mutating module state
    (all flavors are bit-identical — tested).

    per_image_amax: quantize the input with a per-image amax instead of
    the calibrated a=1 pin — the stage-8 deployed-runtime quirk
    (reference stage_8_torch.py:510, quant_matrix start=False): the
    runtime re-derives the input scale per image but keeps the rescale
    coefficients computed from the CALIBRATION scale. Needed for
    detection-level parity with the reference's stage_8/8b torch
    runtimes; off for the stage-6/golden contract.
    """

    bf16_s2: bool = None             # type: ignore[assignment]
    s2d: bool = None                 # type: ignore[assignment]
    merge_siblings: bool = None      # type: ignore[assignment]
    per_image_amax: bool = False

    @property
    def bf16_s2_(self) -> bool:
        return AUTO_BF16_S2 if self.bf16_s2 is None else self.bf16_s2

    @property
    def s2d_(self) -> bool:
        return AUTO_S2D if self.s2d is None else self.s2d

    @property
    def merge_siblings_(self) -> bool:
        return (AUTO_MERGE_SIBLINGS if self.merge_siblings is None
                else self.merge_siblings)


def _sibling_merge_groups(model: QuantizedModel, bf16_s2: bool = None):
    """Shared-input conv groups eligible for the merged-conv execution:
    same src edge + identical geometry, all SiLU, all bf16_single_ok
    (the merged conv runs the single-pass bf16 path). Returns
    {first_member_name: [ConvNode, ...]} in graph order."""
    if bf16_s2 is None:
        bf16_s2 = AUTO_BF16_S2
    by_sig: Dict = {}
    for node in model.graph.nodes:
        if not isinstance(node, ConvNode):
            continue
        cp = model.convs[node.name]
        if not (node.silu and cp.bf16_single_ok
                and (node.stride == 1 or bf16_s2)):
            continue
        sig = (node.src, node.kernel, node.stride, node.padding)
        by_sig.setdefault(sig, []).append(node)
    return {g[0].name: g for g in by_sig.values() if len(g) > 1}


def int_forward(model: QuantizedModel, plan: Dict, x_q,
                keep_env: bool = False,
                engine: str = "xla",
                head_requant: bool = False,
                options: "EngineOptions" = None,
                node_range=None, env_in=None,
                out_edges=None) -> Dict[str, jnp.ndarray]:
    """Run the integer graph. Returns the head-output edges (raw int32
    NCHW accumulators for the six head convs) plus, with keep_env, every
    edge and the pre-SiLU requantized accumulators under
    '<conv name>:sigdom'.

    engine (one of ENGINES):
      'xla'     bf16 nibble-split convs, pure-jnp ops, NCHW (debug/export)
      's8'      exact s8 x s8 -> int32 convs (ops/nn.conv2d_s8_exact);
                9-bit concat inputs take clip+remainder parts
      'auto'    per-layer flavor from plan flags: exact single-pass bf16
                where the accumulation bound allows, s8 otherwise
      'nhwc'    nibble-split convs with NHWC activations
      's8_nhwc' s8 convs with NHWC activations
    head_requant: apply the full-quant head's first requant stage to the
    six head accumulators INSIDE the forward (box -> int8 at the fixed
    DFL scale, cls -> int16 at scale(12,16)); decode_full_quant must then
    be called with pre_requantized=True. Bit-exact — the identical
    requantize_i32 constants run one fusion boundary earlier — and the
    forward->decode seam then moves ~1/3 of the int32 accumulator bytes.

    All engines produce bit-identical results (tested).

    options: per-pipeline EngineOptions; None inherits the deprecated
    module globals (see EngineOptions).

    Segmented execution (the pipeline-parallel seam, parallel/pipeline.py):
    pass node_range=(lo, hi) with env_in (the stage's live input edges —
    x_q is ignored) and out_edges (edge names to return). The SAME node
    loop runs over the slice, so a chain of segments is bit-identical to
    the whole-graph call by construction; head_requant/outputs collection
    are skipped (the caller owns the seams)."""
    check_engine(engine)
    if options is None:
        options = EngineOptions()
    segmented = node_range is not None
    if segmented or env_in is not None or out_edges is not None:
        # hard errors, not asserts: under `python -O` a stripped assert
        # would silently run the whole graph ignoring env_in
        if not (segmented and env_in is not None and out_edges is not None):
            raise ValueError(
                "segmented execution needs node_range + env_in + out_edges")
        if engine not in ("xla", "s8", "auto") or keep_env:
            raise ValueError(
                "segments run the plain NCHW engines (no keep_env/nhwc)")
    cfg = model.cfg
    qmax = cfg.qmax
    nhwc = engine in ("nhwc", "s8_nhwc") and not keep_env
    use_s8 = engine in ("s8", "s8_nhwc", "auto") and not keep_env
    auto_flavor = engine == "auto" and not keep_env
    # Inter-layer activations are stored as bf16 in the auto engine:
    # every stored value is an integer with |v| <= 127 (the
    # epilogue clips to qmax), exactly representable in bf16 (<= 256),
    # and the dominant consumer — the single-pass bf16 conv — then needs
    # no int8->bf16 convert pass through HBM. Integer consumers cast
    # back (exact). Wide (9-bit) edges stay int32 as before.
    bf16_store = auto_flavor
    if use_s8:
        from alpha_yolo_quant_tpu.ops.nn import (
            conv2d_bf16_exact, conv2d_s8_exact,
        )
    cax = 3 if nhwc else 1
    if nhwc:
        x_q = x_q.transpose(0, 2, 3, 1)

    def cshape(t):
        """Per-channel (1,C,1,1) constant in the active layout."""
        return t.reshape(1, 1, 1, -1) if nhwc else t

    def finish_conv(node, c, acc):
        """Post-accumulator epilogue: SiLU requant chain (or raw
        accumulator for plain head convs) + activation store. Shared by
        the per-node path and the merged-sibling path — bit-exactness
        across them depends on this staying the single implementation."""
        if node.silu:
            cp = model.convs[node.name]
            # fastest proven-exact formulation per requant (flags
            # checked against the true accumulator bound at plan
            # time; all four produce identical bits — see
            # ops/intmath.py)
            req1 = (requantize_i32_direct if cp.req1_direct_ok
                    else requantize_i32_bigshift_folded if cp.fold1_ok
                    else requantize_i32_bigshift if cp.bigshift_ok
                    else requantize_i32)
            req2 = (requantize_i32_bigshift_folded if cp.fold2_ok
                    else requantize_i32_bigshift if cp.bigshift_ok
                    else requantize_i32)
            dom = req1(acc, cshape(c["r1"]), cshape(c["s1"]), qmax)
            if keep_env:
                env[f"{node.name}:sigdom"] = dom
            # dom is clipped to +-qmax: mask-free LUT apply
            sigma = plan["sig_lut"].apply_clipped(dom)
            m = sigma * cshape(c["r2"])   # < 2^15, exact folding
            out = req2(acc, m, cshape(c["s2"]), qmax)
            if bf16_store:
                env[node.dst] = out.astype(jnp.bfloat16)
            elif use_s8:
                env[node.dst] = out.astype(jnp.int8)
            else:
                env[node.dst] = out
        else:
            env[node.dst] = acc

    merge_groups = (_sibling_merge_groups(model, options.bf16_s2_)
                    if (options.merge_siblings_ and engine == "auto"
                        and not keep_env) else {})
    merge_skip: set = set()

    env: Dict[str, jnp.ndarray] = (
        dict(env_in) if segmented else {model.graph.input_edge: x_q})

    lo, hi = node_range if segmented else (0, len(model.graph.nodes))
    for idx in range(lo, hi):
        node = model.graph.nodes[idx]
        if isinstance(node, ConvNode):
            if node.name in merge_skip:
                continue
            group = merge_groups.get(node.name)
            if group is not None:
                cs = [plan["convs"][m.name] for m in group]
                w_cat = jnp.concatenate([cc["w_i8"] for cc in cs], axis=0)
                # conv2d_bf16_exact is bound above: merge_groups is only
                # non-empty for engine == "auto", which implies use_s8
                acc_m = conv2d_bf16_exact(env[node.src], w_cat,
                                          node.stride, node.padding)
                off = 0
                for m, cc in zip(group, cs):
                    acc = jax.lax.slice_in_dim(acc_m, off, off + m.cout,
                                               axis=1) + cc["b"]
                    finish_conv(m, cc, acc)
                    off += m.cout
                merge_skip.update(mm.name for mm in group[1:])
                continue
            c = plan["convs"][node.name]
            if use_s8:
                in_amax = model.edge_amax_int[node.src]
                s8_parts = -(-in_amax // 127)   # ceil: 1, 2 or 3
                cp_m = model.convs[node.name]
                prefer_bf16 = (auto_flavor
                               and (cp_m.bf16_single_ok
                                    or cp_m.bf16_offset is not None)
                               and (node.kernel == 1 or node.stride == 1
                                    or options.bf16_s2_))
                if prefer_bf16 and cp_m.bf16_offset is not None:
                    # wide input edge, proven range width <= 512: shift
                    # by the plan's offset into bf16's exact-int window
                    # and add the c*sum(w)-folded bias — identical
                    # accumulator bits by linearity (pad == 0; see
                    # ConvPlan.bf16_offset)
                    x_sh = env[node.src].astype(jnp.int32) - cp_m.bf16_offset
                    acc = conv2d_bf16_exact(x_sh, c["w_i8"], node.stride,
                                            node.padding) + c["b_off"]
                elif prefer_bf16:
                    x_in = env[node.src]
                    w_s2d = c.get("w_s2d_i8")
                    pre_s2d = (w_s2d is not None
                               and x_in.shape[1] == w_s2d.shape[1])
                    if pre_s2d or (options.s2d_ and w_s2d is not None
                                   and x_in.shape[2] % 2 == 0
                                   and x_in.shape[3] % 2 == 0):
                        from alpha_yolo_quant_tpu.ops.nn import (
                            conv2d_bf16_s2d_exact,
                        )

                        acc = conv2d_bf16_s2d_exact(
                            x_in, w_s2d, pre_s2d=pre_s2d) + c["b"]
                    else:
                        acc = conv2d_bf16_exact(x_in, c["w_i8"],
                                                node.stride,
                                                node.padding) + c["b"]
                else:
                    acc = conv2d_s8_exact(
                        env[node.src],
                        c["w_hwio_i8"] if nhwc else c["w_i8"],
                        node.stride, node.padding, parts=s8_parts,
                        nhwc=nhwc) + cshape(c["b"])
            else:
                acc = conv2d_int_exact(
                    env[node.src], c["w_hwio"] if nhwc else c["w"],
                    node.stride, node.padding, nhwc=nhwc) + cshape(c["b"])
            finish_conv(node, c, acc)
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[cax] // 2
            if nhwc:
                env[node.dst1] = env[node.src][..., :h]
                env[node.dst2] = env[node.src][..., h:]
            else:
                env[node.dst1] = env[node.src][:, :h]
                env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            r, s = plan["requants"][(idx, node.src)]
            req = requantize_i32_small(env[node.src], r, s, qmax)
            if keep_env:
                env[f"{node.label}:rescale"] = req
            base = env[node.base]
            if bf16_store and base.dtype != jnp.int32:
                base = base.astype(jnp.int32)   # exact: |v| <= qmax ints
            out = req + base
            bound = model.clip_after_residual.get(idx)
            if bound is not None:
                out = jnp.clip(out, -bound, bound)
            if bf16_store:
                # wide (9-bit, |v| <= 381) residual sums are stored as
                # int16 — exact, half the HBM bytes of int32; every
                # consumer widens to int32 before arithmetic
                out = out.astype(jnp.int16)
            env[node.dst] = out
        elif isinstance(node, ConcatNode):
            # uniform part dtype: bf16 when the concat output stays in
            # int8 range (exact), int32 when residual parts widen it
            cat_dt = None
            if bf16_store:
                cat_dt = (jnp.bfloat16
                          if model.edge_amax_int.get(node.dst, 1 << 20)
                          <= 127 else jnp.int16)   # wide: exact, 1/2 bytes
            parts = []
            for e in node.srcs:
                t = env[e]
                if (idx, e) in plan["requants"]:
                    r, s = plan["requants"][(idx, e)]
                    t = requantize_i32_small(t, r, s, qmax)
                    if keep_env:
                        env[f"{node.label}:{e}:requant"] = t
                    if use_s8 and cat_dt is None:
                        t = t.astype(jnp.int8)
                if cat_dt is not None:
                    t = t.astype(cat_dt)
                parts.append(t)
            env[node.dst] = jnp.concatenate(parts, axis=cax)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = maxpool2d(env[node.src], node.kernel,
                                      node.stride, node.padding, nhwc=nhwc)
        elif isinstance(node, UpsampleNode):
            env[node.dst] = upsample_nearest(env[node.src], node.factor,
                                             nhwc=nhwc)

    if segmented:
        return {e: env[e] for e in out_edges}
    if nhwc:
        outs = {role: env[e].transpose(0, 3, 1, 2)
                for role, e in model.graph.outputs.items()}
    else:
        outs = {role: env[e] for role, e in model.graph.outputs.items()}
    if head_requant:
        assert model.head is not None, "head_requant needs full_quant"
        h = model.head
        hp = plan["head"]
        for level in ("p3", "p4", "p5"):
            for kind, qmx, dt in (("box", 127, jnp.int8),
                                  ("cls", 2 ** 15 - 1, jnp.int16)):
                role = f"{level}_{kind}"
                req = (requantize_i32_direct
                       if h.req_direct_ok.get(role)
                       else requantize_i32_bigshift_folded
                       if h.req_fold_ok.get(role)
                       else requantize_i32_bigshift
                       if int(np.min(getattr(h, f"{kind}_s")[level])) >= 16
                       else requantize_i32)
                outs[role] = req(outs[role], hp[f"{kind}_r"][level],
                                 hp[f"{kind}_s"][level], qmx).astype(dt)
    if keep_env:
        outs["__env__"] = env
    return outs


def head_conv_name(role: str) -> str:
    return {"p3_box": "x_result_5_up_2", "p3_cls": "x_result_5_down_2",
            "p4_box": "x_result_6_up_2", "p4_cls": "x_result_6_down_2",
            "p5_box": "x_up_2", "p5_cls": "x_down_2"}[role]


def dequantize_heads(model: QuantizedModel, outs: Dict) -> Dict:
    deq = {}
    for role in model.graph.outputs:
        scale = jnp.asarray(model.convs[head_conv_name(role)].acc_scale,
                            jnp.float32)
        deq[role] = outs[role].astype(jnp.float32) / scale
    return deq


def _dfl_softmax_probs(bins, axis: int, exp_lut):
    """Quantized DFL softmax probabilities over the 16-bin axis
    (SURVEY.md §2.3.7): p = int(y/sum * 127) with the reference's
    float64 truncation semantics, computed as the integer-exact
    (127*e) // sum. The division runs in f32 (possibly off by one at
    boundaries; a float divide vectorizes where an integer divide does
    not) and is corrected exactly with integer ops; the f64-truncation ==
    integer-floor equivalence is PROVEN by domain exhaustion
    (tests/test_golden_decode.py::test_dfl_softmax_f64_truncation_equals_integer_floor).

    The single shared implementation serves all three decode paths
    (dense concat-first, per-level serving, sparse top-k) — their
    bit-exactness to each other depends on this block staying
    identical."""
    y = bins - jnp.max(bins, axis=axis, keepdims=True)      # <= 0
    e = exp_lut.apply(y)                                    # [0,127]
    ssum = jnp.maximum(jnp.sum(e, axis=axis, keepdims=True), 1)
    ne = 127 * e
    q0 = jnp.floor(ne.astype(jnp.float32) /
                   ssum.astype(jnp.float32)).astype(jnp.int32)
    r = ne - q0 * ssum
    return q0 + (r >= ssum).astype(jnp.int32) - (r < 0).astype(jnp.int32)


def decode_full_quant(model: QuantizedModel, plan: Dict, outs: Dict,
                      sigmoid_cls: bool = True,
                      reduce_cls: bool = False,
                      pre_requantized: bool = False):
    """Fully-quantized head: 8-bit box requant, LUT-exponent softmax,
    quantized DFL, quantized anchors, 16-bit LUT sigmoid classes
    (reference stage_6_full_quant tail / stage_8_torch_full_quant.py:
    1195-1260). Output (B, 84, N) in anchor-scale box units and 16-bit
    sigmoid class units, ready for q_NMS.

    sigmoid_cls=False defers the 16-bit sigmoid: class rows stay in the
    requantized-int domain. The sigmoid is monotone, so ranking/threshold
    commute with it — the serving path applies it only to the <=max_det
    kept rows (the 10M-element LUT pass was ~35% of decode).

    reduce_cls=True (serving path; requires sigmoid_cls=False) reduces
    the 80 class rows to (conf, argmax) inside decode and returns the
    tuple (boxes_xywh (B,4,N), conf (B,N), cls (B,N)) instead of the
    (B,84,N) plane — NMS needs only the max class, and materializing +
    re-reading the class plane costs device-memory traffic."""
    h = model.head
    hp = plan["head"]
    if pre_requantized and reduce_cls:
        assert not sigmoid_cls, "reduce_cls defers the sigmoid to NMS"
        return _decode_serving_per_level(model, plan, outs)
    boxes, clss, shapes = [], [], []
    for level in ("p3", "p4", "p5"):
        bacc = outs[f"{level}_box"]
        cacc = outs[f"{level}_cls"]
        shapes.append((bacc.shape[2], bacc.shape[3]))
        if pre_requantized:
            # int_forward(head_requant=True) already applied this stage
            bq = bacc.astype(jnp.int32)
            cq = cacc.astype(jnp.int32)
        else:
            breq = (requantize_i32_bigshift
                    if int(np.min(h.box_s[level])) >= 16
                    else requantize_i32)
            creq = (requantize_i32_bigshift
                    if int(np.min(h.cls_s[level])) >= 16
                    else requantize_i32)
            bq = breq(bacc, hp["box_r"][level], hp["box_s"][level], 127)
            cq = creq(cacc, hp["cls_r"][level], hp["cls_s"][level],
                      2 ** 15 - 1)
        b = bq.shape[0]
        boxes.append(bq.reshape(b, 64, -1))
        clss.append(cq.reshape(b, 80, -1))
    box = jnp.concatenate(boxes, 2)
    cls = jnp.concatenate(clss, 2)
    b, _, n = box.shape

    # ---- quantized softmax over the 16 DFL bins (SURVEY.md §2.3.7) ----
    bins = box.reshape(b, 4, 16, n).transpose(0, 2, 1, 3)   # (b,16,4,n)
    p = _dfl_softmax_probs(bins, 1, hp["exp_lut"])

    # ---- quantized DFL conv + requant to anchor scale ----
    # f32 dot is exact here (|p|<=127, |w|<=127, 16 taps -> < 2^21), and
    # stays exact if the GPU runs it in TF32: both operands are integers
    # of at most 8 bits (TF32 keeps 11), products are exact and the
    # accumulation is f32.
    acc = jnp.einsum("brcn,r->bcn", p.astype(jnp.float32),
                     hp["dfl_w"].astype(jnp.float32),
                     preferred_element_type=jnp.float32).astype(jnp.int32)
    dfl_req = requantize_i32_direct if h.dfl_direct_ok else requantize_i32
    dfl_q = dfl_req(acc, jnp.int32(h.dfl_r), jnp.int32(h.dfl_s),
                    2 ** 15 - 1)

    # ---- quantized anchors ----
    anchors, strides = make_anchors(shapes)
    anchors_q = jnp.round(anchors * h.anchor_scale)
    dbox = dist2bbox(dfl_q.astype(jnp.float32), anchors_q[None]) * strides

    if reduce_cls:
        assert not sigmoid_cls, "reduce_cls defers the sigmoid to NMS"
        conf_i, cid = _conf_cid_packed(cls)
        return dbox, conf_i.astype(jnp.float32), cid
    if sigmoid_cls:
        cls = hp["cls_sig_lut"].apply(cls)
    return jnp.concatenate((dbox, cls.astype(jnp.float32)), 1)


def _conf_cid_packed(cq):
    """(max, argmax) over the class axis of a (b, 80, ...) int32 score
    tensor, computed as ONE max reduction on a packed key.

    key = score*128 + (79 - class): score differences dominate (>= 128 >
    the 79 tie-break range), and equal scores leave the LOWEST class with
    the largest key — exactly jnp.argmax's first-index tie rule. The
    decode |score| < 2^15 keeps |key| < 2^22, int32-safe; >> 7 is an
    arithmetic shift (floor), recovering the score exactly for negative
    values too, and & 127 is mod 128 on two's complement. argmax lowers
    to a variadic (value, index) reduce; this is one plain max over the
    same bytes.
    """
    c = cq.shape[1]
    rev = jnp.arange(c - 1, -1, -1, dtype=jnp.int32)
    key = (cq << 7) + rev.reshape((1, c) + (1,) * (cq.ndim - 2))
    kmax = jnp.max(key, axis=1)
    return kmax >> 7, ((c - 1) - (kmax & 127)).astype(jnp.float32)


def _decode_serving_per_level(model: QuantizedModel, plan: Dict,
                              outs: Dict):
    """Serving decode (pre_requantized + reduce_cls) computed PER FPN
    LEVEL in the conv-native (h, w)-minor layout.

    Mathematically identical to the concat-first path (softmax, DFL,
    dist2bbox, and the class max/argmax are all per-anchor), but the
    DFL softmax then runs on (B,4,16,h,w) views of the head tensors as
    the forward produced them — the concat-first path's
    (B,4,16,N)->(B,16,4,N) transpose moves the full int32 bin plane
    through HBM, and the class plane is reduced before any anchor-major
    materialization. Returns (dbox (B,4,N), conf (B,N), cid (B,N))
    with N in p3,p4,p5 row-major anchor order, matching make_anchors.
    """
    from alpha_yolo_quant_tpu.models.head import STRIDES

    h = model.head
    hp = plan["head"]
    dboxes, confs, cids = [], [], []
    for li, level in enumerate(("p3", "p4", "p5")):
        bq = outs[f"{level}_box"].astype(jnp.int32)      # (b,64,h,w)
        cq = outs[f"{level}_cls"].astype(jnp.int32)      # (b,80,h,w)
        b, _, hh, ww = bq.shape
        bins = bq.reshape(b, 4, 16, hh, ww)
        p = _dfl_softmax_probs(bins, 2, hp["exp_lut"])
        # exact in f32 and in TF32 (see decode_full_quant)
        acc = jnp.einsum("bcrhw,r->bchw", p.astype(jnp.float32),
                         hp["dfl_w"].astype(jnp.float32),
                         preferred_element_type=jnp.float32
                         ).astype(jnp.int32)
        dfl_req = (requantize_i32_direct if h.dfl_direct_ok
                   else requantize_i32)
        dfl_q = dfl_req(acc, jnp.int32(h.dfl_r),
                        jnp.int32(h.dfl_s), 2 ** 15 - 1)
        anchors_l, strides_l = make_anchors([(hh, ww)],
                                            strides=STRIDES[li:li + 1])
        anchors_ql = jnp.round(anchors_l * h.anchor_scale)
        dbox = dist2bbox(dfl_q.reshape(b, 4, hh * ww).astype(jnp.float32),
                         anchors_ql[None]) * strides_l
        dboxes.append(dbox)
        conf_l, cid_l = _conf_cid_packed(cq)
        confs.append(conf_l.reshape(b, -1).astype(jnp.float32))
        cids.append(cid_l.reshape(b, -1))
    return (jnp.concatenate(dboxes, 2), jnp.concatenate(confs, 1),
            jnp.concatenate(cids, 1))


def decode_select_sparse(model: QuantizedModel, plan: Dict, outs: Dict,
                         *, pre_topk: int, conf_thres: float):
    """Serving decode fused with NMS candidate selection (conf-first).

    The dense serving path (_decode_serving_per_level followed by
    postprocess.nms._select_candidates) runs the quantized DFL softmax
    over all N anchors and then keeps the top pre_topk by class
    confidence. Confidence alone determines that cut, so this path
    sorts FIRST — the identical packed int key ((conf + 2^15) << 14 |
    reverse-index) the dense select uses — and decodes boxes only for
    the kept pre_topk anchors: ~N/pre_topk (8.4x at 640) less DFL
    softmax/einsum work, plus the box-bin planes are read through an
    int8 top-k gather instead of in full. Per-anchor math is identical
    (same softmax correction, same requant, same f32 dist2bbox chain),
    so the result is bit-exact vs the dense path (tested:
    tests/test_nms.py::test_sparse_select_decode_parity).

    Requires head_requant outputs (box int8 / cls int16 edges), N < 2^14
    anchors and integer class scores (the q_NMS serving regime).
    Returns (boxes_xyxy (B,m,4), conf (B,m), cid (B,m), valid (B,m)) in
    descending (conf, lowest-index-first) order — the preselected
    contract of postprocess.nms.non_max_suppression.
    """
    from alpha_yolo_quant_tpu.models.head import STRIDES
    from alpha_yolo_quant_tpu.postprocess.nms import xywh2xyxy

    h = model.head
    hp = plan["head"]
    confs, cids, boxes, shapes = [], [], [], []
    for level in ("p3", "p4", "p5"):
        cq = outs[f"{level}_cls"].astype(jnp.int32)      # (b,80,h,w)
        b = cq.shape[0]
        conf_l, cid_l = _conf_cid_packed(cq)
        confs.append(conf_l.reshape(b, -1))
        cids.append(cid_l.reshape(b, -1))
        bq = outs[f"{level}_box"]                        # int8 (b,64,h,w)
        shapes.append((bq.shape[2], bq.shape[3]))
        boxes.append(bq.reshape(b, 64, -1))
    conf = jnp.concatenate(confs, 1)                     # (b,N) int32
    cid = jnp.concatenate(cids, 1)                       # (b,N) f32
    box_flat = jnp.concatenate(boxes, 2)                 # (b,64,N) int8
    n = conf.shape[1]
    assert n < (1 << 14), "sparse select needs N < 2^14 anchors"
    m = min(pre_topk, n)

    # identical key + order as _select_candidates' int fast path
    from alpha_yolo_quant_tpu.postprocess.nms import (
        conf_from_key, conf_sort_key, index_from_key,
    )

    key = conf_sort_key(conf, n)
    srt = jax.lax.sort((-key, cid), num_keys=1, dimension=1)
    skey = -srt[0][:, :m]
    cid_s = srt[1][:, :m]
    conf_s = conf_from_key(skey).astype(jnp.float32)
    idx = index_from_key(skey, n)                        # (b,m)

    # top-k gather of the box bins: (b,64,m) int8
    bins_g = jnp.take_along_axis(box_flat, idx[:, None, :], axis=2)
    bins = bins_g.astype(jnp.int32).reshape(-1, 4, 16, m)
    p = _dfl_softmax_probs(bins, 2, hp["exp_lut"])
    # exact in f32 and in TF32 (see decode_full_quant)
    acc = jnp.einsum("bcrn,r->bcn", p.astype(jnp.float32),
                     hp["dfl_w"].astype(jnp.float32),
                     preferred_element_type=jnp.float32).astype(jnp.int32)
    dfl_req = requantize_i32_direct if h.dfl_direct_ok else requantize_i32
    dfl_q = dfl_req(acc, jnp.int32(h.dfl_r), jnp.int32(h.dfl_s),
                    2 ** 15 - 1)

    # per-anchor constants gathered by the same index
    anchors, strides = make_anchors(shapes, strides=STRIDES)
    anchors_q = jnp.round(anchors * h.anchor_scale)      # (2,N)
    a_g = jnp.take(anchors_q.T, idx, axis=0)             # (b,m,2)
    s_g = jnp.take(strides[0], idx, axis=0)              # (b,m)
    dbox = dist2bbox(dfl_q.astype(jnp.float32),
                     a_g.transpose(0, 2, 1)) * s_g[:, None, :]
    boxes_xyxy = xywh2xyxy(dbox.transpose(0, 2, 1))      # (b,m,4)
    return boxes_xyxy, conf_s, cid_s, conf_s > jnp.float32(conf_thres)


def cls_int_conf_threshold(model: QuantizedModel,
                           conf_thres_int: int = 8192) -> float:
    """Smallest requantized-int class score whose sigmoid exceeds the
    integer confidence threshold, minus 0.5 — the pre-sigmoid equivalent
    of `conf > 8192` (sigmoid is monotone)."""
    lut = model.head.cls_sigmoid_lut
    above = np.nonzero(lut.values > conf_thres_int)[0]
    if len(above) == 0:
        return float(lut.hi) + 0.5
    return float(above[0] + lut.lo) - 0.5


def eval_nms_params(model: QuantizedModel, conf_thres: float):
    """NmsParams for the mAP protocol at a FLOAT confidence threshold.

    The reference's mAP runs use conf 1e-8 through `coord`
    (stage_8_torch.py:147) while its serving demo uses 0.25; the
    full-quant path expresses the same cut in 16-bit sigmoid ints
    (8192 = round(0.25 * 32767), utils/bbox_cls_functions.py:195-250).
    This maps a float threshold onto whichever domain the model's NMS
    runs in; build_int_pipeline then converts quantized params to the
    deferred-sigmoid pre-sigmoid domain internally."""
    from alpha_yolo_quant_tpu.postprocess.nms import NmsParams, q_nms_params

    if model.cfg.full_quant:
        return q_nms_params(model.head.anchor_scale,
                            conf_thres_int=int(round(conf_thres * 32767)))
    return NmsParams(conf_thres=conf_thres, pre_topk=1000)


def build_int_pipeline(model: QuantizedModel, dfl_w_float=None,
                       with_nms: bool = True, nms_params=None,
                       engine: str = "xla", sparse_select: bool = False,
                       pad_batch_to: Optional[int] = None,
                       options: "EngineOptions" = None,
                       coalesce_requests: Optional[int] = None):
    """Return a jittable images->detections function for this model.

    dfl_w_float: the float DFL weights (required for the partial-quant
    pipeline, whose head stays float — reference stage_6.py:598-634).
    engine: one of ENGINES (see int_forward); all are bit-identical.
    sparse_select: use the conf-first sparse decode (decode_select_sparse)
    on the full-quant serving path when eligible — bit-identical to the
    dense decode+select with ~8x less DFL work. Off by default: the dense
    DFL fuses into surrounding passes while the sort->gather->DFL chain
    lengthens the critical path; not yet measured on the GPU.
    pad_batch_to: serving knob — when the traced batch is SMALLER, pad
    it with zero images to this width and slice every output back to
    the real batch, so one compiled batch width serves smaller batches.
    Bit-exact for the real rows: every per-image computation is
    batch-independent (tested).
    options: per-pipeline EngineOptions (engine flavor A/B switches plus
    the stage-8 per_image_amax input-quant quirk); None inherits the
    deprecated module globals.
    coalesce_requests: serving knob — fn takes that many request arrays
    instead of one batch, quantizes EACH at its real width, and
    concatenates at the quantized activation dtype (bf16/int8 — half
    the bytes of f32) before one conv-stack pass; outputs split back
    per request. Bit-exact vs per-request runs (batch independence —
    tests/test_serving.py); the request seam never materializes a
    concatenated f32 batch, unlike serving.coalesced_fn."""
    from alpha_yolo_quant_tpu.models.head import decode_float
    from alpha_yolo_quant_tpu.postprocess.nms import (
        NmsParams, non_max_suppression, q_nms_params,
    )

    check_engine(engine)
    if options is None:
        options = EngineOptions()
    plan = device_plan(model)
    k = model.cfg.k
    full = model.cfg.full_quant
    score_map = None
    if nms_params is None:
        if full:
            # rank raw int class scores; sigmoid only the kept rows
            nms_params = dataclasses.replace(
                q_nms_params(model.head.anchor_scale),
                conf_thres=cls_int_conf_threshold(model))
            score_map = plan["head"]["cls_sig_lut"].apply
        else:
            nms_params = NmsParams(conf_thres=0.25)
    elif full and nms_params.quantized:
        # Custom q_NMS params keep the deferred-sigmoid fast path. The
        # caller's conf_thres is in the POST-sigmoid 16-bit int domain
        # (q_nms_params contract: 8192 = 0.25 * 32767, reference
        # stage_8_torch_full_quant.py:297-362); the fast path ranks
        # PRE-sigmoid class scores, so convert the threshold through the
        # sigmoid LUT (monotone, hence the cut is identical).
        nms_params = dataclasses.replace(
            nms_params,
            conf_thres=cls_int_conf_threshold(
                model, int(nms_params.conf_thres)))
        score_map = plan["head"]["cls_sig_lut"].apply
    if not full:
        if dfl_w_float is None:
            raise ValueError("partial-quant pipeline needs dfl_w_float")
        dfl_w = jnp.asarray(dfl_w_float, jnp.float32)

    q_dt = jnp.bfloat16 if engine == "auto" else jnp.int8

    # sparse select needs the q_NMS serving regime: integer scores, a
    # pre_topk cut, the deferred sigmoid, and < 2^14 anchors
    n_anchors = sum((model.cfg.image_size // s) ** 2 for s in (8, 16, 32))
    use_sparse = (sparse_select and full and with_nms
                  and score_map is not None and nms_params.quantized
                  and nms_params.pre_topk and n_anchors < (1 << 14))

    def _post(outs):
        if use_sparse:
            cand = decode_select_sparse(
                model, plan, outs,
                pre_topk=min(nms_params.pre_topk, nms_params.max_nms),
                conf_thres=nms_params.conf_thres)
            return non_max_suppression(cand, nms_params,
                                       score_map=score_map,
                                       preselected=True)
        if full:
            preds = decode_full_quant(model, plan, outs,
                                      sigmoid_cls=score_map is None,
                                      reduce_cls=(score_map is not None
                                                  and with_nms),
                                      pre_requantized=True)
        else:
            preds = decode_float(dequantize_heads(model, outs), dfl_w)
        if with_nms:
            return non_max_suppression(preds, nms_params,
                                       score_map=score_map)
        return preds

    def _quantized_run(x_q, b):
        padded = pad_batch_to is not None and b < pad_batch_to
        if padded:
            # only the conv stack needs the padded width: quantize
            # at the real batch, pad the (bf16/int8 — half the bytes)
            # quantized tensor with zero images, slice the head edges
            # back before decode/NMS. Zero rows cannot affect real rows
            # (every per-image computation is batch-independent; tested).
            zpad = jnp.zeros((pad_batch_to - b,) + x_q.shape[1:],
                             x_q.dtype)
            x_q = jnp.concatenate((x_q, zpad), 0)
        outs = int_forward(model, plan, x_q, engine=engine,
                           head_requant=full, options=options)
        if padded:
            outs = {name: t[:b] for name, t in outs.items()}
        return _post(outs)

    def _quant(images):
        return quantize_input(images, k, out_dtype=q_dt,
                              per_image_amax=options.per_image_amax)

    if coalesce_requests is not None:
        n_req = int(coalesce_requests)

        def fn(*requests):
            from alpha_yolo_quant_tpu.serving import split_by_sizes

            if len(requests) != n_req:
                raise ValueError(f"expected {n_req} requests, "
                                 f"got {len(requests)}")
            sizes = [r.shape[0] for r in requests]
            x_q = jnp.concatenate([_quant(r) for r in requests], 0)
            res = _quantized_run(x_q, sum(sizes))
            return split_by_sizes(res, sizes)
    else:
        def fn(images):
            return _quantized_run(_quant(images), images.shape[0])

    return fn, plan
