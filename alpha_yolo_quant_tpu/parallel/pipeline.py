"""GPipe-style pipeline parallelism (pp) over a mesh axis.

The reference has no distributed code at all (SURVEY.md §2.9); the dp /
tp / sp seams live in parallel/mesh.py. This module adds the remaining
classic axis: PIPELINE parallelism — the ordered graph IR is split into
S contiguous, conv-MAC-balanced stages, each device along the 'pp' mesh
axis executes one stage, and microbatches flow device-to-device
via ``jax.lax.ppermute`` in the standard GPipe fill/steady/drain
schedule (T = M + S - 1 ticks for M microbatches; ``lax.switch`` on the
axis index picks the device's stage inside one SPMD program).

Why the seam exists at this model scale: YOLOv8n's 3M params never NEED
pipeline sharding (the plan is replicated here — cheaper than any
gather), but a deeper variant whose activations do not fit one chip
pipelines through the same machinery, and like every other parallel
seam in this repo it is validated BITWISE on the virtual mesh
(tests/test_pipeline.py) and in ``__graft_entry__.dryrun_multichip``.

Exactness: stage boundaries transport activations as flat int32
buffers. Every inter-stage edge holds integers (bf16 edges store ints
<= 127, wide int16 edges <= 511, head accumulators are int32), so the
cast -> ppermute -> cast round trip is exact, and each stage runs the
UNCHANGED ``int_forward`` node loop over its node range
(runtime/interpreter.py segmented execution) — the pipeline result is
bit-identical to the unsharded engine by construction.

Expert parallelism (ep) deliberately has no seam: the model family is a
dense CNN with no MoE/expert blocks (the same reason SURVEY.md §5.7
marks long-context/sequence parallelism n/a).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from alpha_yolo_quant_tpu.models.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)


def _node_io(node) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    if isinstance(node, ConvNode):
        return (node.src,), (node.dst,)
    if isinstance(node, SplitNode):
        return (node.src,), (node.dst1, node.dst2)
    if isinstance(node, ResidualAddNode):
        return (node.src, node.base), (node.dst,)
    if isinstance(node, ConcatNode):
        return tuple(node.srcs), (node.dst,)
    if isinstance(node, (MaxPoolNode, UpsampleNode)):
        return (node.src,), (node.dst,)
    raise TypeError(type(node))


def _node_costs(graph: Graph, image_size: int):
    """Per-node cost (conv MACs) from a pure-Python shape walk — the
    stage balancer's weight function. Non-conv nodes are ~free next to
    the convs they sit between."""
    shapes = {graph.input_edge: (3, image_size, image_size)}
    costs = []
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            _, h, w = shapes[node.src]
            ho = (h + 2 * node.padding - node.kernel) // node.stride + 1
            wo = (w + 2 * node.padding - node.kernel) // node.stride + 1
            shapes[node.dst] = (node.cout, ho, wo)
            costs.append(node.cin * node.cout * node.kernel ** 2 * ho * wo)
            continue
        costs.append(0)
        if isinstance(node, SplitNode):
            c, h, w = shapes[node.src]
            shapes[node.dst1] = shapes[node.dst2] = (c // 2, h, w)
        elif isinstance(node, ResidualAddNode):
            shapes[node.dst] = shapes[node.base]
        elif isinstance(node, ConcatNode):
            cs = [shapes[e] for e in node.srcs]
            shapes[node.dst] = (sum(c for c, _, _ in cs),) + cs[0][1:]
        elif isinstance(node, MaxPoolNode):
            # pooled output shape from kernel/stride/padding (ADVICE r4:
            # assuming shape preservation holds only for the SPPF
            # k=5/s=1/p=2 default and would silently skew downstream
            # conv cost estimates for a strided pool)
            c, h, w = shapes[node.src]
            ho = (h + 2 * node.padding - node.kernel) // node.stride + 1
            wo = (w + 2 * node.padding - node.kernel) // node.stride + 1
            shapes[node.dst] = (c, ho, wo)
        elif isinstance(node, UpsampleNode):
            c, h, w = shapes[node.src]
            shapes[node.dst] = (c, h * node.factor, w * node.factor)
    return costs


def _choose_cuts(graph: Graph, image_size: int, n_stages: int):
    """Contiguous stage boundaries (node indices) balancing conv MACs."""
    costs = _node_costs(graph, image_size)
    n = len(costs)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages={n_stages} for a {n}-node graph")
    pref = np.cumsum([0] + costs)
    bounds = [0]
    for s in range(1, n_stages):
        c = int(np.searchsorted(pref, pref[-1] * s / n_stages))
        c = max(c, bounds[-1] + 1)          # non-empty stages
        c = min(c, n - (n_stages - s))
        bounds.append(c)
    bounds.append(n)
    return bounds


def _live_edges(graph: Graph, cut: int) -> Tuple[str, ...]:
    """Edges produced before node index `cut` and still consumed at or
    after it (graph outputs stay live to the end). Deterministic order:
    by producer index, then name."""
    produced = {graph.input_edge: -1}
    last_use: Dict[str, int] = {}
    for i, node in enumerate(graph.nodes):
        ins, outs = _node_io(node)
        for e in ins:
            last_use[e] = i
        for e in outs:
            produced[e] = i
    for e in graph.outputs.values():
        last_use[e] = len(graph.nodes)
    live = [e for e, pi in produced.items()
            if pi < cut and last_use.get(e, -1) >= cut]
    live.sort(key=lambda e: (produced[e], e))
    return tuple(live)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static pipeline plan: stage node ranges, per-stage live boundary
    edges, per-microbatch edge specs, and the (shared) int32 transport
    buffer width."""

    boundaries: Tuple[int, ...]                       # len S+1
    stage_in_edges: Tuple[Tuple[str, ...], ...]
    stage_out_edges: Tuple[Tuple[str, ...], ...]
    edge_specs: Dict[str, Tuple[Tuple[int, ...], jnp.dtype]]
    buf_width: int
    microbatch: int
    n_microbatches: int
    engine: str

    @property
    def n_stages(self) -> int:
        return len(self.stage_in_edges)


def _pack(tensors, width: int):
    flat = [t.astype(jnp.int32).reshape(-1) for t in tensors]
    buf = jnp.concatenate(flat)
    pad = width - buf.shape[0]
    if pad:
        buf = jnp.concatenate([buf, jnp.zeros((pad,), jnp.int32)])
    return buf


def _unpack(buf, edges, edge_specs):
    env, off = {}, 0
    for e in edges:
        shape, dt = edge_specs[e]
        n = int(np.prod(shape))
        env[e] = buf[off:off + n].reshape(shape).astype(dt)
        off += n
    return env


def build_pipeline_spec(model, plan, n_stages: int, microbatch: int,
                        n_microbatches: int,
                        engine: str = "auto") -> PipelineSpec:
    """Plan an S-stage pipeline: balanced cuts, live-edge boundary sets,
    and boundary tensor specs derived by abstractly evaluating each
    segment in turn (jax.eval_shape — no FLOPs spent)."""
    from alpha_yolo_quant_tpu.runtime.interpreter import int_forward

    graph = model.graph
    bounds = _choose_cuts(graph, model.cfg.image_size, n_stages)
    roles = sorted(graph.outputs)
    out_last = tuple(dict.fromkeys(graph.outputs[r] for r in roles))
    ins, outs = [], []
    for s in range(n_stages):
        ins.append(_live_edges(graph, bounds[s]))
        outs.append(_live_edges(graph, bounds[s + 1])
                    if s < n_stages - 1 else out_last)

    q_dt = jnp.bfloat16 if engine in ("auto",) else jnp.int8
    size = model.cfg.image_size
    specs = {graph.input_edge: jax.ShapeDtypeStruct(
        (microbatch, 3, size, size), q_dt)}
    for s in range(n_stages):
        def seg(env, s=s):
            return int_forward(model, plan, None, engine=engine,
                               env_in=env,
                               node_range=(bounds[s], bounds[s + 1]),
                               out_edges=outs[s])

        res = jax.eval_shape(seg, {e: specs[e] for e in ins[s]})
        specs.update(res)

    widths = []
    for s in range(n_stages):
        widths.append(sum(int(np.prod(specs[e].shape)) for e in ins[s]))
        widths.append(sum(int(np.prod(specs[e].shape)) for e in outs[s]))
    return PipelineSpec(
        boundaries=tuple(bounds),
        stage_in_edges=tuple(ins), stage_out_edges=tuple(outs),
        edge_specs={e: (tuple(sd.shape), sd.dtype)
                    for e, sd in specs.items()},
        buf_width=max(widths), microbatch=microbatch,
        n_microbatches=n_microbatches, engine=engine)


def pipeline_forward(model, plan, spec: PipelineSpec, mesh: Mesh,
                     axis: str = "pp", dp_axis: str = None):
    """Jitted images->head-edges forward pipelined over `axis`.

    Input: (microbatch * n_microbatches, 3, H, W) float images,
    replicated (each device reads only the microbatch it is filling).
    Output: the same {role: int32 accumulator} dict as
    ``int_forward`` — decode + NMS are sequential bookkeeping and run
    replicated downstream (same placement rationale as
    parallel.mesh.spatial_parallel_fn). Bitwise identical to the
    unsharded engine (tested).

    dp_axis: compose with data parallelism on a 2-D (dp, pp) mesh —
    the batch is sharded over `dp_axis` (input becomes
    dp * microbatch * n_microbatches images) and each dp group runs an
    independent pipeline over its `axis` slice (ppermute/psum are
    per-group by collective-axis semantics, so bitwise parity carries
    over unchanged)."""
    from alpha_yolo_quant_tpu.runtime.interpreter import (
        int_forward, quantize_input,
    )

    graph = model.graph
    S = spec.n_stages
    if mesh.shape[axis] != S:
        raise ValueError(f"mesh axis '{axis}' has {mesh.shape[axis]} "
                         f"devices but the spec has {S} stages")
    # Normalize to Auto axis types: shard_map makes the axis manual
    # inside regardless, and on this jax (0.9) Explicit-typed meshes
    # (jax.make_mesh's default) stamp explicit shardings onto the result
    # avals, which then poison downstream EAGER decode/NMS ops with
    # "enter a mesh context" errors.
    from jax.sharding import AxisType

    mesh = Mesh(mesh.devices, mesh.axis_names,
                axis_types=(AxisType.Auto,) * len(mesh.axis_names))
    M, mb, W = spec.n_microbatches, spec.microbatch, spec.buf_width
    bounds = spec.boundaries
    roles = sorted(graph.outputs)
    last_edges = spec.stage_out_edges[-1]

    def make_seg(s):
        def seg(buf):
            env = _unpack(buf, spec.stage_in_edges[s], spec.edge_specs)
            res = int_forward(model, plan, None, engine=spec.engine,
                              env_in=env,
                              node_range=(bounds[s], bounds[s + 1]),
                              out_edges=spec.stage_out_edges[s])
            return _pack([res[e] for e in spec.stage_out_edges[s]], W)
        return seg

    seg_fns = [make_seg(s) for s in range(S)]

    def body(x_q):
        sidx = jax.lax.axis_index(axis)

        def tick(carry, t):
            send, slots = carry
            # stage s receives stage s-1's previous output (fill phase
            # reads ppermute's zeros — discarded by the schedule)
            recv = jax.lax.ppermute(
                send, axis, [(i, i + 1) for i in range(S - 1)])
            x_mb = jax.lax.dynamic_slice_in_dim(
                x_q, jnp.clip(t, 0, M - 1) * mb, mb, 0)
            buf_in = jnp.where(sidx == 0, _pack([x_mb], W), recv)
            out = jax.lax.switch(sidx, seg_fns, buf_in)
            # the last stage finishes microbatch t-(S-1) at tick t
            oi = t - (S - 1)
            write = (sidx == S - 1) & (oi >= 0)
            slot_i = jnp.clip(oi, 0, M - 1)
            cur = jax.lax.dynamic_slice_in_dim(slots, slot_i, 1, 0)
            slots = jax.lax.dynamic_update_slice_in_dim(
                slots, jnp.where(write, out[None], cur), slot_i, 0)
            return (out, slots), None

        init = (jnp.zeros((W,), jnp.int32), jnp.zeros((M, W), jnp.int32))
        # the tick outputs vary over 'pp' (each device computes its own
        # stage) and over 'dp' when the batch is sharded; mark the zero
        # init as varying so the scan carry types match under
        # shard_map's manual-axes typing
        vary = (axis,) + ((dp_axis,) if dp_axis else ())
        init = jax.tree.map(
            lambda x: jax.lax.pcast(x, vary, to="varying"), init)
        (_, slots), _ = jax.lax.scan(tick, init, jnp.arange(S + M - 1))
        # results live on the last stage only; masked psum replicates
        return jax.lax.psum(slots * (sidx == S - 1).astype(jnp.int32),
                            axis)

    io_spec = P(dp_axis) if dp_axis else P()
    mapped = shard_map(body, mesh=mesh, in_specs=(io_spec,),
                       out_specs=io_spec)
    m_total = M * (mesh.shape[dp_axis] if dp_axis else 1)

    def fn(images):
        want = mb * m_total
        if images.shape[0] != want:
            # dynamic_slice clamps out-of-range starts, which would
            # silently duplicate/drop images — fail loudly instead
            raise ValueError(
                f"pipeline batch must be microbatch*n_microbatches"
                f"{'*dp' if dp_axis else ''} = {want}, "
                f"got {images.shape[0]}")
        q_dt = (jnp.bfloat16 if spec.engine in ("auto",) else jnp.int8)
        x_q = quantize_input(images, model.cfg.k, out_dtype=q_dt)
        slots = mapped(x_q)
        per_mb = [_unpack(slots[m], last_edges, spec.edge_specs)
                  for m in range(m_total)]
        env = {e: jnp.concatenate([p[e] for p in per_mb], 0)
               for e in last_edges}
        return {r: env[graph.outputs[r]] for r in roles}

    return jax.jit(fn)


def build_pp_pipeline(model, mesh: Mesh, n_stages: int, microbatch: int,
                      n_microbatches: int, dfl_w_float=None,
                      with_nms: bool = True, nms_params=None,
                      engine: str = "auto", axis: str = "pp",
                      dp_axis: str = None):
    """images -> detections with the forward pipelined over `axis`.

    The pp analog of runtime.interpreter.build_int_pipeline: quantize +
    decode + NMS run replicated around the pipelined conv stack (the
    classic decode path — raw head accumulators in, so
    decode_full_quant applies the head requants itself). Returns
    (fn, spec)."""
    from alpha_yolo_quant_tpu.models.head import decode_float
    from alpha_yolo_quant_tpu.postprocess.nms import (
        NmsParams, non_max_suppression, q_nms_params,
    )
    from alpha_yolo_quant_tpu.runtime.interpreter import (
        decode_full_quant, dequantize_heads, device_plan,
    )

    plan = device_plan(model)
    spec = build_pipeline_spec(model, plan, n_stages, microbatch,
                               n_microbatches, engine=engine)
    fwd = pipeline_forward(model, plan, spec, mesh, axis=axis,
                           dp_axis=dp_axis)
    full = model.cfg.full_quant
    if nms_params is None:
        nms_params = (q_nms_params(model.head.anchor_scale) if full
                      else NmsParams(conf_thres=0.25))
    if not full:
        if dfl_w_float is None:
            raise ValueError("partial-quant pipeline needs dfl_w_float")
        dfl_w = jnp.asarray(dfl_w_float, jnp.float32)

    def fn(images):
        outs = fwd(images)
        preds = (decode_full_quant(model, plan, outs) if full
                 else decode_float(dequantize_heads(model, outs), dfl_w))
        if with_nms:
            return non_max_suppression(preds, nms_params)
        return preds

    # jit the whole step: the integer pipeline is bitwise regardless, but
    # the FLOAT box decode must compile under one boundary to reproduce
    # the unsharded jitted run's FMA contractions exactly (same artifact
    # as spatial_parallel_fn's jit-vs-eager note)
    return jax.jit(fn), spec
