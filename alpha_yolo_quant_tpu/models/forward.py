"""Float forward pass over the graph IR (the BN-fused fp32 model).

Functionally equivalent to the reference's torch forward
(stage_2.py:478-679 / stage_4.py:475-945) but expressed once over the IR
and fully jittable. Optionally records the calibration taps (per-conv
pre-activation tensors) in the same pass — the stage-4 analog runs batched
on the accelerator instead of image-at-a-time on CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp

from alpha_yolo_quant_tpu.models.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from alpha_yolo_quant_tpu.ops.nn import (
    conv2d_f32, maxpool2d, silu, upsample_nearest,
)


def forward_float(graph: Graph, params: Dict, x,
                  collect_taps: bool = False
                  ) -> Tuple[Dict[str, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Run the fp32 model.

    Returns (outputs, taps): outputs maps the six head roles to raw head
    tensors (pre-decode); taps maps calibration tap names to per-image
    max-abs of the conv pre-activation outputs (plus 'start' for the input,
    reference stage_4.py:477) when collect_taps is set, else {}.
    """
    env: Dict[str, jnp.ndarray] = {graph.input_edge: x}
    taps: Dict[str, jnp.ndarray] = {}

    def record(name, t):
        if collect_taps and name is not None:
            # per-image max over CHW so batched calibration keeps
            # per-image statistics like the reference's batch-1 loop
            m = jnp.max(jnp.abs(t), axis=(1, 2, 3))
            taps[name] = jnp.maximum(taps[name], m) if name in taps else m

    record("start", x)
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            p = params[node.key]
            out = conv2d_f32(env[node.src], p["w"], p["b"],
                             stride=node.stride, padding=node.padding)
            record(node.tap, out)
            env[node.dst] = silu(out) if node.silu else out
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[1] // 2
            env[node.dst1] = env[node.src][:, :h]
            env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            env[node.dst] = env[node.src] + env[node.base]
        elif isinstance(node, ConcatNode):
            env[node.dst] = jnp.concatenate([env[e] for e in node.srcs],
                                            axis=1)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = maxpool2d(env[node.src], node.kernel, node.stride,
                                      node.padding)
        elif isinstance(node, UpsampleNode):
            env[node.dst] = upsample_nearest(env[node.src], node.factor)
        else:  # pragma: no cover
            raise TypeError(type(node))

    outputs = {role: env[e] for role, e in graph.outputs.items()}
    return outputs, taps
