"""Graph IR consistency, float forward parity vs torch, BN fusion."""

import numpy as np
import pytest

import conftest  # noqa: F401  (forces CPU platform)

import jax.numpy as jnp

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.forward import forward_float
from alpha_yolo_quant_tpu.models.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode, build_yolov8_graph,
)
from alpha_yolo_quant_tpu.models.head import decode_float
from alpha_yolo_quant_tpu.models.params import (
    fuse_batchnorm, init_params, init_raw_params, raw_param_slots,
)

CFG = QuantConfig(model="yolov8n", k=8)


def _edge_channels(graph):
    """Walk the graph tracking channel counts per edge; raises on mismatch."""
    ch = {graph.input_edge: 3}
    for n in graph.nodes:
        if isinstance(n, ConvNode):
            assert ch[n.src] == n.cin, (n.name, ch[n.src], n.cin)
            ch[n.dst] = n.cout
        elif isinstance(n, SplitNode):
            assert ch[n.src] % 2 == 0
            ch[n.dst1] = ch[n.dst2] = ch[n.src] // 2
        elif isinstance(n, ResidualAddNode):
            assert ch[n.src] == ch[n.base]
            ch[n.dst] = ch[n.src]
        elif isinstance(n, ConcatNode):
            # scale_from names the edge whose (scalar) scale the concat
            # output carries; it is either an input or the scale-lineage
            # ancestor all non-requantized inputs share (C2F's conv_0).
            assert n.scale_from in ch
            ch[n.dst] = sum(ch[e] for e in n.srcs)
        elif isinstance(n, (MaxPoolNode, UpsampleNode)):
            ch[n.dst] = ch[n.src]
    return ch


def test_graph_consistency():
    g = build_yolov8_graph(CFG)
    ch = _edge_channels(g)
    # head outputs: 64 box regs / 80 classes
    for role, edge in g.outputs.items():
        assert ch[edge] == (64 if role.endswith("box") else 80)
    # param keys unique
    keys = [c.key for c in g.convs()]
    assert len(keys) == len(set(keys))
    # 63 convs total: 57 conv+bn+silu, 6 plain head convs
    assert len(keys) == 63
    # raw tensor slot count matches the reference state_dict (355 tensors:
    # 57*6 + 6*2 + dfl; reference stage_2.py:700 scans BN windows to i<=351)
    slots = raw_param_slots(g)
    assert sum(len(s[1]) for s in slots) == 355


def test_graph_tap_names_cover_stage4():
    """Every stage_4 calibration tap name appears exactly once as a conv's
    own tap (44 conv taps; reference stage_4.py:481-910)."""
    g = build_yolov8_graph(CFG)
    taps = [c.tap for c in g.convs()]
    assert len(taps) == len(set(taps)) == 63
    for t in ["conv_p1", "conv_0_c2f", "cf2_bconv1_5", "sppf_conv_2",
              "cf2_conv_80", "x_result_6_down_2", "x_up_2", "x_down_0"]:
        assert t in taps, t


def test_small_variant_builds():
    g = build_yolov8_graph(QuantConfig(model="yolov8s"))
    ch = _edge_channels(g)
    assert ch["c2f21"] == 512


def _torch_forward(graph, params, x_np):
    """Independent torch execution of the same IR — oracle for conv/pool/
    upsample/silu semantics."""
    import torch
    import torch.nn.functional as F

    env = {graph.input_edge: torch.from_numpy(x_np)}
    for n in graph.nodes:
        if isinstance(n, ConvNode):
            p = params[n.key]
            out = F.conv2d(env[n.src], torch.from_numpy(p["w"]),
                           torch.from_numpy(p["b"]), stride=n.stride,
                           padding=n.padding)
            env[n.dst] = F.silu(out) if n.silu else out
        elif isinstance(n, SplitNode):
            h = env[n.src].shape[1] // 2
            env[n.dst1], env[n.dst2] = env[n.src][:, :h], env[n.src][:, h:]
        elif isinstance(n, ResidualAddNode):
            env[n.dst] = env[n.src] + env[n.base]
        elif isinstance(n, ConcatNode):
            env[n.dst] = torch.cat([env[e] for e in n.srcs], 1)
        elif isinstance(n, MaxPoolNode):
            env[n.dst] = F.max_pool2d(env[n.src], n.kernel, n.stride,
                                      n.padding)
        elif isinstance(n, UpsampleNode):
            env[n.dst] = F.interpolate(env[n.src], scale_factor=n.factor,
                                       mode="nearest")
    return {r: env[e].numpy() for r, e in graph.outputs.items()}


def test_float_forward_matches_torch():
    g = build_yolov8_graph(CFG)
    params = init_params(g, seed=3)
    x = np.random.default_rng(7).uniform(0, 1, (2, 3, 128, 128)).astype(
        np.float32)
    got, _ = forward_float(g, params, jnp.asarray(x))
    want = _torch_forward(g, params, x)
    for role in want:
        np.testing.assert_allclose(np.asarray(got[role]), want[role],
                                   rtol=2e-4, atol=2e-4)


def test_bn_fusion_matches_unfused_torch():
    import torch
    import torch.nn.functional as F

    g = build_yolov8_graph(CFG)
    raw = init_raw_params(g, seed=5)
    fused = fuse_batchnorm(g, raw)
    node = g.convs()[0]
    p = raw[node.key]
    x = torch.randn(1, node.cin, 16, 16)
    want = F.batch_norm(
        F.conv2d(x, torch.from_numpy(p["w"]), None, node.stride,
                 node.padding),
        torch.from_numpy(p["mean"]), torch.from_numpy(p["var"]),
        torch.from_numpy(p["gamma"]), torch.from_numpy(p["beta"]),
        training=False, eps=1e-3)
    got = F.conv2d(x, torch.from_numpy(fused[node.key]["w"]),
                   torch.from_numpy(fused[node.key]["b"]), node.stride,
                   node.padding)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_decode_shapes_and_softmax():
    g = build_yolov8_graph(CFG)
    params = init_params(g, seed=1)
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 128, 128)).astype(
        np.float32)
    outs, _ = forward_float(g, params, jnp.asarray(x))
    preds = decode_float(outs, jnp.asarray(params["dfl"]["w"]))
    n = (16 * 16 + 8 * 8 + 4 * 4)
    assert preds.shape == (1, 84, n)
    # classes are sigmoid outputs
    assert float(preds[:, 4:].min()) >= 0 and float(preds[:, 4:].max()) <= 1


def test_calibration_taps_recorded():
    g = build_yolov8_graph(CFG)
    params = init_params(g, seed=2)
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    _, taps = forward_float(g, params, jnp.asarray(x), collect_taps=True)
    assert set(taps) == {c.tap for c in g.convs()} | {"start"}
    assert all(v.shape == (2,) for v in taps.values())
    np.testing.assert_allclose(np.asarray(taps["start"]),
                               np.abs(x).max(axis=(1, 2, 3)), rtol=1e-6)


def _conv_dot_precisions(jaxpr):
    """Precision params of every conv and dot in a closed jaxpr, sub-jaxprs
    (jit, custom_jvp, ...) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("conv_general_dilated", "dot_general"):
            found.append((eqn.primitive.name, eqn.params["precision"]))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)      # ClosedJaxpr
                if hasattr(sub, "eqns"):
                    found += _conv_dot_precisions(sub)
    return found


@pytest.mark.parametrize("path", ["forward_float", "collect_samples",
                                  "decode_float"])
def test_float_path_pins_highest_precision(path):
    """Every conv and dot of the float path asks for HIGHEST precision, so
    the GPU cannot run it in TF32 (calibration maxima must keep f32
    semantics)."""
    import jax
    from jax import lax

    from alpha_yolo_quant_tpu.quantize.calibrate import sample_walk

    cfg = QuantConfig(model="yolov8n", k=8, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    x = jnp.zeros((1, 3, 64, 64), jnp.float32)
    if path == "forward_float":
        fn = lambda p, x: forward_float(graph, p, x, collect_taps=True)
    elif path == "collect_samples":
        taps = [c.tap for c in graph.convs() if c.tap]
        fn = lambda p, x: sample_walk(graph, taps, p, x)
    else:
        fn = lambda p, x: decode_float(forward_float(graph, p, x)[0],
                                       p["dfl"]["w"])
    found = _conv_dot_precisions(jax.make_jaxpr(fn)(params, x).jaxpr)
    n_convs = len(graph.convs())
    assert sum(n == "conv_general_dilated" for n, _ in found) == n_convs
    if path == "decode_float":
        assert any(n == "dot_general" for n, _ in found)
    for name, prec in found:
        assert prec is not None and all(
            p == lax.Precision.HIGHEST for p in prec), (name, prec)
