"""Bit-exactness of every selectable engine vs the XLA nibble-split
interpreter, and the engine-name contract."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.quantize.calibrate import collect_stats, reduce_stats
from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
from alpha_yolo_quant_tpu.runtime.interpreter import (
    ENGINES, build_int_pipeline, device_plan, int_forward, quantize_input,
)

RNG = np.random.default_rng(7)


def _setup(size=64, full=False):
    cfg = QuantConfig(model="yolov8n", k=8, image_size=size,
                      full_quant=full)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=2)
    calib = RNG.uniform(0, 1, (1, 3, size, size)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    model = build_quantized_model(graph, params, max_a, cfg)
    return cfg, model




def _assert_outputs_equal(model, want, got, msg=""):
    for role in model.graph.outputs:
        np.testing.assert_array_equal(
            np.asarray(got[role]).astype(np.int64),
            np.asarray(want[role]).astype(np.int64), err_msg=f"{msg}{role}")


@pytest.mark.parametrize("engine", [e for e in ENGINES if e != "xla"])
@pytest.mark.parametrize("k", [8, 6, 4])
def test_engine_bit_exact(engine, k):
    """Every engine is bit-identical to the XLA nibble-split interpreter,
    across bit widths."""
    cfg = QuantConfig(model="yolov8n", k=k, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=2)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max", k)
    model = build_quantized_model(graph, params, max_a, cfg)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    xq = quantize_input(jnp.asarray(x), k)
    plan = device_plan(model)
    want = int_forward(model, plan, xq, engine="xla")
    got = int_forward(model, plan, xq, engine=engine)
    _assert_outputs_equal(model, want, got, msg=f"{engine} k={k} ")


@pytest.mark.parametrize("engine", ["fused", "packed", "int4_gemm"])
def test_removed_engine_rejected(engine):
    """Names outside ENGINES — the removed kernel engines among them —
    raise ValueError, and the message names the engines that remain."""
    cfg, model = _setup()
    xq = quantize_input(jnp.zeros((1, 3, 64, 64), jnp.float32), 8)
    for call in (lambda: int_forward(model, device_plan(model), xq,
                                     engine=engine),
                 lambda: build_int_pipeline(model, engine=engine)):
        with pytest.raises(ValueError) as err:
            call()
        assert all(e in str(err.value) for e in ENGINES)


def test_engines_exact_with_saturated_concat_edges():
    """Chained-residual concat edges carrying |x| up to 3*qmax = 381 must
    stay exact through the s8-based engines (the 3-part int8 split; round-1
    two-part split wrapped silently for |x| in (254, 381])."""
    cfg, model = _setup()
    tamper = dict(model.max_a)
    graph = model.graph
    tamper[model.convs["C2F_4_conv_0"].node.out_tap] *= 0.05
    tamper[model.convs["C2F_6_conv_0"].node.out_tap] *= 0.05
    params = init_params(graph, seed=2)
    model = build_quantized_model(graph, params, tamper, cfg)
    wide_edges = [e for e, a in model.edge_amax_int.items() if a > 254]
    assert wide_edges, "plan must declare 381-wide edges"

    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    xq = quantize_input(jnp.asarray(x), 8)
    env = int_forward(model, device_plan(model), xq, keep_env=True)
    observed = max(int(np.abs(np.asarray(env["__env__"][e])).max())
                   for e in wide_edges)
    assert observed > 254, "test data must actually exceed the 2-part range"
    want = {r: env[r] for r in model.graph.outputs}
    for engine in ("s8", "auto", "s8_nhwc"):
        got = int_forward(model, device_plan(model), xq, engine=engine)
        _assert_outputs_equal(model, want, got, msg=f"{engine} saturated ")
