"""Artifact round-trip: export -> model_from_artifacts must reproduce the
plan bit-for-bit (the stage-7/8 hand-off without the mtime hack)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.export.artifacts import export_all
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.quantize.calibrate import collect_stats, reduce_stats
import os
from alpha_yolo_quant_tpu.quantize.loadq import model_from_artifacts
from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
from alpha_yolo_quant_tpu.runtime.golden import golden_forward
from alpha_yolo_quant_tpu.runtime.interpreter import (
    device_plan, int_forward, quantize_input,
)

RNG = np.random.default_rng(13)


def test_artifact_roundtrip(tmp_path):
    cfg = QuantConfig(model="yolov8n", k=8, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=4)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    built = build_quantized_model(graph, params, max_a, cfg)

    x = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    env = golden_forward(built, x)
    out = str(tmp_path / "8_nano")
    export_all(built, env, params, out, warn=lambda *a: None)

    loaded = model_from_artifacts(out, cfg)
    for name, c in built.convs.items():
        lc = loaded.convs[name]
        np.testing.assert_array_equal(lc.w_q, c.w_q, err_msg=name)
        np.testing.assert_array_equal(lc.b_q, c.b_q, err_msg=name)
        np.testing.assert_allclose(lc.acc_scale, c.acc_scale, rtol=0,
                                   atol=0, err_msg=name)
        if c.node.silu:
            for f in ("r1", "s1", "r2", "s2"):
                np.testing.assert_array_equal(getattr(lc, f),
                                              getattr(c, f), err_msg=name)
    for key, rq in built.requants.items():
        lrq = loaded.requants[key]
        assert (lrq.rescale, lrq.shift) == (rq.rescale, rq.shift)

    # loaded model runs identically
    xq = quantize_input(jnp.asarray(x), 8)
    want = int_forward(built, device_plan(built), xq)
    got = int_forward(loaded, device_plan(loaded), xq)
    for role in graph.outputs:
        np.testing.assert_array_equal(np.asarray(got[role]),
                                      np.asarray(want[role]))


def test_packed_state_dict_load(tmp_path):
    from alpha_yolo_quant_tpu.quantize.loadq import (
        model_from_packed_state_dict,
    )

    cfg = QuantConfig(model="yolov8n", k=8, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=4)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    built = build_quantized_model(graph, params, max_a, cfg)
    out = str(tmp_path / "8_nano")
    env = golden_forward(built, RNG.uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32))
    export_all(built, env, params, out, warn=lambda *a: None)

    loaded = model_from_packed_state_dict(out, cfg)
    for name, c in built.convs.items():
        np.testing.assert_array_equal(loaded.convs[name].w_q, c.w_q)
        np.testing.assert_array_equal(loaded.convs[name].b_q, c.b_q)
        if c.node.silu:
            np.testing.assert_array_equal(loaded.convs[name].r2, c.r2)


def test_full_quant_packed_roundtrip_decode(tmp_path):
    """Full-quant packed dict carries the QUANTIZED dfl (reference
    stage_7 packing on a 6b tree); the reload must recover the head plan
    from dfl_conv ints + the stored bias_scales/dfl_scale — detections
    through the q_NMS pipeline stay bit-identical to the built model."""
    from alpha_yolo_quant_tpu.export.pickles import load_packed_state_dict
    from alpha_yolo_quant_tpu.quantize.loadq import (
        model_from_artifacts as mfa, model_from_packed_state_dict,
    )
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    cfg = QuantConfig(model="yolov8n", k=8, image_size=64, full_quant=True)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=4)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    built = build_quantized_model(graph, params, max_a, cfg)
    out = str(tmp_path / "8_nano")
    env = golden_forward(built, RNG.uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32))
    export_all(built, env, params, out, warn=lambda *a: None)

    sd = load_packed_state_dict(
        os.path.join(out, "results", "QUANT_WEIGHTS_8.pickle"))
    np.testing.assert_array_equal(       # packed dfl is the QUANTIZED one
        np.asarray(sd["dfl.weight"]).reshape(-1),
        np.asarray(built.head.dfl_w_q).reshape(-1))

    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    fn_b, _ = build_int_pipeline(built)
    det_b, n_b = fn_b(jnp.asarray(x))
    for loaded in (model_from_packed_state_dict(out, cfg), mfa(out, cfg)):
        h = loaded.head
        assert h.dfl_acc_scale == built.head.dfl_acc_scale
        assert (h.dfl_r, h.dfl_s) == (built.head.dfl_r, built.head.dfl_s)
        fn_l, _ = build_int_pipeline(loaded)
        det_l, n_l = fn_l(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(n_l), np.asarray(n_b))
        np.testing.assert_array_equal(np.asarray(det_l), np.asarray(det_b))


def test_full_quant_load_guards_partial_tree(tmp_path):
    """Loading a PARTIAL-quant export under a full-quant cfg must fail
    loudly: the packed dict's dfl.weight is the float arange and there
    is no bias_scales/dfl_scale.pickle — int-truncating it would build a
    silently wrong head plan. Also: full-quant trees carry no float
    dfl.pickle, so dfl_weights_from_artifacts falls back to the frozen
    arange(16) instead of crashing (the serve --from-artifacts path)."""
    from alpha_yolo_quant_tpu.quantize.loadq import (
        dfl_weights_from_artifacts, model_from_packed_state_dict,
    )

    cfg = QuantConfig(model="yolov8n", k=8, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=4)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    built = build_quantized_model(graph, params, max_a, cfg)
    out = str(tmp_path / "8_nano")
    env = golden_forward(built, RNG.uniform(0, 1, (1, 3, 64, 64)).astype(
        np.float32))
    export_all(built, env, params, out, warn=lambda *a: None)

    cfg_fq = QuantConfig(model="yolov8n", k=8, image_size=64,
                         full_quant=True)
    with pytest.raises(FileNotFoundError, match="partial-quant"):
        model_from_packed_state_dict(out, cfg_fq)

    # full-quant tree: no dfl.pickle, fallback arange
    built_fq = build_quantized_model(graph, params, max_a, cfg_fq)
    out_fq = str(tmp_path / "8_nano_fq")
    env_fq = golden_forward(built_fq, RNG.uniform(0, 1, (1, 3, 64, 64))
                            .astype(np.float32))
    export_all(built_fq, env_fq, params, out_fq, warn=lambda *a: None)
    assert not os.path.exists(os.path.join(out_fq, "weights_pickle",
                                           "dfl.pickle"))
    np.testing.assert_array_equal(
        dfl_weights_from_artifacts(out_fq).reshape(-1),
        np.arange(16, dtype=np.float32))


def test_reexport_partial_over_full_quant_tree(tmp_path):
    """Re-exporting PARTIAL into a dir that held a full-quant tree must
    remove the stale full-quant dfl artifacts (dfl_conv/dfl_bias/
    dfl_scale): a stale dfl_scale.pickle next to a fresh partial packing
    would defeat loadq's partial-tree guard and build a silently wrong
    head plan (and vice versa for full over partial)."""
    from alpha_yolo_quant_tpu.quantize.loadq import (
        model_from_packed_state_dict,
    )

    graph8 = build_yolov8_graph(QuantConfig(model="yolov8n", k=8,
                                            image_size=64))
    params = init_params(graph8, seed=4)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph8, params, [calib]), "max")
    x = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    out = str(tmp_path / "8_nano")

    cfg_fq = QuantConfig(model="yolov8n", k=8, image_size=64,
                         full_quant=True)
    built_fq = build_quantized_model(graph8, params, max_a, cfg_fq)
    export_all(built_fq, golden_forward(built_fq, x), params, out,
               warn=lambda *a: None)
    assert os.path.exists(os.path.join(out, "bias_scales",
                                       "dfl_scale.pickle"))

    cfg = QuantConfig(model="yolov8n", k=8, image_size=64)
    built = build_quantized_model(graph8, params, max_a, cfg)
    export_all(built, golden_forward(built, x), params, out,
               warn=lambda *a: None)
    for stale in ("bias_scales/dfl_scale.pickle",
                  "weights_pickle/dfl_conv.pickle",
                  "weights_pickle/dfl_bias.pickle"):
        assert not os.path.exists(os.path.join(out, stale)), stale
    # the tree now loads as partial; a full-quant load is rejected
    model_from_artifacts(out, cfg)
    with pytest.raises(FileNotFoundError, match="partial-quant"):
        model_from_packed_state_dict(out, cfg_fq)
    # and full-quant re-export over the partial tree drops dfl.pickle
    export_all(built_fq, golden_forward(built_fq, x), params, out,
               warn=lambda *a: None)
    assert not os.path.exists(os.path.join(out, "weights_pickle",
                                           "dfl.pickle"))
    model_from_packed_state_dict(out, cfg_fq)


@pytest.mark.parametrize("k", [4, 6])
def test_bitwidth_sweep_roundtrip(tmp_path, k):
    """Config #4: calibrate -> quantize -> export -> reload at K=4/6 stays
    bit-identical (K=8 covered by test_artifact_roundtrip)."""
    cfg = QuantConfig(model="yolov8n", k=k, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=11)
    calib = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max", k)
    built = build_quantized_model(graph, params, max_a, cfg)
    assert int(np.abs(built.convs["Conv_P1"].w_q).max()) <= cfg.qmax

    x = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    env = golden_forward(built, x)
    out = str(tmp_path / cfg.main_dir_name)
    export_all(built, env, params, out, warn=lambda *a: None)
    # K-bit verilog widths in the weight files
    import glob
    f = glob.glob(os.path.join(out, "quant_weights_yolov8n",
                               "Conv_P1_*.txt"))[0]
    first = [l for l in open(f) if l.startswith("weight[0]")][0]
    assert f"{k-1}'b" in first

    loaded = model_from_artifacts(out, cfg)
    xq = quantize_input(jnp.asarray(x), k)
    want = int_forward(built, device_plan(built), xq)
    got = int_forward(loaded, device_plan(loaded), xq)
    for role in graph.outputs:
        np.testing.assert_array_equal(np.asarray(got[role]),
                                      np.asarray(want[role]))
    # the reloaded model also runs bit-identically through the auto
    # serving engine (the full engine matrix has its own tests)
    got_p = int_forward(loaded, device_plan(loaded), xq, engine="auto")
    for role in graph.outputs:
        np.testing.assert_array_equal(np.asarray(got_p[role]),
                                      np.asarray(want[role]))
