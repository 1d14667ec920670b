"""Mesh parallelism on the 8-device virtual CPU mesh."""

import numpy as np

import conftest  # noqa: F401

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.forward import forward_float
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.head import decode_float
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.parallel.mesh import (
    data_parallel_step, make_mesh, make_mesh_2d, replicate, shard_batch,
    shard_params_tp, sharded_forward_fn,
)

RNG = np.random.default_rng(17)


def _setup(size=64):
    cfg = QuantConfig(model="yolov8n", image_size=size)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    return cfg, graph, params


def test_dp_calibration_reduces_across_devices():
    cfg, graph, params = _setup()
    mesh = make_mesh(8)
    step = sharded_forward_fn(graph, mesh, decode=True, collect_taps=True)
    imgs = shard_batch(mesh, RNG.uniform(0, 1, (8, 3, 64, 64)).astype(
        np.float32))
    out = step(replicate(mesh, params), imgs)
    # tap values equal the unsharded global maxima
    _, taps = forward_float(graph, params, imgs, collect_taps=True)
    for name in ("conv_p1", "x_down_2"):
        np.testing.assert_allclose(float(out["taps"][name]),
                                   float(np.max(np.asarray(taps[name]))),
                                   rtol=1e-6)


def test_tp_weight_sharding_matches_replicated():
    cfg, graph, params = _setup()
    mesh2 = make_mesh_2d(4, 2)
    params_tp = shard_params_tp(mesh2, params)
    imgs = jax.device_put(RNG.uniform(0, 1, (4, 3, 64, 64)).astype(
        np.float32), NamedSharding(mesh2, P("dp")))

    @jax.jit
    def step(pp, xx):
        outs, _ = forward_float(graph, pp, xx)
        return decode_float(outs, pp["dfl"]["w"])

    got = np.asarray(step(params_tp, imgs))
    want = np.asarray(step(params, np.asarray(imgs)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_dryrun_multichip_is_self_contained():
    """Simulate an outside caller: fresh process, NO conftest env forcing,
    import __graft_entry__ and call dryrun_multichip(8) directly. The
    function must force the virtual CPU mesh itself (called this way it
    once initialized the accelerator backend instead)."""
    _run_dryrun_subprocess(8, timeout=600)


def test_shard_map_serving_step_matches_local():
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    cfg, graph, params = _setup()
    calib = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    model = build_quantized_model(graph, params, max_a, cfg)
    fn, _ = build_int_pipeline(model, dfl_w_float=params["dfl"]["w"])

    mesh = make_mesh(8)
    step = data_parallel_step(fn, mesh)
    imgs = RNG.uniform(0, 1, (8, 3, 64, 64)).astype(np.float32)
    det_s, n_s = step(shard_batch(mesh, imgs))
    det_l, n_l = fn(imgs)
    np.testing.assert_array_equal(np.asarray(n_s), np.asarray(n_l))
    np.testing.assert_allclose(np.asarray(det_s), np.asarray(det_l),
                               rtol=1e-6)


def test_sp_height_sharding_matches_local():
    """Latency-mode spatial partitioning (SURVEY §2.9 sharding seams):
    the full-quant pipeline's preds with the input HEIGHT sharded over a
    2-device 'sp' mesh must be bitwise identical to the jitted unsharded
    run — height partitioning splits no reduction (GSPMD exchanges
    conv/pool halos between neighbors). sp=2 is the even-divisibility
    maximum at 64px (deepest map H = 64/32 = 2 rows; uneven shards hit
    an XLA partitioner halo-padding bug — see spatial_parallel_fn)."""
    from alpha_yolo_quant_tpu.parallel.mesh import spatial_parallel_fn
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    cfg, graph, params = _setup()
    calib = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    model = build_quantized_model(graph, params, max_a, cfg)
    fn, _ = build_int_pipeline(model, dfl_w_float=params["dfl"]["w"],
                               with_nms=False)

    mesh = make_mesh(2, axis="sp")
    sp_fn = spatial_parallel_fn(fn, mesh)
    imgs = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    got = np.asarray(sp_fn(imgs))
    want = np.asarray(jax.jit(fn)(imgs))
    np.testing.assert_array_equal(got, want)


def test_dp_sp_combined_mesh_matches_local():
    """dp x sp combined mesh (VERDICT r3 #6): batch sharded over 'dp',
    image height over 'sp' on a (2, 2) mesh — bitwise identical to the
    jitted unsharded run. Covers the regime between pure dp and pure sp:
    several concurrent requests, each spatially split."""
    from alpha_yolo_quant_tpu.parallel.mesh import dp_sp_parallel_fn
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    cfg, graph, params = _setup()
    calib = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    model = build_quantized_model(graph, params, max_a, cfg)
    fn, _ = build_int_pipeline(model, dfl_w_float=params["dfl"]["w"],
                               with_nms=False)

    mesh = make_mesh_2d(2, 2, axes=("dp", "sp"))
    dpsp_fn = dp_sp_parallel_fn(fn, mesh)
    imgs = RNG.uniform(0, 1, (4, 3, 64, 64)).astype(np.float32)
    got = np.asarray(dpsp_fn(imgs))
    want = np.asarray(jax.jit(fn)(imgs))
    np.testing.assert_array_equal(got, want)


def _run_dryrun_subprocess(n_devices, timeout):
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (f"import __graft_entry__ as g; g.dryrun_multichip({n_devices}); "
            "print('DRIVER_OK')")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DRIVER_OK" in r.stdout


def test_dryrun_multichip_scales_to_16_and_32():
    """Mesh-depth check (VERDICT r3 #6): the driver's dryrun contract must
    hold beyond 8 devices. Fresh process per count — XLA parses
    xla_force_host_platform_device_count once per process."""
    for n in (16, 32):
        _run_dryrun_subprocess(n, timeout=1200)


def test_two_process_distributed_parity():
    """Multi-host for real (SURVEY §2.9): two OS processes x 4 virtual CPU
    devices each, joined by jax.distributed over a localhost coordinator
    (the DCN analog). Exercises initialize_multihost, the cross-process
    calibration all-reduce, the DP serving step under shard_map, and a
    detection all-gather — each worker asserts parity with the
    single-process result (see tests/_multihost_worker.py)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(here, "_multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, coordinator, str(i), "2"],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            # generous: the two extra JAX processes compile a full
            # pipeline each and this test shares the box with the rest
            # of the suite — 900s timed out under full-suite contention
            # while passing in isolation in ~360s
            out, err = p.communicate(timeout=2400)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{err[-4000:]}"
    assert "MULTIHOST_OK" in outs[0][1], outs[0]
