"""Worker process for the 2-process ``jax.distributed`` CPU cluster test
(tests/test_parallel.py::test_two_process_distributed_parity).

Each process owns 4 virtual CPU devices (XLA_FLAGS set by the launcher);
``initialize_multihost`` connects them into one 8-device cluster over a
localhost coordinator — the DCN-analog of SURVEY §2.9's "jax.distributed
initialization for multi-chip". The worker then runs the real library
surfaces across the cluster:

  1. the calibration tap all-reduce (cross-process max),
  2. the DP serving step (quantized pipeline under shard_map),
  3. a detection all-gather (multihost_utils.process_allgather),

and asserts parity with the same computation run single-process on the
full batch (which every process can do locally — the inputs are
deterministic).

Usage: _multihost_worker.py <coordinator> <process_id> <num_processes>
"""

import sys

import numpy as np

coordinator, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

from alpha_yolo_quant_tpu.parallel.mesh import initialize_multihost

initialize_multihost(coordinator=coordinator, num_processes=nprocs,
                     process_id=pid)

import jax
from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P

assert jax.process_count() == nprocs, jax.process_count()
n_local = len(jax.local_devices())
n_global = len(jax.devices())
assert n_global == nprocs * n_local, (n_global, n_local)

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.forward import forward_float
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.parallel.mesh import (
    data_parallel_step, make_mesh, replicate, sharded_forward_fn,
)
from alpha_yolo_quant_tpu.quantize.calibrate import collect_stats, reduce_stats
from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

SIZE = 64
cfg = QuantConfig(model="yolov8n", image_size=SIZE)
graph = build_yolov8_graph(cfg)
params = init_params(graph, seed=0)
rng = np.random.default_rng(23)
imgs_full = rng.uniform(0, 1, (n_global, 3, SIZE, SIZE)).astype(np.float32)

mesh = make_mesh()
sharding = NamedSharding(mesh, P("dp"))
local = imgs_full[pid * n_local: (pid + 1) * n_local]
gimgs = jax.make_array_from_process_local_data(sharding, local)

# ---- 1. calibration all-reduce across processes ----
cal_step = sharded_forward_fn(graph, mesh, decode=True, collect_taps=True)
out = cal_step(replicate(mesh, params), gimgs)
_, taps_local = forward_float(graph, params, imgs_full, collect_taps=True)
for name in ("conv_p1", "x_down_2"):
    got = float(np.asarray(jax.device_get(out["taps"][name])))
    want = float(np.max(np.asarray(taps_local[name])))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), \
        (name, got, want)

# ---- 2+3. DP quantized serving step + detection all-gather ----
calib = rng.uniform(0, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
model = build_quantized_model(graph, params, max_a, cfg)
fn, _ = build_int_pipeline(model, dfl_w_float=params["dfl"]["w"])
step = data_parallel_step(fn, mesh)
det, n_det = step(gimgs)
det_all = multihost_utils.process_allgather(det, tiled=True)
n_all = multihost_utils.process_allgather(n_det, tiled=True)

det_ref, n_ref = fn(imgs_full)
np.testing.assert_array_equal(np.asarray(n_all), np.asarray(n_ref))
np.testing.assert_allclose(np.asarray(det_all), np.asarray(det_ref),
                           rtol=1e-6, atol=1e-6)

if pid == 0:
    print(f"MULTIHOST_OK procs={nprocs} devices={n_global} "
          f"dets={int(np.asarray(n_all).sum())}", flush=True)
