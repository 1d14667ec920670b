"""End-to-end int-K YOLOv8 inference throughput on the GPU.

Prints ONE JSON line: {"metric", "value" (img/s), "unit", "mfu",
"platform", "device_kind", "device_count"}. Run as a script it refuses
any backend but the GPU; a CPU number is not a device metric.
"""

import json
import sys
import time

import numpy as np

BATCH = 128
WARMUP = 3
ITERS = 10

# Published dense peaks per device kind, keyed by the exact
# jax.devices()[0].device_kind (NVIDIA H100 SXM data sheet, at its
# 700 W limit: bf16 989 TFLOP/s, int8 1,979 TOP/s, HBM3 3.35 TB/s).
# A kind that is not listed gets no utilization figure, never a guess.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12,
                              "hbm_bytes": 3.35e12},
}


def mfu(device_kind: str, flops_per_s: float):
    """Model FLOP/s over the device's bf16 dense peak (the auto engine's
    convs run in bf16), or None — with a note on stderr — for a device
    kind without a PEAKS entry."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        print(f"mfu: no peak recorded for device kind {device_kind!r}; "
              "reporting null", file=sys.stderr)
        return None
    return flops_per_s / peak["bf16_flops"]


def main(model="yolov8n", k=8, image_size=640, engine="auto", batch=BATCH,
         iters=ITERS, input_dtype="f32", coalesce=0, dp=0):
    """dp=N runs the slope-timed loop under the shard_map data-parallel
    step on an N-device mesh. The global batch shards over N devices;
    the carry/consumption rules apply to the GLOBAL step exactly as on
    one device — the dep threads into the sharded input and one element
    of every (batch-sharded) output leaf rides the scalar carry, so no
    per-device program loses liveness. dp>1 appends _dp{N} to the metric
    and reports aggregate img/s; mfu is per device."""
    import jax

    from alpha_yolo_quant_tpu.config import QuantConfig
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.models.params import init_params
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    cfg = QuantConfig(model=model, k=k, full_quant=True,
                      image_size=image_size)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    metric = f"{model}_{image_size}_int{k}_e2e"

    calib = np.random.default_rng(1).uniform(
        0, 1, (2, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max")
    qmodel = build_quantized_model(graph, params, max_a, cfg)
    if coalesce and dp:
        raise SystemExit("--dp composes with --coalesce through "
                         "serving.BatchCoalescer, not the bench harness")
    if coalesce:
        # `coalesce` requests of `batch` images each ride ONE conv-stack
        # step — per-request quantize, bf16-level concat (bit-exact vs
        # per-request runs: tests/test_serving.py). Throughput counts
        # all real images.
        fn_multi, _ = build_int_pipeline(qmodel, engine=engine,
                                         coalesce_requests=coalesce)
        metric += f"_co{coalesce}x{batch}"
    else:
        if dp:
            n_dev = len(jax.devices())
            if dp > n_dev:
                raise SystemExit(f"--dp {dp}: only {n_dev} devices visible")
            if batch % dp:
                raise SystemExit(f"--dp {dp} must divide --batch {batch}")
            if dp > 1:
                metric += f"_dp{dp}"
        fn, _ = build_int_pipeline(qmodel, engine=engine)

    import jax.numpy as jnp

    # The timed loop chains iterations through a data dependency so no
    # iteration can be hoisted or elided. The dependency is a SCALAR
    # carry entering as `images + isnan(acc)` (adds exact 0, fuses into
    # the quantize read, not foldable since acc is a runtime value) — the
    # images buffer stays read-only; writing even one element of it per
    # iteration would force XLA to copy the whole batch each iteration.
    # The carry threads into EVERY input (with several coalesced
    # requests, work depending only on un-carried inputs is
    # loop-invariant and hoists), and one element of EVERY output leaf
    # is consumed, or XLA drops the work that feeds unused outputs.
    if coalesce:
        def step_inner(imgs):
            return jax.tree_util.tree_leaves(fn_multi(*imgs))
        n_inputs = coalesce
    else:
        def step_inner(imgs):
            return jax.tree_util.tree_leaves(fn(imgs[0]))
        n_inputs = 1

    def loop(images, n_iters, init=None):
        def body(i, acc):
            dep = jnp.isnan(acc)
            leaves = step_inner(tuple(
                im + dep.astype(im.dtype) for im in images))
            # liveness comes from the CARRY consuming one element of
            # EVERY output leaf (a barrier does not keep computations
            # whose own barrier result is unused); the barrier's job is
            # blocking slicing/strength-reduction into the consumed
            # elements
            leaves = jax.lax.optimization_barrier(tuple(leaves))
            tot = acc
            for leaf in leaves:
                tot = tot + leaf.reshape(-1)[0].astype(jnp.float32)
            return tot
        return jax.lax.fori_loop(
            0, n_iters, body,
            jnp.float32(0) if init is None else init)

    if dp:
        # each device runs the VERBATIM one-device carry loop on its
        # batch shard (so every liveness rule holds per-device
        # program-for-program) and returns its own carry;
        # the host sums the dp scalars after the timed fetch. Slicing a
        # dp-sharded leaf from outside the shard_map instead is both
        # unimplemented under sharding-in-types and a liveness hazard.
        from jax.sharding import PartitionSpec

        from alpha_yolo_quant_tpu.parallel.mesh import make_mesh

        shard_loop = jax.shard_map(
            # the carry starts device-varying (pcast) so the per-device
            # loop carries may diverge
            lambda im, n: loop(
                (im,), n,
                init=jax.lax.pcast(jnp.float32(0), ("dp",),
                                   to="varying")).reshape(1),
            mesh=make_mesh(dp),
            in_specs=(PartitionSpec("dp"), PartitionSpec()),
            out_specs=PartitionSpec("dp"))

        @jax.jit
        def chained(images, n_iters):
            return shard_loop(images[0], n_iters)
    else:
        @jax.jit
        def chained(images, n_iters):
            return loop(images, n_iters)

    rng0 = np.random.default_rng(0)
    images = [rng0.uniform(
        0, 1, (batch, 3, cfg.image_size, cfg.image_size)).astype(
            np.float32) for _ in range(n_inputs)]
    if input_dtype == "u8":
        # serving-faithful ingest: raw uint8 pixels, normalized on device
        # (quantize_input: u/255 in f32 is bit-identical to a float
        # loader); --input u8 measures the u8 path.
        images = [np.round(im * 255.0).astype(np.uint8) for im in images]
        metric += "_u8"
    images = tuple(jax.device_put(im) for im in images)

    # Two-point slope timing: each synchronous call pays a fixed
    # dispatch+fetch cost, so wall/iters overstates per-iteration cost;
    # the slope between two iteration counts cancels the fixed term.
    # n_iters is passed as a device scalar so one compile serves the
    # warmup and both measured iteration counts.
    def fetch(res):
        # the fetch IS the completion barrier; dp returns per-device
        # carries summed on host, one device a scalar
        return float(np.asarray(res).sum())

    fetch(chained(images, jnp.int32(WARMUP)))   # compile + warm
    n_hi = 3 * iters
    # Noise is additive (scheduler jitter only ever ADDS wall time to a
    # fixed computation), so take the min PER LEG across repetitions and
    # difference the two minima. Taking the min over per-rep slopes
    # instead is biased optimistic: noise on a rep's SHORT leg lowers
    # that rep's slope, so min-across-slopes systematically selects
    # noisy-short-leg reps and inflates img/s.
    t_lo_min, t_hi_min = float("inf"), float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fetch(chained(images, jnp.int32(iters)))  # fetch forces completion
        t_lo_min = min(t_lo_min, time.perf_counter() - t0)
        t0 = time.perf_counter()
        fetch(chained(images, jnp.int32(n_hi)))
        t_hi_min = min(t_hi_min, time.perf_counter() - t0)
    dt = (t_hi_min - t_lo_min) / (n_hi - iters)
    if dt <= 0:
        raise RuntimeError(
            f"non-positive slope (t_lo={t_lo_min:.4f}s, "
            f"t_hi={t_hi_min:.4f}s): measurement is noise-dominated; "
            "re-run with --iters higher")

    img_s = batch * n_inputs / dt
    per_dev = img_s / dp if dp else img_s
    if dp and dp > 1:
        print(f"dp={dp}: {img_s:.1f} img/s aggregate, "
              f"{per_dev:.1f} img/s/device", file=sys.stderr)
    # per-device MFU: model conv MACs only (graph-IR shape walk) in the
    # numerator, the full e2e wall (quantize/decode/q_NMS included) in
    # the denominator
    from alpha_yolo_quant_tpu.parallel.pipeline import _node_costs

    flops_img = 2.0 * sum(_node_costs(graph, cfg.image_size))
    dev = jax.devices()[0]
    util = mfu(dev.device_kind, per_dev * flops_img)
    print(json.dumps({
        "metric": metric,
        "value": round(img_s, 2),
        "unit": "img/s",
        "mfu": None if util is None else round(util, 4),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    import argparse

    import jax

    from alpha_yolo_quant_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's backend here "
                         f"is {jax.default_backend()!r}")
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov8n")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--batch", type=int, default=None,
                    help="GLOBAL batch (default: 128 per device, i.e. "
                         "128 * max(dp, 1))")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--dp", type=int, default=0,
                    help="run under the shard_map data-parallel step "
                         "over N local devices")
    ap.add_argument("--input", choices=["f32", "u8"], default="f32",
                    help="image ingest dtype: f32 [0,1] tensors (the "
                         "default) or raw uint8 pixels normalized on "
                         "device")
    ap.add_argument("--coalesce", type=int, default=0,
                    help="serve N coalesced requests of --batch images "
                         "each through one step; throughput counts all "
                         "real images")
    a = ap.parse_args()
    main(model=a.model, k=a.k, image_size=a.image_size, engine=a.engine,
         batch=(a.batch if a.batch is not None
                else BATCH * max(a.dp, 1)),
         iters=a.iters, input_dtype=a.input, coalesce=a.coalesce,
         dp=a.dp)
