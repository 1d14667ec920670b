"""Smoke run of the int-K YOLOv8 PTQ pipeline on NVIDIA GPUs.

    python chip_smoke.py             # one card: calibrate, golden, serve
    python chip_smoke.py --cards 4   # only the four-card dp phase

Drives the main path through the entry points a user calls, at full
width (640 px) with random weights and seeded synthetic images:

  device     the GPU is JAX's backend; card name and power limit, jax and
             jaxlib versions, XLA_FLAGS, compile-cache directory
  calibrate  `ayq calibrate` for yolov8n K=8; its max_a equals the same
             collect_stats run on the host CPU backend (rtol 1e-5)
  golden     int_forward(engine="auto") on 2 images: the six head
             accumulator edges are bit-equal to the numpy int64 golden
             runtime for yolov8n K=8/6/4 and yolov8s K=8, and
             decode_full_quant agrees with decode_full_quant_np; every
             other engine is bit-equal at yolov8n K=8
  serve      build_int_pipeline(engine="auto") behind
             serving.BatchCoalescer(max_batch=128); requests of
             1/3/17/64/128 images each equal one direct call
  cards      (--cards 4) data_parallel_step of the serving pipeline and
             sharded_forward_fn(collect_taps=True) over make_mesh(4),
             bitwise against one card running the same shards

Every phase runs in this one process and prints one line with its result
and seconds. Any failure raises: the exit code is non-zero and the ok line
is not printed. The last line of stdout is the JSON ok record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZE = 640
GOLDEN_CONFIGS = (("yolov8n", 8), ("yolov8n", 6), ("yolov8n", 4),
                  ("yolov8s", 8))
OTHER_ENGINES = ("xla", "s8", "nhwc", "s8_nhwc")
SERVE_SIZES = (1, 3, 17, 64, 128)
# calibration maxima: the GPU and the CPU both run the float path at
# HIGHEST precision, so they may differ only in f32 summation order
CALIB_RTOL = 1e-5
# decoded box rows: f32 on the device vs f64 in the golden decode; the
# operands are integers and halves far below 2^24, so anything beyond
# f32 rounding is a bug
BOX_RTOL = 1e-6


def fail(msg: str):
    raise RuntimeError(msg)


def phase(name: str, fn, *args):
    t0 = time.perf_counter()
    result, detail = fn(*args)
    print(f"phase {name}: ok {detail} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return result


def images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 3, SIZE, SIZE)).astype(np.float32)


def card_lines() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        fail("nvidia-smi listed no card")
    return out


# ---------------------------------------------------------------- checks

def check_golden_edges(model, outs, gold, label: str) -> None:
    """Each of the six head accumulator edges bit-equal to the int64
    golden runtime's."""
    for role in model.graph.outputs:
        got = np.asarray(outs[role]).astype(np.int64)
        want = np.asarray(gold[role]).astype(np.int64)
        if got.shape != want.shape or not np.array_equal(got, want):
            n_bad = (int(np.sum(got != want)) if got.shape == want.shape
                     else "shape")
            fail(f"{label}: head edge {role} differs from the int64 "
                 f"golden ({n_bad} elements)")


def check_decode(preds, want, label: str) -> None:
    """decode_full_quant vs decode_full_quant_np: class rows (16-bit
    sigmoid ints) exact, box rows within BOX_RTOL."""
    preds = np.asarray(preds, np.float64)
    if preds.shape != want.shape:
        fail(f"{label}: decode shape {preds.shape} != {want.shape}")
    if not np.array_equal(preds[:, 4:], want[:, 4:]):
        fail(f"{label}: decoded class rows differ from the golden decode")
    if not np.allclose(preds[:, :4], want[:, :4], rtol=BOX_RTOL, atol=0):
        err = np.max(np.abs(preds[:, :4] - want[:, :4]))
        fail(f"{label}: decoded boxes differ from the golden decode "
             f"(max abs {err})")


def check_detections_equal(got, want, label: str) -> None:
    """(det, n_det) of two runs over the same images: identical counts and
    identical kept rows (boxes, scores, classes)."""
    g_det, g_n = (np.asarray(t) for t in got)
    w_det, w_n = (np.asarray(t) for t in want)
    if not np.array_equal(g_n, w_n):
        fail(f"{label}: detection counts differ ({g_n} vs {w_n})")
    for i, n in enumerate(w_n):
        if not np.array_equal(g_det[i, :n], w_det[i, :n]):
            fail(f"{label}: detections of image {i} differ")


# ---------------------------------------------------------------- phases

def phase_device(n_cards: int, cache_dir: str):
    import jax
    import jaxlib.version

    if jax.default_backend() != "gpu":
        fail(f"JAX's backend is {jax.default_backend()!r}, not the GPU")
    if len(jax.devices()) < n_cards:
        fail(f"{n_cards} cards asked for, {len(jax.devices())} visible")
    for line in card_lines().splitlines():
        print(line)
    n_cached = (sum(len(f) for _, _, f in os.walk(cache_dir))
                if os.path.isdir(cache_dir) else 0)
    print(f"jax {jax.__version__} jaxlib {jaxlib.version.__version__}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
          f"{cache_dir} ({n_cached} files at start)")
    dev = jax.devices()[0]
    return dev, f"{dev.platform} {dev.device_kind} x{len(jax.devices())}"


def phase_calibrate():
    import jax

    from alpha_yolo_quant_tpu import cli
    from alpha_yolo_quant_tpu.config import QuantConfig
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.models.params import init_params
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_tpu.utils.io import read_max_a

    batch, limit = 8, 16
    with tempfile.TemporaryDirectory() as out:
        if cli.main(["calibrate", "--model", "yolov8n", "--k", "8",
                     "--image-size", str(SIZE), "--out", out,
                     "--batch-size", str(batch), "--limit",
                     str(limit)]) != 0:
            fail("ayq calibrate returned non-zero")
        got = read_max_a(os.path.join(out, "results", "max_a.txt"))
    # the same synthetic batches and random init the CLI uses
    cfg = QuantConfig(model="yolov8n", k=8, image_size=SIZE)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, (batch, 3, SIZE, SIZE)).astype(np.float32)
               for _ in range(limit // batch)]
    with jax.default_device(jax.devices("cpu")[0]):
        want = reduce_stats(collect_stats(graph, params, batches), "max", 8)
    if set(got) != set(want):
        fail("calibration taps differ between the GPU and the CPU")
    rel = max(abs(got[t] - want[t]) / abs(want[t]) for t in want)
    if rel > CALIB_RTOL:
        fail(f"max_a GPU vs CPU: max rel diff {rel:.3g} > {CALIB_RTOL}")
    return None, (f"{len(want)} taps, max_a GPU vs CPU max rel diff "
                  f"{rel:.3g} (rtol {CALIB_RTOL})")


def build_models(configs=GOLDEN_CONFIGS):
    """Quantized full-quant models for (model, K) configs, calibrated on
    the device like bench.py: random init, 2 seeded calibration images."""
    from alpha_yolo_quant_tpu.config import QuantConfig
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.models.params import init_params
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model

    records, models = {}, {}
    for name, k in configs:
        cfg = QuantConfig(model=name, k=k, full_quant=True, image_size=SIZE)
        graph = build_yolov8_graph(cfg)
        params = init_params(graph, seed=0)
        if name not in records:
            records[name] = collect_stats(graph, params, [images(1, 2)])
        max_a = reduce_stats(records[name], "max", k)
        models[(name, k)] = build_quantized_model(graph, params, max_a, cfg)
    return models


def run_auto_and_decode(model, x):
    """int_forward(engine="auto") as build_int_pipeline quantizes for it,
    plus decode_full_quant of the raw head accumulators, on the device."""
    import jax
    import jax.numpy as jnp

    from alpha_yolo_quant_tpu.runtime.interpreter import (
        decode_full_quant, device_plan, int_forward, quantize_input,
    )

    plan = device_plan(model)
    for lut in (plan["sig_lut"], plan["head"]["exp_lut"],
                plan["head"]["cls_sig_lut"]):
        if not lut.use_gather and lut.validated_backend != \
                jax.default_backend():
            fail(f"LUT {lut.kind} validated on {lut.validated_backend}")

    @jax.jit
    def step(x):
        q = quantize_input(x, model.cfg.k, out_dtype=jnp.bfloat16)
        outs = int_forward(model, plan, q, engine="auto")
        return outs, decode_full_quant(model, plan, outs)

    outs, preds = step(x)
    return jax.device_get(outs), jax.device_get(preds), plan


def run_engine(model, plan, x, engine):
    import jax

    from alpha_yolo_quant_tpu.runtime.interpreter import (
        int_forward, quantize_input,
    )

    return jax.device_get(jax.jit(lambda x: int_forward(
        model, plan, quantize_input(x, model.cfg.k), engine=engine))(x))


def phase_golden(models):
    from concurrent.futures import ThreadPoolExecutor

    from alpha_yolo_quant_tpu.runtime.golden import (
        decode_full_quant_np, golden_forward,
    )

    x = images(5, 2)
    # the int64 goldens run on host threads while the card compiles
    with ThreadPoolExecutor(len(models)) as pool:
        gold = {key: pool.submit(golden_forward, m, x)
                for key, m in models.items()}
        lines = []
        for (name, k), model in models.items():
            label = f"{name} K={k}"
            t0 = time.perf_counter()
            outs, preds, plan = run_auto_and_decode(model, x)
            g = gold[(name, k)].result()
            check_golden_edges(model, outs, g, f"{label} auto")
            check_decode(preds, decode_full_quant_np(model, g), label)
            corr = {lut.kind: len(lut.corrections) for lut in (
                plan["sig_lut"], plan["head"]["exp_lut"])}
            backend = plan["sig_lut"].validated_backend
            lines.append(f"{label}: 6 head edges bit-equal, decode equal "
                         f"(LUTs validated on {backend}, corrections "
                         f"{corr}; {time.perf_counter() - t0:.1f} s)")
            if (name, k) == ("yolov8n", 8):
                for engine in OTHER_ENGINES:
                    check_golden_edges(model, run_engine(model, plan, x,
                                                         engine),
                                       g, f"{label} {engine}")
                lines.append(f"{label}: engines {', '.join(OTHER_ENGINES)} "
                             "bit-equal")
    for line in lines:
        print("  " + line)
    return None, (f"{len(models)} configs at {SIZE} px bit-equal to the "
                  "int64 golden")


def phase_serve(model):
    import jax

    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline
    from alpha_yolo_quant_tpu.serving import BatchCoalescer

    fn, _ = build_int_pipeline(model, engine="auto")
    reqs = [images(100 + i, n) for i, n in enumerate(SERVE_SIZES)]
    with BatchCoalescer(fn, max_batch=128,
                        image_shape=(3, SIZE, SIZE)) as co:
        co.submit(reqs[0]).result()   # compile the max-batch step first
        t0 = time.perf_counter()
        futs = [co.submit(r) for r in reqs]
        got = [(f.result(timeout=600), time.perf_counter() - t0)
               for f in futs]
        stats = co.snapshot()
    direct = jax.jit(fn)
    for (res, _), r, n in zip(got, reqs, SERVE_SIZES):
        check_detections_equal(res, jax.device_get(direct(r)),
                               f"serve request of {n}")
    lat = ", ".join(f"{n}:{t * 1e3:.0f}" for (_, t), n in zip(got,
                                                               SERVE_SIZES))
    print(f"  serve (information, not a claim): completion ms since "
          f"submit {{{lat}}}; {stats['flushes']} steps, mean fill "
          f"{stats['mean_fill']:.2f}")
    return None, (f"{len(reqs)} requests answered, each equal to a direct "
                  "call")


def phase_cards(n_cards: int):
    import jax
    import jax.numpy as jnp

    from alpha_yolo_quant_tpu.models.forward import forward_float
    from alpha_yolo_quant_tpu.models.params import init_params
    from alpha_yolo_quant_tpu.parallel.mesh import (
        data_parallel_step, make_mesh, replicate, shard_batch,
        sharded_forward_fn,
    )
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    model = build_models((("yolov8n", 8),))[("yolov8n", 8)]
    graph = model.graph
    params = init_params(graph, seed=0)
    per_dev = 16
    x = images(7, per_dev * n_cards)
    mesh = make_mesh(n_cards)
    fn, _ = build_int_pipeline(model, engine="auto")
    det = jax.device_get(data_parallel_step(fn, mesh)(shard_batch(mesh, x)))
    taps = jax.device_get(sharded_forward_fn(graph, mesh, decode=False,
                                             collect_taps=True)(
        replicate(mesh, params), shard_batch(mesh, x))["taps"])
    # one card running the same per-device shards
    one = jax.jit(fn)
    tap_one = jax.jit(lambda p, x: {
        k: jnp.max(v) for k, v in forward_float(
            graph, p, x, collect_taps=True)[1].items()})
    shards = [x[i * per_dev:(i + 1) * per_dev] for i in range(n_cards)]
    outs = [jax.device_get(one(s)) for s in shards]
    want = tuple(np.concatenate([o[j] for o in outs]) for j in range(2))
    check_detections_equal(det, want, f"dp={n_cards} detections")
    tmax = [jax.device_get(tap_one(params, s)) for s in shards]
    for name, v in taps.items():
        ref = max(t[name] for t in tmax)
        if np.float32(v) != np.float32(ref):
            fail(f"dp={n_cards} tap {name}: {v!r} != one card {ref!r}")
    return None, (f"dp={n_cards}: detections of {len(x)} images and "
                  f"{len(taps)} tap maxima bitwise equal to one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card data-parallel phase")
    args = ap.parse_args(argv)

    from alpha_yolo_quant_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    cache_dir = configure_compile_cache()
    dev = phase("device", phase_device, args.cards, cache_dir)
    if args.cards == 1:
        phase("calibrate", phase_calibrate)
        models = phase("build", lambda: (build_models(),
                                         f"{len(GOLDEN_CONFIGS)} models "
                                         "calibrated on the device"))
        phase("golden", phase_golden, models)
        phase("serve", phase_serve, models[("yolov8n", 8)])
    else:
        phase("cards", phase_cards, args.cards)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
