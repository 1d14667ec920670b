"""Pipeline CLI — the stage scripts as subcommands over a shared artifact
store.

The reference is driven by editing stage_0.py and running nine stage
scripts in order (reference README.md:41-53); here each stage is a
subcommand with flags, all writing into one artifact directory:

  prepare    stage 1+2: load checkpoint, fuse BatchNorm, save fused params
  calibrate  stage 4+5: activation statistics -> max_a_all.txt + max_a.txt
  quantize   stage 6/6b: build the integer model, golden-image run, export
             the full artifact tree (Verilog txt, pickles, packed weights)
  eval-float stage 3/4: fp32 COCO mAP
  eval-int8  stage 8/8b: quantized COCO mAP (float NMS or full q_NMS)
  memsim     stage 8c: SRAM allocation simulation
  demo       golden-image smoke test with a detection plot
  serve      batch-coalescing inference service over an image list
  accept     one-command accuracy acceptance (all gates + K sweep)
  bench      device throughput (one device or --dp)

Run as: python -m alpha_yolo_quant_tpu.cli <command> [flags]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _cfg(args):
    from alpha_yolo_quant_tpu.config import QuantConfig

    return QuantConfig(model=args.model, k=args.k,
                       calib_mode=getattr(args, "mode", "max"),
                       full_quant=getattr(args, "full_quant", False),
                       image_size=args.image_size)


def _graph_params(args, cfg):
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.models.params import init_params
    from alpha_yolo_quant_tpu.utils.params_io import load_params

    graph = build_yolov8_graph(cfg)
    if getattr(args, "weights", None):
        params = load_params(args.weights)
    else:
        print("NOTE: no --weights given; using random init", file=sys.stderr)
        params = init_params(graph, seed=0)
    return graph, params


def _load_max_a(args):
    from alpha_yolo_quant_tpu.utils.io import read_max_a

    return read_max_a(args.max_a)


def _calib_batches(args, cfg):
    if args.coco_images and args.coco_ann:
        from alpha_yolo_quant_tpu.data.coco import CocoValDataset, batches

        ds = CocoValDataset(args.coco_images, args.coco_ann,
                            limit=args.limit)
        for imgs, _ in batches(ds, args.batch_size, cfg.image_size):
            yield imgs
    else:
        print("NOTE: no COCO path; using synthetic calibration batches",
              file=sys.stderr)
        rng = np.random.default_rng(0)
        for _ in range(max(1, (args.limit or 8) // args.batch_size)):
            yield rng.uniform(0, 1, (args.batch_size, 3, cfg.image_size,
                                     cfg.image_size)).astype(np.float32)


def cmd_prepare(args):
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.models.params import (
        fuse_batchnorm, init_raw_params, load_torch_checkpoint,
    )
    from alpha_yolo_quant_tpu.export.artifacts import make_dirs
    from alpha_yolo_quant_tpu.utils.params_io import save_params

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    if args.checkpoint:
        raw = load_torch_checkpoint(graph, args.checkpoint)
    else:
        print("NOTE: no --checkpoint; random raw params", file=sys.stderr)
        raw = init_raw_params(graph, seed=0)
    fused = fuse_batchnorm(graph, raw)
    make_dirs(args.out)
    path = os.path.join(args.out, "results", "weights_batchnf.npz")
    save_params(fused, path)
    print(f"fused params -> {path}")


def cmd_calibrate(args):
    from alpha_yolo_quant_tpu.quantize.calibrate import (
        collect_samples, collect_stats, load_batches, reduce_stats,
        save_batches,
    )
    from alpha_yolo_quant_tpu.export.artifacts import make_dirs
    from alpha_yolo_quant_tpu.utils.io import write_max_a, write_max_a_all

    cfg = _cfg(args)
    graph, params = _graph_params(args, cfg)
    if args.dp and args.batch_size % args.dp:
        raise SystemExit(f"--dp {args.dp} must divide the batch size "
                         f"{args.batch_size}")
    records = collect_stats(graph, params, _calib_batches(args, cfg),
                            dp=args.dp or None)
    samples = None
    if cfg.calib_mode.lower() == "min_mae":
        from alpha_yolo_quant_tpu.quantize.calibrate import (
            DEFAULT_MIN_MAE_KOEF,
        )

        # the stem conv's koef is fixed, not searched (the reference
        # dumps no batches for conv_p1 and hardcodes 'conv_p1: 3' —
        # calibrate.DEFAULT_MIN_MAE_KOEF), so skip its samples
        taps = [c.tap for c in graph.convs()
                if c.tap and c.tap not in DEFAULT_MIN_MAE_KOEF]
        # resumable: reuse persisted batches/ dumps when present, else
        # capture and persist them (reference utils/save_weights.py:13-21)
        samples = load_batches(args.out, taps)
        if samples is None:
            samples = collect_samples(graph, params,
                                      _calib_batches(args, cfg), taps)
            make_dirs(args.out)
            save_batches(args.out, samples)
            print(f"activation dumps -> {args.out}/batches/")
        else:
            print(f"resumed activation dumps from {args.out}/batches/")
    max_a = reduce_stats(records, cfg.calib_mode, cfg.k, samples)
    make_dirs(args.out)
    write_max_a_all(os.path.join(args.out, "results", "max_a_all.txt"),
                    {k: v for k, v in records.items()
                     if not k.startswith("_")})
    path = os.path.join(args.out, "results", "max_a.txt")
    write_max_a(path, max_a)
    print(f"calibration ({cfg.calib_mode}) -> {path}")


def cmd_quantize(args):
    from alpha_yolo_quant_tpu.data.coco import load_image_square
    from alpha_yolo_quant_tpu.export.artifacts import export_all
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.golden import golden_forward

    cfg = _cfg(args)
    graph, params = _graph_params(args, cfg)
    max_a = _load_max_a(args)
    model = build_quantized_model(graph, params, max_a, cfg)
    if args.image:
        img = load_image_square(args.image, cfg.image_size)[None]
    else:
        img = np.random.default_rng(0).uniform(
            0, 1, (1, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    env = golden_forward(model, img)
    export_all(model, env, params, args.out)
    print(f"quantized artifacts -> {args.out}")


def _dp_step(fn, dp, batch):
    """Wrap a per-batch pipeline as a batch-data-parallel shard_map step
    over the first ``dp`` local devices (parallel.mesh.data_parallel_step
    — params replicate, the batch axis shards over the devices; bitwise
    equal to the unsharded jit, tests/test_parallel.py). ``batch`` is the global
    batch every call will carry; shard_map needs it divisible by dp."""
    import jax

    from alpha_yolo_quant_tpu.parallel.mesh import (
        data_parallel_step, make_mesh,
    )

    n_dev = len(jax.devices())
    if dp > n_dev:
        raise SystemExit(f"--dp {dp}: only {n_dev} devices visible")
    if batch % dp:
        raise SystemExit(f"--dp {dp} must divide the batch size {batch}")
    return data_parallel_step(fn, make_mesh(dp))


def _eval_common(args, step, comment, stage, csv_tag):
    from alpha_yolo_quant_tpu.data.coco import CocoValDataset
    from alpha_yolo_quant_tpu.eval.harness import evaluate
    from alpha_yolo_quant_tpu.eval.plots import plot_run_results
    from alpha_yolo_quant_tpu.eval.records import save_csv_tables
    from alpha_yolo_quant_tpu.export.artifacts import make_dirs
    from alpha_yolo_quant_tpu.utils.run_log import write_run_result

    cfg = _cfg(args)
    ds = CocoValDataset(args.coco_images, args.coco_ann, limit=args.limit)
    res = evaluate(step, ds, args.batch_size, cfg.image_size,
                   progress=True, prefetch=args.prefetch)
    print(f"mAP50-95: {res.map50_95:.4f} over {res.n_images} images "
          f"({res.images_per_s:.1f} img/s device, "
          f"{res.images_per_s_wall:.1f} img/s wall)")
    make_dirs(args.out)
    write_run_result(args.out, res.map50_95, stage, comment)
    # reference reporting contract: per-run det/ann CSV tables + the
    # cross-run mAP plot (stage_3.py:48-49, stage_8_torch.py:1020-1026,
    # utils/plot_run_results.py:29-61)
    ann_p, det_p = save_csv_tables(res.ann_rows, res.det_rows, args.out,
                                   csv_tag)
    print(f"tables -> {ann_p}, {det_p}")
    if stage != 4:
        print(f"run plot -> {plot_run_results(args.out)}")
    return res


def cmd_eval_float(args):
    import jax

    from alpha_yolo_quant_tpu.models.forward import forward_float
    from alpha_yolo_quant_tpu.models.head import decode_float
    from alpha_yolo_quant_tpu.postprocess.nms import (
        NmsParams, non_max_suppression,
    )

    cfg = _cfg(args)
    graph, params = _graph_params(args, cfg)

    def fn(images):
        outs, _ = forward_float(graph, params, images)
        preds = decode_float(outs, params["dfl"]["w"])
        return non_max_suppression(
            preds, NmsParams(conf_thres=args.conf_thres, pre_topk=1000))

    step = (_dp_step(fn, args.dp, args.batch_size) if args.dp
            else jax.jit(fn))
    return _eval_common(args, step, "fp32 BN-fused", 4, "orig")


def cmd_eval_int8(args):
    import jax

    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import (
        build_int_pipeline, eval_nms_params,
    )

    cfg = _cfg(args)
    graph, params = _graph_params(args, cfg)
    max_a = _load_max_a(args)
    model = build_quantized_model(graph, params, max_a, cfg)
    fn, _ = build_int_pipeline(
        model, dfl_w_float=params["dfl"]["w"],
        nms_params=eval_nms_params(model, args.conf_thres),
        engine=args.engine)
    step = (_dp_step(fn, args.dp, args.batch_size) if args.dp
            else jax.jit(fn))
    return _eval_common(args, step,
                        f"int{cfg.k}" + (" full-quant q_NMS"
                                         if cfg.full_quant
                                         else " float NMS"), 7,
                        f"QUANT_{cfg.k}_channel")


def cmd_memsim(args):
    from alpha_yolo_quant_tpu.export.artifacts import make_dirs
    from alpha_yolo_quant_tpu.hwsim.sram import (
        DEFAULT_CELLS, min_buffer_cells, simulate,
    )
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    if args.min_buffer:
        # capacity what-if from the static walk (the reference would
        # re-run its torch forward per candidate; this is milliseconds)
        mc = min_buffer_cells(graph, cfg.image_size)
        peak = simulate(graph, cfg.image_size, 1 << 40).peak_cells
        frag = mc - peak
        print(f"min buffer: {mc} cells ({mc // 8} rows of 8) for "
              f"{cfg.model}@{cfg.image_size} | true peak {peak} cells"
              + (f" (+{frag} first-fit fragmentation)" if frag else
                 " (zero fragmentation: capacity == peak)")
              + f" | reference buffer {DEFAULT_CELLS}: "
              + ("fits" if mc <= DEFAULT_CELLS else "DOES NOT FIT"))
        return 0
    sim = simulate(graph, cfg.image_size)
    make_dirs(args.out)
    sim.write_memory_txt(os.path.join(args.out, "results", "memory.txt"))
    sim.write_final_memory(os.path.join(args.out, "results",
                                        "final_memory.txt"))
    if args.heatmaps:
        from alpha_yolo_quant_tpu.eval.plots import plot_memory_heatmaps

        n = plot_memory_heatmaps(sim, args.out)
        print(f"{n} per-layer heatmaps -> {args.out}/memory/")
    print(f"peak occupancy: {sim.peak_cells} cells "
          f"({sim.peak_rows} rows of 8) -> {args.out}/results/")


def cmd_demo(args):
    import jax.numpy as jnp

    from alpha_yolo_quant_tpu.data.coco import load_image_square
    from alpha_yolo_quant_tpu.eval.plots import plot_detections
    from alpha_yolo_quant_tpu.eval.records import COCO_NAMES
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline

    cfg = _cfg(args)
    graph, params = _graph_params(args, cfg)
    max_a = _load_max_a(args)
    model = build_quantized_model(graph, params, max_a, cfg)
    fn, _ = build_int_pipeline(model, dfl_w_float=params["dfl"]["w"])
    img = load_image_square(args.image, cfg.image_size)[None]
    det, n_det = fn(jnp.asarray(img))
    det = np.asarray(det[0])[: int(n_det[0])]
    print(f"{len(det)} detections")
    for row in det[:20]:
        print(f"  {COCO_NAMES[int(row[5])]:<15} {row[4]:.3f} "
              f"[{row[0]:.1f}, {row[1]:.1f}, {row[2]:.1f}, {row[3]:.1f}]")
    if args.plot:
        plot_detections(img[0], det[:, :4],
                        [COCO_NAMES[int(c)] for c in det[:, 5]],
                        det[:, 4], args.plot)
        print(f"plot -> {args.plot}")


def cmd_info(args):
    """Model/plan summary: layers, channels, taps, scales."""
    from alpha_yolo_quant_tpu.hwsim.sram import simulate
    from alpha_yolo_quant_tpu.models.graph import (
        ConvNode, build_yolov8_graph,
    )

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    convs = graph.convs()
    n_params = sum(c.cout * c.cin * c.kernel * c.kernel + c.cout
                   for c in convs)
    print(f"{cfg.model} K={cfg.k} {cfg.image_size}x{cfg.image_size}  "
          f"{len(convs)} convs, {n_params/1e6:.2f}M params")
    print(f"{'layer':<22}{'key':<20}{'shape':<16}{'k/s/p':<8}"
          f"{'tap':<18}{'out_tap'}")
    for c in convs:
        print(f"{c.name:<22}{c.key:<20}"
              f"{f'{c.cin}->{c.cout}':<16}"
              f"{f'{c.kernel}/{c.stride}/{c.padding}':<8}"
              f"{c.tap or '':<18}{c.out_tap or ''}")
    if args.max_a:
        from alpha_yolo_quant_tpu.utils.io import read_max_a

        max_a = read_max_a(args.max_a)
        print("\ncalibration (tap: a):")
        for name, v in max_a.items():
            print(f"  {name:<20} {v:.6g}")
    sim = simulate(graph, cfg.image_size)
    print(f"\nSRAM plan: peak {sim.peak_cells} cells "
          f"({sim.peak_rows} rows of 8)")


def cmd_serve(args):
    """Batch-coalescing inference service over a list of images: decode
    on a host thread pool, submit each image to serving.BatchCoalescer
    (requests ride ONE compiled max-batch step; timeout flush), emit one
    JSON line per image: {"path", "n", "detections": [[x1,y1,x2,y2,
    conf,cls], ...]}. The replacement for the reference's
    one-image-per-script-run serving story (stage_8_torch.py runs a
    fixed val loop; there is no request path at all)."""
    import concurrent.futures as cf
    import json

    from alpha_yolo_quant_tpu.data.coco import load_image_square
    from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
    from alpha_yolo_quant_tpu.runtime.interpreter import build_int_pipeline
    from alpha_yolo_quant_tpu.serving import BatchCoalescer

    cfg = _cfg(args)
    if args.from_artifacts:
        # production load path: rebuild the runnable model from the
        # exported artifact tree (the reference's stage-8 story —
        # QUANT_WEIGHTS/bias_scales/max_a), bit-identical to the
        # originally built plan (quantize/loadq.py, tests/test_loadq.py)
        from alpha_yolo_quant_tpu.quantize.loadq import (
            dfl_weights_from_artifacts, model_from_artifacts,
        )

        model = model_from_artifacts(args.out, cfg)
        dfl_w = dfl_weights_from_artifacts(args.out)
    else:
        if not args.max_a:
            raise SystemExit("serve: --max-a is required unless "
                             "--from-artifacts is given")
        graph, params = _graph_params(args, cfg)
        max_a = _load_max_a(args)
        model = build_quantized_model(graph, params, max_a, cfg)
        dfl_w = params["dfl"]["w"]
    fn, _ = build_int_pipeline(model, dfl_w_float=dfl_w,
                               engine=args.engine)
    if args.dp:
        # shard each coalesced max-batch step over local devices; the
        # coalescer composes with the shard_map dp step unchanged
        # (tests/test_serving.py::test_coalescer_composes_with_dp_mesh)
        fn = _dp_step(fn, args.dp, args.max_batch)
    src = sys.stdin if args.input_list == "-" else open(args.input_list)
    with src:
        paths = [ln.strip() for ln in src if ln.strip()]
    results = [None] * len(paths)
    errors = [None] * len(paths)
    shape = (3, cfg.image_size, cfg.image_size)
    with BatchCoalescer(fn, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        image_shape=shape) as co:
        def one(i, path):
            # a mid-stream decode (or step) failure must not take the
            # whole serve run down: report per-image, keep serving
            try:
                img = load_image_square(path, cfg.image_size)[None]
                det, n_det = co.submit(img).result()
                return i, det[0][: int(n_det[0])], None
            except Exception as e:
                return i, None, f"{type(e).__name__}: {e}"

        with cf.ThreadPoolExecutor(args.decoders) as pool:
            futs = [pool.submit(one, i, p) for i, p in enumerate(paths)]
            for f in cf.as_completed(futs):
                i, det, err = f.result()
                results[i], errors[i] = det, err
        stats = co.snapshot()
    out = open(args.output, "w") if args.output else sys.stdout
    n_failed = 0
    try:
        for path, det, err in zip(paths, results, errors):
            if err is not None:
                n_failed += 1
                out.write(json.dumps({"path": path, "error": err}) + "\n")
                continue
            out.write(json.dumps({
                "path": path,
                "n": int(len(det)),
                "detections": [[round(float(v), 4) for v in row]
                               for row in det],
            }) + "\n")
    finally:
        if args.output:
            out.close()
    print(f"served {len(paths) - n_failed}/{len(paths)} images"
          + (f" -> {args.output}" if args.output else "")
          + f" | {stats['flushes']} steps, mean fill "
          f"{stats['mean_fill']:.2f}, latency p50/p95 "
          f"{stats['latency_ms_p50']:.1f}/{stats['latency_ms_p95']:.1f} ms"
          + (f" | {n_failed} FAILED" if n_failed else ""),
          file=sys.stderr)
    return 1 if n_failed else 0


def cmd_accept(args):
    """One-command accuracy acceptance (docs/ACCURACY_RUNBOOK.md as
    code): prepare -> gate 1 (fp32 mAP) -> calibrate -> gate 2 (int8,
    float NMS) -> gate 3 (int8 full-quant, q_NMS) -> optional K sweep
    -> report table. Exit nonzero when a gate's mAP50-95 drop vs the
    fp32 baseline exceeds the budget (BASELINE: 0.5).

    The first session with real yolov8n.pt + COCO is this single
    invocation; the flow is rehearsed end-to-end on a synthetic
    checkpoint + synthetic COCO in tests/test_cli.py."""

    if args.dp and args.batch_size % args.dp:
        # fail before the prepare stage does its checkpoint-load work;
        # _dp_step would only catch this at gate 1
        raise SystemExit(f"--dp {args.dp} must divide the batch size "
                         f"{args.batch_size}")

    def run(argv):
        # route through the REAL subparsers so every default/flag has
        # one source of truth (a hand-built Namespace would silently
        # drift when a subcommand grows a new argument)
        ns = build_parser().parse_args(argv)
        return ns.fn(ns)

    base = ["--model", args.model, "--image-size", str(args.image_size)]
    datac = (["--coco-images", args.coco_images,
              "--coco-ann", args.coco_ann,
              "--batch-size", str(args.batch_size)]
             + (["--limit", str(args.limit)]
                if args.limit is not None else []))
    evalc = datac + ["--conf-thres", str(args.conf_thres)] \
        + (["--prefetch"] if args.prefetch else []) \
        + (["--dp", str(args.dp)] if args.dp else [])

    def out_for(k):
        # reference artifact-dir naming: 8_nano / 6_nano / 4_nano
        # (stage_0.py's per-K trees); the primary K uses --out as given
        from alpha_yolo_quant_tpu.config import QuantConfig
        return args.out if k == args.k else os.path.join(
            os.path.dirname(args.out) or ".",
            QuantConfig(model=args.model, k=k).main_dir_name)

    print(f"== accept: prepare ({args.checkpoint or 'random init'}) ==")
    run(["prepare"] + base + ["--k", str(args.k), "--out", args.out]
        + (["--checkpoint", args.checkpoint] if args.checkpoint else []))
    weights = os.path.join(args.out, "results", "weights_batchnf.npz")

    print("== accept: gate 1 — fp32 BN-fused mAP ==")
    g1 = run(["eval-float"] + base
             + ["--k", str(args.k), "--out", args.out,
                "--weights", weights] + evalc)

    rows = []   # (label, res, out_dir)
    ks = [args.k] + [int(s) for s in
                     (args.k_sweep.split(",") if args.k_sweep else [])]
    for k in ks:
        out_k = out_for(k)
        kc = ["--k", str(k), "--out", out_k, "--weights", weights]
        print(f"== accept: calibrate K={k} (mode={args.mode}) ==")
        run(["calibrate"] + base + kc + ["--mode", args.mode] + datac
            + (["--dp", str(args.dp)] if args.dp else []))
        max_a = os.path.join(out_k, "results", "max_a.txt")
        intc = (["eval-int8"] + base + kc
                + ["--max-a", max_a, "--engine", args.engine] + evalc)
        print(f"== accept: gate 2 — int{k}, float NMS ==")
        rows.append((f"int{k} float-NMS", run(intc), out_k))
        print(f"== accept: gate 3 — int{k} full-quant, q_NMS ==")
        rows.append((f"int{k} full-quant",
                     run(intc + ["--full-quant"]), out_k))

    print("\n== acceptance report ==")
    print(f"{'config':<20}{'mAP50-95':>10}{'drop':>8}  verdict")
    print(f"{'fp32 baseline':<20}{g1.map50_95:>10.4f}{0.0:>8.4f}  "
          "(gate 1)")
    failed = []
    for label, res, _ in rows:
        drop = g1.map50_95 - res.map50_95
        ok = drop <= args.drop_budget
        print(f"{label:<20}{res.map50_95:>10.4f}{drop:>8.4f}  "
              f"{'PASS' if ok else 'FAIL'} (budget {args.drop_budget})")
        if not ok:
            failed.append(label)
    if failed:
        print(f"ACCEPT: FAIL ({', '.join(failed)}) — sweep calibration "
              "modes (--mode median | min_mae | n=5) before touching "
              "the quantizer", file=sys.stderr)
        return 1
    print("ACCEPT: PASS")
    return 0


def cmd_bench(args):
    import bench

    batch = (args.batch if args.batch is not None
             else 128 * max(args.dp, 1))
    bench.main(model=args.model, k=args.k, image_size=args.image_size,
               engine=args.engine, batch=batch, iters=args.iters,
               coalesce=args.coalesce, dp=args.dp)


def build_parser():
    from alpha_yolo_quant_tpu.runtime.interpreter import ENGINES

    p = argparse.ArgumentParser(prog="alpha_yolo_quant_tpu",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, weights=True):
        sp.add_argument("--model", default="yolov8n",
                        choices=["yolov8n", "yolov8s", "yolov8m", "yolov8l",
                                 "yolov8x"])
        sp.add_argument("--k", type=int, default=8)
        sp.add_argument("--image-size", type=int, default=640)
        sp.add_argument("--out", default="artifacts/8_nano")
        if weights:
            sp.add_argument("--weights", help="fused params .npz")

    sp = sub.add_parser("prepare", help="load checkpoint + fuse BatchNorm")
    common(sp, weights=False)
    sp.add_argument("--checkpoint", help="torch .pt state dict")
    sp.set_defaults(fn=cmd_prepare)

    sp = sub.add_parser("calibrate", help="activation statistics -> max_a")
    common(sp)
    sp.add_argument("--mode", default="max")
    sp.add_argument("--coco-images")
    sp.add_argument("--coco-ann")
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--dp", type=int, default=0,
                    help="shard calibration batches over N local "
                         "devices (per-image maxima gather back, so "
                         "every --mode reduction is unchanged)")
    sp.set_defaults(fn=cmd_calibrate)

    sp = sub.add_parser("quantize", help="integer transform + full export")
    common(sp)
    sp.add_argument("--max-a", required=True)
    sp.add_argument("--full-quant", action="store_true")
    sp.add_argument("--image", help="golden image (jpg/png)")
    sp.set_defaults(fn=cmd_quantize)

    for name, fn in (("eval-float", cmd_eval_float),
                     ("eval-int8", cmd_eval_int8)):
        sp = sub.add_parser(name, help=f"COCO mAP ({name})")
        common(sp)
        sp.add_argument("--coco-images", required=True)
        sp.add_argument("--coco-ann", required=True)
        sp.add_argument("--limit", type=int, default=None)
        sp.add_argument("--batch-size", type=int, default=16)
        sp.add_argument("--conf-thres", type=float, default=0.001)
        sp.add_argument("--prefetch", action="store_true",
                        help="async host decode + device staging")
        sp.add_argument("--dp", type=int, default=0,
                        help="shard each batch over N local devices "
                             "(shard_map data parallelism; N must "
                             "divide --batch-size)")
        if name == "eval-int8":
            sp.add_argument("--max-a", required=True)
            sp.add_argument("--full-quant", action="store_true")
            sp.add_argument("--engine", default="auto", choices=ENGINES)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("memsim", help="SRAM allocation simulation")
    common(sp, weights=False)
    sp.add_argument("--heatmaps", action="store_true",
                    help="emit per-layer occupancy heatmaps into memory/")
    sp.add_argument("--min-buffer", action="store_true",
                    help="bisect the smallest SRAM capacity that fits "
                         "this model/size instead of simulating at the "
                         "reference capacity")
    sp.set_defaults(fn=cmd_memsim)

    sp = sub.add_parser("demo", help="single-image smoke run")
    common(sp)
    sp.add_argument("--max-a", required=True)
    sp.add_argument("--full-quant", action="store_true")
    sp.add_argument("--image", required=True)
    sp.add_argument("--plot")
    sp.set_defaults(fn=cmd_demo)

    sp = sub.add_parser("info", help="model/plan summary")
    common(sp, weights=False)
    sp.add_argument("--max-a")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("serve",
                        help="batch-coalescing inference over an image "
                             "list (JSONL detections out)")
    common(sp)
    sp.add_argument("--max-a")
    sp.add_argument("--from-artifacts", action="store_true",
                    help="load the quantized model from --out's exported "
                         "artifact tree (the stage-8 production load) "
                         "instead of --weights/--max-a")
    sp.add_argument("--full-quant", action="store_true")
    sp.add_argument("--engine", default="auto", choices=ENGINES)
    sp.add_argument("--input-list", required=True,
                    help="file of image paths, one per line ('-' = stdin)")
    sp.add_argument("--output", help="JSONL out (default stdout)")
    sp.add_argument("--max-batch", type=int, default=128)
    sp.add_argument("--max-wait-ms", type=float, default=5.0)
    sp.add_argument("--decoders", type=int, default=8,
                    help="host image-decode threads feeding the batcher")
    sp.add_argument("--dp", type=int, default=0,
                    help="shard each coalesced step over N local "
                         "devices (must divide --max-batch)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("accept",
                        help="one-command accuracy acceptance: prepare "
                             "-> fp32 gate -> calibrate -> int gates "
                             "-> K sweep -> report")
    common(sp, weights=False)
    sp.add_argument("--checkpoint", help="torch .pt state dict "
                    "(an ultralytics yolov8{n,s,m,l,x}.pt matching "
                    "--model)")
    sp.add_argument("--coco-images", required=True)
    sp.add_argument("--coco-ann", required=True)
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--conf-thres", type=float, default=1e-8,
                    help="mAP protocol threshold (runbook default)")
    sp.add_argument("--prefetch", action="store_true")
    sp.add_argument("--mode", default="max",
                    help="calibration reduction (stage_5 lever)")
    sp.add_argument("--engine", default="auto", choices=ENGINES)
    sp.add_argument("--k-sweep", default="",
                    help="extra bit widths, e.g. '6,4' (each gets its "
                         "own artifact dir + gates)")
    sp.add_argument("--drop-budget", type=float, default=0.5,
                    help="max allowed mAP50-95 drop vs fp32 (BASELINE)")
    sp.add_argument("--dp", type=int, default=0,
                    help="shard every gate's batches over N local "
                         "devices (forwarded to calibrate, eval-float "
                         "and eval-int8)")
    sp.set_defaults(fn=cmd_accept)

    sp = sub.add_parser("bench", help="chip throughput (single or --dp)")
    common(sp, weights=False)
    sp.add_argument("--engine", default="auto", choices=ENGINES)
    sp.add_argument("--batch", type=int, default=None,
                    help="GLOBAL batch (default 128 per device)")
    sp.add_argument("--iters", type=int, default=10)
    sp.add_argument("--dp", type=int, default=0,
                    help="slope-timed run under the shard_map "
                         "data-parallel step over N local devices")
    sp.add_argument("--coalesce", type=int, default=0,
                    help="N coalesced requests of --batch images each")
    sp.set_defaults(fn=cmd_bench)

    return p


def main(argv=None):
    from alpha_yolo_quant_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    args = build_parser().parse_args(argv)
    ret = args.fn(args)
    # subcommands may return rich objects (cmd_eval_* return EvalResult
    # for cmd_accept's direct calls); only int returns are exit codes —
    # anything else is success (sys.exit(EvalResult) would exit 1).
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
