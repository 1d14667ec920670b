"""Mesh construction and sharded step builders.

Design: pick a mesh, annotate shardings with NamedSharding, let XLA insert
the collectives. For this model family the batch axis ("dp") shards over
the devices; params are replicated (3M params — replicating is cheaper than
any gather). Multi-host runs call
``jax.distributed.initialize`` before building the mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-host (DCN) initialization: call once per host before building
    the mesh. With no arguments, jax.distributed auto-detects the cluster
    environment where it can (e.g. SLURM); elsewhere pass the coordinator
    address, process count and process id."""
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested a {n_devices}-device mesh but "
                             f"only {len(devices)} devices are visible")
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (axis,), devices=devices)


def make_mesh_2d(dp: int, tp: int, axes=("dp", "tp")) -> Mesh:
    """(dp, tp) mesh: batch over 'dp', model (output channels) over 'tp'.

    At YOLOv8n scale tensor parallelism is never a win (3M params — see
    SURVEY.md §2.9), but the sharding seam exists so larger variants can
    shard: conv weights partition on C_out, XLA inserts the gathers.
    ``axes`` names the two mesh axes (e.g. ("dp", "sp") for the combined
    throughput+latency mesh of ``dp_sp_parallel_fn``)."""
    devices = jax.devices()[: dp * tp]
    return jax.make_mesh(
        (dp, tp), tuple(axes),
        axis_types=(jax.sharding.AxisType.Auto,) * 2, devices=devices)


def shard_params_tp(mesh: Mesh, params, axis: str = "tp"):
    """Place fused conv params with C_out sharded over `axis` (weights
    (O,I,kh,kw) and biases (O,) partition on dim 0); DFL stays replicated."""
    out = {}
    for key, p in params.items():
        if key == "dfl":
            out[key] = jax.device_put(p, NamedSharding(mesh, P()))
            continue
        out[key] = {
            "w": jax.device_put(p["w"], NamedSharding(mesh, P(axis))),
            "b": jax.device_put(p["b"], NamedSharding(mesh, P(axis))),
        }
    return out


def shard_batch(mesh: Mesh, x, axis: str = "dp"):
    """Place a host array batch-sharded over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(mesh: Mesh, tree):
    """Replicate a parameter pytree across the mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def data_parallel_step(fn, mesh: Mesh, axis: str = "dp"):
    """Wrap a per-batch function as a batch-data-parallel SPMD step via
    shard_map: each device runs fn on its local batch shard; outputs stay
    batch-sharded. This sidesteps global-sharding propagation through
    control flow (NMS while_loops) and is the serving-path pattern.

    fn sees the PER-DEVICE batch (global/n_devices)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec

    p = PartitionSpec(axis)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(p,), out_specs=p))


def spatial_parallel_fn(fn, mesh: Mesh, axis: str = "sp"):
    """Latency-mode sharding: partition the image HEIGHT across the mesh
    and let GSPMD insert the conv halo exchanges.

    The complement of ``data_parallel_step``: dp scales throughput with
    batch, sp divides the single-image wall clock when the batch is too
    small to fill the mesh (the serve-latency regime, where a lone image
    leaves most of the device idle).
    Numerics are unchanged: height partitioning splits no reduction —
    each device computes its output rows from its rows plus a halo of
    the neighbor's, so results are bitwise identical to the jitted
    unsharded run (tested; comparing against an EAGER run instead shows
    last-ulp diffs in the float box decode from jit FMA contraction).

    Constraint on this toolchain: the shard count must divide the
    deepest feature-map height, i.e. ``image_size/32`` (640 -> sp in
    {2, 4}; 20 rows). Uneven shards make XLA's SPMD partitioner emit a
    type-mismatched halo-padding constant for non-f32 convs and crash
    in the HLO verifier.

    Build ``fn`` with ``with_nms=False`` (head edges / preds): the NMS
    scan is sequential bookkeeping over (B, anchors) rows and belongs on
    one device — GSPMD propagation through it adds no parallelism, only
    reshards. Run NMS on the gathered preds afterwards: the output is
    pinned replicated (out_shardings=P()) so the gather happens at this
    jit seam, not silently on whatever sharding GSPMD would pick for
    downstream consumers (ADVICE r3).
    """
    spec = NamedSharding(mesh, P(None, None, axis, None))
    return jax.jit(fn, in_shardings=(spec,),
                   out_shardings=NamedSharding(mesh, P()))


def dp_sp_parallel_fn(fn, mesh: Mesh, dp_axis: str = "dp",
                      sp_axis: str = "sp"):
    """Combined throughput+latency sharding on a 2-D (dp, sp) mesh: the
    batch is sharded over ``dp_axis`` AND every image's height over
    ``sp_axis`` (GSPMD inserts the conv halo exchanges within each sp
    group, exactly as in ``spatial_parallel_fn``). The regime between
    pure dp (big batches) and pure sp (a lone image): a handful of
    concurrent requests, each of which should still finish faster than a
    single chip allows.

    Composition matters for bitwise parity: ``dp_axis`` is made MANUAL
    via shard_map and only ``sp_axis`` is left to GSPMD. Handing the
    partitioner the whole 2-D mesh through plain jit shardings instead
    lets it spend the idle dp axis on its own strategies — on this
    toolchain it splits conv contractions across dp, whose partial-sum
    rounding breaks the exact-int engines (sp-only on a 2-D mesh
    diverged on the full-quant preds while the identical sp sharding on
    a 1-D mesh is bitwise).
    With dp manual, each dp group reproduces the proven-bitwise pure-sp
    regime, so results equal the jitted unsharded run bit-for-bit
    (tested: tests/test_parallel.py::test_dp_sp_combined_mesh_matches_local).

    The same even-divisibility constraint as ``spatial_parallel_fn``
    applies to the sp extent. Build ``fn`` with ``with_nms=False``;
    outputs come back batch-sharded over ``dp_axis`` (the sp axis is
    gathered inside the seam)."""
    from jax import shard_map

    def body(x):
        # manual over dp (x is the local batch shard), auto over sp:
        # pin the height sharding so GSPMD partitions the body over sp
        # exactly as in spatial_parallel_fn, then gather before leaving
        x = jax.lax.with_sharding_constraint(
            x, P(None, None, sp_axis, None))
        return jax.lax.with_sharding_constraint(fn(x), P())

    mapped = shard_map(body, mesh=mesh, in_specs=(P(dp_axis),),
                       out_specs=P(dp_axis), axis_names={dp_axis})
    return jax.jit(
        mapped,
        in_shardings=(NamedSharding(mesh, P(dp_axis, None, sp_axis,
                                            None)),))


def sharded_forward_fn(graph, mesh: Mesh, decode: bool = True,
                       collect_taps: bool = False, axis: str = "dp"):
    """Build a jitted batch-data-parallel forward (+decode) step.

    Inputs are batch-sharded, params replicated; with collect_taps the
    per-image tap maxima are reduced to global per-layer maxima (XLA inserts
    the cross-device all-reduce max).
    """
    from alpha_yolo_quant_tpu.models.forward import forward_float
    from alpha_yolo_quant_tpu.models.head import decode_float

    in_shardings = (NamedSharding(mesh, P()), NamedSharding(mesh, P(axis)))

    @jax.jit
    def step(params, images):
        outs, taps = forward_float(graph, params, images,
                                   collect_taps=collect_taps)
        res: Dict = {}
        if decode:
            res["preds"] = decode_float(outs, params["dfl"]["w"])
        else:
            res["outputs"] = outs
        if collect_taps:
            res["taps"] = {k: jnp.max(v) for k, v in taps.items()}
        return res

    return jax.jit(step, in_shardings=in_shardings)
