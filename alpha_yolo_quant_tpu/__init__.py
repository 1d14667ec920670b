"""alpha_yolo_quant_tpu — JAX post-training-quantization framework for YOLOv8.

A from-scratch JAX/XLA re-design of the staged PTQ pipeline in
Alpha-Chip/Alpha-Yolo-Quant (reference mounted read-only at /root/reference):
BatchNorm fusion, max-abs activation calibration, int-K (4/6/8-bit) weight
quantization with per-output-channel scales, hardware rescale/shift
requantization, LUT SiLU/sigmoid/exponent nonlinearities, integer NMS, and
Verilog-contract export — all organised around a single declarative graph IR
instead of the reference's six hand-copied model definitions
(reference: quantisation/stage_1..8, see SURVEY.md).

Layering (bottom-up):
  ops/        integer-exact primitives (int32 emulated widening math, exact
              integer convolution, LUT construction)
  models/     the YOLOv8 graph IR + float forward + checkpoint loading/BN fusion
  quantize/   calibration (taps), statistics reduction, the scale plan, and the
              graph->integer transform (host-side, numpy float64/int64,
              bit-exact with the reference contract)
  runtime/    jitted integer inference (pure-jnp interpreter) + int64 oracle
  postprocess/ anchors, DFL decode, float NMS and integer q_NMS
  eval/       COCO mAP harness
  export/     Verilog text + gzip pickle artifact writers (byte-compatible)
  hwsim/      on-chip SRAM allocation simulator
  parallel/   mesh construction + shard_map data-parallel eval/serving
"""

__version__ = "0.1.0"
