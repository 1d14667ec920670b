"""Quantization transforms: calibration, statistics reduction, scale planning,
and the float->integer graph transform. Host-side (numpy float64/int64) so the
derived plan is bit-exact with the reference contract; the resulting integer
artifacts are executed on the device by alpha_yolo_quant_tpu.runtime."""
