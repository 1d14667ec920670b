"""Device-mesh parallelism: batch data-parallel calibration/eval/serving over
the devices via jax.sharding + jit. (The reference has no distributed code at all —
SURVEY.md §2.9; at YOLOv8n scale data parallelism is the honest sharding, and
the seam for model sharding lives in these APIs.)"""
