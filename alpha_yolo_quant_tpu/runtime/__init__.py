"""Quantized inference runtimes: the pure-jnp int32 interpreter (bit-exact,
runs on CPU and GPU) and the numpy int64 golden runtime (host oracle, the
stage-6 analog)."""
