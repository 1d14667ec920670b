"""Tracing & profiling utilities.

The reference's only instrumentation is wall-clock prints and tqdm
(SURVEY.md §5.1); here: jax.profiler trace capture, per-stage timers, and
the per-layer tensor-dump debug mode (int_forward keep_env + export)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{name:<28} {self.totals[name]*1e3:9.1f} ms "
                 f"(x{self.counts[name]})"
                 for name in sorted(self.totals,
                                    key=lambda n: -self.totals[n])]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace context (view with xprof/tensorboard); no-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def bench_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Time a jitted device function; returns ms per call.

    Coarse wall-clock/iters. For end-to-end numbers use bench.py, which
    times two iteration counts of a loop whose carry consumes every
    output leaf."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3
