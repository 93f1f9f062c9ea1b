"""Profiling helpers: per-epoch metrics and JAX device traces.

The reference self-profiles every FFT run with process/wall time, %CPU and
peak RSS (``GT_FFT_v5.py:623-624,663-676``) and prints them into history.log
at the next sync.  :class:`EpochMetrics` keeps that exact metric shape;
:func:`trace` adds what the reference could not have - a real device profiler
(TensorBoard-viewable XPlane capture via ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import resource
import time

import jax


class EpochMetrics:
    """Capture process/wall/%CPU/RSS around a device computation.

    ``history`` is bounded (a deque): a run_forever gateway measures every
    epoch for months, so an unbounded list would be a slow memory leak.
    """

    def __init__(self, history_len: int = 256):
        import collections

        self.last: dict[str, float] = {}
        self.history: "collections.deque[dict[str, float]]" = collections.deque(
            maxlen=history_len
        )

    @contextlib.contextmanager
    def measure(self):
        cpu0 = time.process_time()
        wall0 = time.perf_counter()
        try:
            yield self
        finally:
            wall = time.perf_counter() - wall0
            cpu = time.process_time() - cpu0
            self.last = {
                "process_time": cpu,
                "wall_time": wall,
                "percentage_cpu": (cpu / wall * 100.0) if wall > 0 else 0.0,
                "memrss": float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss),
            }
            self.history.append(self.last)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX profiler trace (open with TensorBoard's profile plugin)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compiled_stats(fn, *args, **kwargs) -> dict:
    """Compile ``fn`` and report XLA's cost analysis (FLOPs, bytes accessed)."""
    compiled = jax.jit(fn).lower(*args, **kwargs).compile()
    analysis = compiled.cost_analysis()
    return {
        "flops": analysis.get("flops", -1.0),
        "bytes_accessed": analysis.get("bytes accessed", -1.0),
        "memory_mb": compiled.memory_analysis().temp_size_in_bytes / 1e6
        if hasattr(compiled.memory_analysis(), "temp_size_in_bytes")
        else -1.0,
    }
