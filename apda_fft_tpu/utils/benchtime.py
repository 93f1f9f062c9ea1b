"""Wall-clock timing of device work, and the identity of the device timed.

JAX dispatch is asynchronous, so every timing here brackets a call that
ends in ``jax.block_until_ready`` on the host clock, after warm-up calls
that compile it.  Every number a benchmark prints carries
:func:`device_info`: the platform, device kind and count JAX reports and,
on an NVIDIA card, the name and power limit ``nvidia-smi`` reads (a card
set below its maximum power runs slower under load, so a time without the
limit beside it cannot be compared).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import jax


def wall_seconds(fn, *args, warmup: int = 2, reps: int = 10) -> list[float]:
    """Host-clock seconds of ``reps`` calls of ``fn(*args)``, each waited on.

    ``warmup`` untimed calls come first, so compilation and the dynamic
    candidate budget's first-epoch sizing stay out of the timed calls.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def median_seconds(fn, *args, warmup: int = 2, reps: int = 10) -> float:
    """Median of :func:`wall_seconds` - the steady-state time of one call."""
    return statistics.median(wall_seconds(fn, *args, warmup=warmup, reps=reps))


def nvidia_smi() -> str | None:
    """``name, power.limit`` of each NVIDIA card (one line per card), or
    None where ``nvidia-smi`` is absent or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def device_info() -> dict:
    """The device a measurement ran on, as JAX and ``nvidia-smi`` see it."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": nvidia_smi(),
    }
