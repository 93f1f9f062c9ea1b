"""The five BASELINE.json benchmark configs, each as one JSON line.

Run on the accelerator:  python benchmarks/run_all.py [--backend xla|matmul]

Baselines are the reference numerical core's measured single-CPU-core
throughputs (BASELINE.md); ``vs_baseline`` is this framework's speedup.
Every config times the production call, ``analyze_epoch`` with its dynamic
candidate budget (one readback per epoch included), as the median of
``block_until_ready`` wall times after warm-up.  cfg1 and cfg2 are single
windows: their headline is the B=1 latency (``latency_ms``) of that same
batched program.  Config 5 (N=65536) is benchmarked at batch 64 and reports
its B=1 latency in ``single_window``.  Each line carries ``device``: the
platform, device kind and count, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# Make the repo root importable regardless of invocation cwd
# (python benchmarks/run_all.py puts benchmarks/ first on sys.path).
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# windows/s of the reference core at each config's N (BASELINE.md).
REFERENCE_WPS = {1024: 478.0, 4096: 103.0, 8192: 48.0, 65536: 4.8}
FS = 500.0


def _signal(n, channels=1, seed=42):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    base = np.sin(2 * np.pi * 12.3 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t) + 0.1
    return (base[None, :] + 0.05 * rng.standard_normal((channels, n))).astype(np.float32)


def run_config(num: int, backend: str) -> dict:
    import jax.numpy as jnp

    from apda_fft_tpu.models.pipeline import analyze_epoch
    from apda_fft_tpu.models.streaming import frame_records
    from apda_fft_tpu.utils.benchtime import device_info, median_seconds

    def production(x, fs, mode, n, refine=False, framed=False):
        def call():
            s = frame_records(x, n, n) if framed else x
            return analyze_epoch(s, fs, n_fft=n, mode=mode, backend=backend,
                                 refine=refine)
        return call

    single_window = None
    if num == 1:  # single-channel N=1024, rigid-mode peak pick
        n, b = 1024, 1
        fn = production(jnp.asarray(_signal(n)), jnp.full((b,), FS, jnp.float32),
                        "rigid", n)
        name = "cfg1_single_n1024_rigid"
    elif num == 2:  # single-channel N=4096 flexible + sub-bin refinement
        n, b = 4096, 1
        fn = production(jnp.asarray(_signal(n)), jnp.full((b,), FS, jnp.float32),
                        "flexible", n, refine=True)
        name = "cfg2_single_n4096_flexible_refined"
    elif num == 3:  # 8-sensor batch N=4096
        n, b = 4096, 8
        fn = production(jnp.asarray(_signal(n, channels=b)),
                        jnp.full((b,), FS, jnp.float32), "flexible", n)
        name = "cfg3_batch8_n4096_flexible"
    elif num == 4:  # 64ch x 16win streaming epoch, N=8192, fused framing
        n, c, wn = 8192, 64, 16
        b = c * wn
        fn = production(jnp.asarray(_signal(n * wn, channels=c)),
                        jnp.full((c, wn), FS, jnp.float32), "flexible", n,
                        framed=True)
        name = "cfg4_stream_64x16_n8192_fused"
    elif num == 5:  # long-record N=65536 multi-peak + sub-bin interpolation
        n, b = 65536, 64
        fn = production(jnp.asarray(_signal(n, channels=b)),
                        jnp.full((b,), FS, jnp.float32), "flexible", n, refine=True)
        one = production(jnp.asarray(_signal(n)), jnp.full((1,), FS, jnp.float32),
                         "flexible", n, refine=True)
        single_window = {"latency_ms": round(median_seconds(one) * 1e3, 4)}
        name = "cfg5_long_n65536_b64_refined"
    else:
        raise ValueError(num)

    sec = median_seconds(fn)
    wps = b / sec
    out = {
        "metric": name + f"[{backend}]",
        "value": round(wps, 1),
        "unit": "windows/s",
        "vs_baseline": round(wps / REFERENCE_WPS[n], 2),
        "latency_ms": round(sec * 1e3, 4),
    }
    if single_window:
        out["single_window"] = single_window
    out["device"] = device_info()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="matmul")
    ap.add_argument("--configs", default="1,2,3,4,5")
    args = ap.parse_args()

    from apda_fft_tpu.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    failures = 0
    for num in (int(c) for c in args.configs.split(",")):
        try:
            print(json.dumps(run_config(num, args.backend)), flush=True)
        except Exception as exc:  # noqa: BLE001
            failures += 1
            print(f"# config {num} failed: {exc}", file=sys.stderr, flush=True)
    if failures:
        # Missing BASELINE lines must not read as a clean round to automation.
        raise SystemExit(1)


if __name__ == "__main__":
    main()
