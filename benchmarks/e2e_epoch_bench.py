"""End-to-end epoch latency: packets in -> analysis decisions stored.

The full gateway pipeline - simulator packets through the loopback
transport, dispatch, sequence validation, fused native decode+format+append,
epoch-batched device analysis, result storage - measured twice:

* ``analysis_feed="memory"``: the in-memory record feeds the pipeline
  directly (the log file is written but never re-parsed) - the default.
* ``analysis_feed="file"``: the reference's write-then-re-parse round-trip
  (``GT_FFT_v5.py:627`` -> ``utils/load_data.py:29-82``), kept as the
  parity mode.

One JSON line with both numbers and their ratio.  Gate: memory feed >=
MIN_SPEEDUP x the file feed on the re-parse-excluded host budget - i.e. the
round-trip the verdict flagged as "redundant by construction" is actually
gone from the hot path (decisions parity is tests/test_memfeed.py's job).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

#: memory feed must beat the file feed end-to-end by at least this factor.
#: Measured 1.15-1.25x at N=4096 on this host AFTER the kept-fd ingest
#: landed (the fd cache sped BOTH feeds' appends, compressing the ratio;
#: pre-fd it was ~1.2-1.5x): the gate sits below the measured band so
#: scheduling noise cannot flake it, while reintroducing the re-parse on
#: the hot path still fails it together with the absolute floor below.
MIN_SPEEDUP = 1.05
#: absolute end-to-end floor for the memory feed on this host (packets in
#: -> decisions stored, analysis included; measured ~1.5-1.6 Msamp/s).
MIN_MEM_SAMPLES_PER_SEC = 1_000_000.0


def _run_feed(feed: str, n_sensors: int, n_samples: int, rounds: int) -> dict:
    from pathlib import Path

    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    tmp = Path(tempfile.mkdtemp(prefix=f"e2e_epoch_{feed}_"))
    svc, transport, _, _ = make_service(
        tmp, flush_mode="on_sync", gateway_extra={"analysis_feed": feed})
    rng = np.random.default_rng(0)
    fs = 125.0
    t = np.arange(n_samples) / fs
    recs = [(np.sin(2 * np.pi * 12.3 * t)
             + 0.5 * np.sin(2 * np.pi * 31.4 * t)
             + 0.3 * rng.standard_normal(n_samples)).astype(np.float32)
            for _ in range(n_sensors)]
    sims = [SensorSimulator(f"0013a20041e7f{i:03x}", fs=fs, axis="X",
                            chunk=100) for i in range(n_sensors)]

    def one_epoch() -> float:
        t0 = time.perf_counter()
        for sim, rec in zip(sims, recs):
            sim.stream_acquisition(transport, rec)
        svc.drain()
        sims[0].heartbeat(transport)  # closes the epoch batch (on_sync)
        svc.drain()
        dt = time.perf_counter() - t0
        for sim in sims[1:]:
            sim.heartbeat(transport)
        svc.drain()
        return dt

    one_epoch()  # warm: XLA compile + native lib load
    best = min(one_epoch() for _ in range(rounds))
    analyzed = sum(
        1 for _ in svc.trackers)  # sanity: analysis actually ran
    return {
        "wall_s_best": round(best, 4),
        "samples_per_sec": round(n_sensors * n_samples / best, 1),
        "windows_per_sec": round(n_sensors / best, 2),
        "tracked": analyzed,
    }


def run_e2e(n_sensors: int = 32, n_samples: int = 4096,
            rounds: int = 5) -> dict:
    from apda_fft_tpu.io import native

    mem = _run_feed("memory", n_sensors, n_samples, rounds)
    fil = _run_feed("file", n_sensors, n_samples, rounds)
    speedup = fil["wall_s_best"] / mem["wall_s_best"]
    return {
        "metric": "gateway_e2e_epoch",
        "sensors": n_sensors,
        "samples_per_record": n_samples,
        "memory_feed": mem,
        "file_feed": fil,
        "speedup_memory_vs_file": round(speedup, 3),
        "native_codec": native.available(),
        "ok": bool(
            native.available()
            and mem["tracked"] > 0 and fil["tracked"] > 0
            and speedup >= MIN_SPEEDUP
            and mem["samples_per_sec"] >= MIN_MEM_SAMPLES_PER_SEC
        ),
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sensors", type=int, default=32)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--platform", default="",
                    help="jax platform to pin (e.g. 'cpu'); default: the "
                         "device JAX finds")
    ap.add_argument("--out", default="", help="also write the result here")
    args = ap.parse_args()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from apda_fft_tpu.utils.benchtime import device_info

    out = run_e2e(args.sensors, args.samples, args.rounds)
    out["device"] = device_info()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    sys.exit(0 if out["ok"] else 1)
