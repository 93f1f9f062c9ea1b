"""Host-side gateway ingest throughput (the fused native codec path).

Streams a full multi-sensor acquisition epoch through the simulator +
loopback transport + gateway state machine with the device analysis stage
stubbed, isolating the host packet path: dispatch, sequence validation,
fused native decode+format+append (csrc/apda_io.cc), history logging.
One JSON line; gate = native library available AND >= MIN_SAMPLES_PER_SEC
(measured on this host: pure Python ~0.14 Msamp/s, fused native with
per-packet fopen/fclose ~0.95, kept-fd fused ingest ~2.15 - the floor
sits between the last two so losing EITHER the native codec or the fd
cache fails the gate).
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

MIN_SAMPLES_PER_SEC = 1_200_000.0


def run_ingest(n_sensors: int = 32, n_samples: int = 4096,
               rounds: int = 3) -> dict:
    from pathlib import Path

    from apda_fft_tpu.gateway.transport import SensorSimulator
    from apda_fft_tpu.io import native
    from tests.test_gateway import make_service

    tmp = Path(tempfile.mkdtemp(prefix="ingest_bench_"))
    svc, transport, _, _ = make_service(tmp)
    svc._analyze_files = lambda *a, **k: None  # host path only
    rng = np.random.default_rng(0)
    recs = [rng.standard_normal(n_samples).astype(np.float32)
            for _ in range(n_sensors)]
    sims = [SensorSimulator(f"0013a20041e7f{i:03x}", fs=125.0, axis="X",
                            chunk=100) for i in range(n_sensors)]
    sims[0].stream_acquisition(transport, recs[0])
    svc.drain()  # warm

    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for sim, rec in zip(sims, recs):
            sim.stream_acquisition(transport, rec)
        svc.drain()
        best = min(best, time.perf_counter() - t0)
    total = n_sensors * n_samples
    sps = total / best
    return {
        "metric": "gateway_ingest_host",
        "sensors": n_sensors,
        "samples_per_record": n_samples,
        "wall_s_best": round(best, 4),
        "samples_per_sec": round(sps, 1),
        "native_codec": native.available(),
        "ok": bool(native.available() and sps >= MIN_SAMPLES_PER_SEC),
    }


if __name__ == "__main__":
    out = run_ingest()
    print(json.dumps(out))
    sys.exit(0 if out["ok"] else 1)
