"""On-device oracle parity: peak decisions vs the float64 oracle.

Bugs that only the device shows (round 1's budget truncation passed every
CPU test) make this the gate that runs before any benchmark.  It drives the
production pipeline (dynamic candidate budget, matmul backend, float32) on
the device JAX finds over the same randomized modal-signal corpus as
``tests/test_peaks_match.py``, in both detector modes, and compares peak
decisions (indices + counts) against the float64 reference oracle
(``tests/oracle.py``, a clean-room restatement of
``utils/get_peak_prominence.py:149-226`` / ``get_peak_resolution.py:80-128``).

Prints ONE JSON line:
  {"metric": "oracle_parity", "pass": N, "fail": M, "total": T,
   "ok": bool, "device": {...}}

Exit status 0 iff every case matches.
"""

from __future__ import annotations

import json
import os
import sys

# Make the repo root importable regardless of invocation cwd
# (python benchmarks/parity.py puts benchmarks/ first on sys.path).
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def run_corpus() -> dict:
    import numpy as np

    from tests.oracle import oracle_analyze
    from tests.signals import modal_signal
    # Reuse the CPU suite's corpus AND its device-dispatch helper so this
    # gate can never silently diverge from the tests it mirrors.
    from tests.test_peaks_match import CORPUS, _run_device

    import jax.numpy as jnp

    failures = []
    total = 0
    for mode in ("flexible", "rigid"):
        for n, fs, seed in CORPUS:
            total += 1
            x = modal_signal(n, fs, seed=seed)
            ref = oracle_analyze(x, fs, mode=mode)
            res, _n_fft = _run_device(x, fs, mode, jnp.float32)
            got_count = int(res.count[0])
            got_idx = [int(i) for i in np.asarray(res.idx[0])[:got_count]]
            ref_idx = [p["idx"] for p in ref]
            if got_idx != ref_idx:
                failures.append(
                    {"mode": mode, "n": n, "fs": fs, "seed": seed,
                     "got": got_idx, "want": ref_idx}
                )

    return {
        "metric": "oracle_parity",
        "pass": total - len(failures),
        "fail": len(failures),
        "total": total,
        "ok": not failures,
        **({"failures": failures} if failures else {}),
    }


def main() -> None:
    from apda_fft_tpu.utils.benchtime import device_info

    report = {**run_corpus(), "device": device_info()}
    print(json.dumps(report))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
