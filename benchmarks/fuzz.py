"""On-device end-to-end randomized fuzz: the whole f32 pipeline vs the oracle.

Complements benchmarks/parity.py (fixed corpus) with randomized windows
across sizes, rates, modes, and signal kinds - modal, scaled/offset white
noise, multi-sine.  Each window runs through ``analyze_epoch`` twice: alone
(B=1, the sticky budget cleared so its first-epoch sizing and overflow
re-run execute) and as one row of a batch with other windows (another
budget, possibly the two-tier split).  Two scores are printed:

- single_vs_batched: decision agreement between the two - must be N/N;
- vs_oracle: agreement with the float64 oracle - expected N/N on modal
  signals; adversarial noise windows may hit characterized precision
  boundaries (docs/DESIGN.md "End-to-end randomized fuzz"), reported but
  not counted as failures.

Prints ONE JSON line; exit 0 iff single_vs_batched is perfect.
"""

from __future__ import annotations

import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

N_CASES = int(os.environ.get("APDA_FUZZ_CASES", "150"))


def run_fuzz(n_cases: int = N_CASES, modes: tuple = ("rigid", "flexible")) -> dict:
    import numpy as np

    from apda_fft_tpu.models.pipeline import _dynamic_budget, analyze_epoch
    from tests.oracle import oracle_analyze
    from tests.signals import modal_signal

    rng = np.random.default_rng(2024)
    sizes = [256, 512, 1024, 2048, 4096, 8192, 16384]
    fss = [62.5, 125.0, 250.0, 500.0, 1000.0]
    mismatches = []      # single vs batched - the hard contract
    oracle_misses = []   # f32 vs f64 - expected only on noise boundaries
    grown = 0
    for case in range(n_cases):
        n = sizes[case % len(sizes)]
        fs = fss[rng.integers(0, len(fss))]
        mode = modes[case % len(modes)]
        kind = case % 3
        if kind == 0:
            x = modal_signal(n, fs, seed=int(rng.integers(0, 10000)))
        elif kind == 1:
            x = rng.standard_normal(n) * rng.uniform(0.01, 5.0) + rng.uniform(-3, 3)
        else:
            t = np.arange(n) / fs
            x = sum(
                rng.uniform(0.1, 2.0)
                * np.sin(2 * np.pi * rng.uniform(0.01, 0.45) * fs * t)
                for _ in range(int(rng.integers(1, 6)))
            )
            x = np.asarray(x) + 0.2 * rng.standard_normal(n)
        x = x.astype(np.float32)

        _dynamic_budget.pop((n, mode), None)
        single = analyze_epoch(x[None], fs, n_fft=n, mode=mode)
        if _dynamic_budget.get((n, mode), 0) > 2:
            grown += 1  # the first-epoch budget overflowed and re-ran
        batch = np.stack([x, rng.standard_normal(n).astype(np.float32), x[::-1]])
        hi = analyze_epoch(batch, fs, n_fft=n, mode=mode)
        hi_idx = [int(i) for i in np.asarray(hi.idx[0])[: int(hi.count[0])]]
        single_idx = [int(i) for i in np.asarray(single.idx[0])[: int(single.count[0])]]
        rec = {"case": case, "n": n, "fs": fs, "mode": mode, "kind": kind}
        if single_idx != hi_idx:
            mismatches.append({**rec, "single": single_idx, "batched": hi_idx})
        ref_idx = [p["idx"] for p in oracle_analyze(x, fs, mode=mode)]
        if hi_idx != ref_idx:
            oracle_misses.append({**rec, "got": hi_idx, "want": ref_idx})

    return {
        "metric": "e2e_fuzz",
        "modes": list(modes),
        "cases": n_cases,
        "single_vs_batched": f"{n_cases - len(mismatches)}/{n_cases}",
        "vs_oracle": f"{n_cases - len(oracle_misses)}/{n_cases}",
        "budget_grown": grown,
        "ok": not mismatches,
        **({"mismatches": mismatches} if mismatches else {}),
        **({"oracle_misses": oracle_misses[:5]} if oracle_misses else {}),
    }


def main() -> None:
    from apda_fft_tpu.utils.benchtime import device_info

    report = {**run_fuzz(), "device": device_info()}
    print(json.dumps(report))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
