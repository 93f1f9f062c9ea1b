"""Hardware fuzz for the SSI-COV stage split: f32 device correlations vs
a float64 numpy correlation oracle, both pushed through the IDENTICAL host
identification, plus planted-truth recovery per case.

A case passes iff the device-path mode set matches the oracle's (equal
count, frequency within 0.2%, damping within 5% relative, shape MAC >
0.999) AND every planted mode is recovered within 1% frequency.

Usage: python benchmarks/ssi_fuzz.py [n_cases]    (exit 0 iff all pass)
Also callable as run_ssi_fuzz(n).
"""

from __future__ import annotations

import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np

from apda_fft_tpu.utils.synthetic import modal_records


def _corr_oracle(x: np.ndarray, n_lags: int) -> np.ndarray:
    xm = x.astype(np.float64)
    xm -= xm.mean(-1, keepdims=True)
    t0 = x.shape[1] - n_lags + 1
    return np.stack([xm[:, l:l + t0] @ xm[:, :t0].T / t0 for l in range(n_lags)])


def run_ssi_fuzz(n_cases: int = 10, seed: int = 20260818) -> dict:
    from apda_fft_tpu.models.modal import modal_assurance
    from apda_fft_tpu.models.ssi import ssi

    rng = np.random.default_rng(seed)
    ok_n, fails = 0, []
    for case in range(n_cases):
        s = int(rng.integers(2, 7))
        n_modes = int(rng.integers(1, min(s, 3) + 1))
        fs = float(rng.choice([50.0, 100.0, 128.0]))
        freqs = np.sort(rng.uniform(0.05, 0.35, n_modes)) * fs / 2
        while n_modes > 1 and np.min(np.diff(freqs)) < 0.04 * fs:
            freqs = np.sort(rng.uniform(0.05, 0.35, n_modes)) * fs / 2
        zetas = rng.uniform(0.006, 0.025, n_modes)
        shapes = rng.standard_normal((n_modes, s))
        shapes /= np.linalg.norm(shapes, axis=1, keepdims=True)
        x = modal_records(shapes, freqs, zetas, fs, 300.0,
                          seed=int(rng.integers(2**31)), sensor_noise=0.03)
        i = 30

        res_dev = ssi(x, fs, i=i)
        res_ora = ssi(x, fs, i=i, blocks=_corr_oracle(x, 2 * i))

        case_ok = res_dev.count == res_ora.count
        if case_ok:
            for md, mo in zip(res_dev.modes, res_ora.modes):
                if abs(md.freq - mo.freq) / mo.freq > 2e-3:
                    case_ok = False
                elif abs(md.damping - mo.damping) / max(mo.damping, 1e-9) > 0.05:
                    case_ok = False
                elif modal_assurance(md.shape, mo.shape)[0, 0] < 0.999:
                    case_ok = False
        truth_ok = bool(res_dev.count) or not len(freqs)
        got = np.asarray([m.freq for m in res_dev.modes]) if res_dev.count else np.zeros(0)
        for f_true in freqs:
            if got.size == 0 or np.min(np.abs(got - f_true)) / f_true > 0.01:
                truth_ok = False
        if case_ok and truth_ok:
            ok_n += 1
        else:
            fails.append({
                "case": case, "S": s, "fs": fs,
                "true_f": [round(float(f), 3) for f in freqs],
                "dev": [(round(m.freq, 4), round(m.damping, 3)) for m in res_dev.modes],
                "ora": [(round(m.freq, 4), round(m.damping, 3)) for m in res_ora.modes],
                "vs_oracle_ok": bool(case_ok), "truth_ok": bool(truth_ok),
            })
    import jax

    return {"metric": "ssi_fuzz", "pass": ok_n, "total": n_cases,
            "platform": jax.devices()[0].platform,
            "ok": ok_n == n_cases, "fails": fails}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    out = run_ssi_fuzz(n)
    print(json.dumps(out))
    raise SystemExit(0 if out["ok"] else 1)
