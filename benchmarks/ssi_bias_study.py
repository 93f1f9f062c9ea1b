"""50-seed SSI damping-bias fit per (zeta, f0, T) cell.

The round-4 damping fidelity study (docs/DESIGN.md) established that
single-record SSI damping error is variance-bound at the output-only
information floor ``CoV ~ 1/sqrt(2 zeta w0 T)`` and that trend aggregation
shrinks it as 1/sqrt(n) - but at n=12 seeds per cell it could only bound
the residual ESTIMATOR BIAS below ~8% at zeta=0.5%, "not resolvable".
This harness runs the named next experiment: 50 independent records per
(zeta, T) cell on the canonical 2-mode truth (3.1 / 7.6 Hz, 4 sensors,
fs=50), reporting per-mode relative bias with its standard error - the
number that decides whether ``ModeTrack.damping_estimate``'s (mean, sem, n)
can be trusted for alerting once n grows (a bias comparable to the alert
threshold would fire/mask alerts systematically; sem-resolution alone
cannot catch a bias).

One JSON document (+ a markdown table for DESIGN.md on stdout).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

TRUE_FREQS = (3.1, 7.6)
SHAPES = np.array([[1.0, 0.8, 0.5, 0.2], [1.0, -0.3, -0.9, 0.6]])
FS = 50.0
I_ROWS = 20


def run_cell(zeta: float, t_sec: float, seeds: int) -> dict:
    from apda_fft_tpu.models.ssi import ssi
    from apda_fft_tpu.utils.synthetic import modal_records

    per_mode: list[list[float]] = [[], []]
    found: list[int] = [0, 0]
    for seed in range(seeds):
        recs = modal_records(SHAPES, TRUE_FREQS, [zeta, zeta], FS,
                             t_sec=t_sec, seed=1000 * seed + 7)
        try:
            res = ssi(recs, FS, i=I_ROWS)
        except Exception:  # noqa: BLE001 - a failed fit is a miss, not a crash
            continue
        for k, f0 in enumerate(TRUE_FREQS):
            hits = [m for m in res.modes if abs(m.freq - f0) / f0 < 0.05]
            if hits:
                m = min(hits, key=lambda m: abs(m.freq - f0))
                per_mode[k].append(m.damping / 100.0)  # percent -> ratio
                found[k] += 1
    out = {"zeta_pct": zeta * 100.0, "t_sec": t_sec, "seeds": seeds,
           "modes": []}
    for k, f0 in enumerate(TRUE_FREQS):
        d = np.asarray(per_mode[k], np.float64)
        n = d.size
        if n < 2:
            out["modes"].append({"f0": f0, "n": int(n)})
            continue
        rel = (d - zeta) / zeta
        bias = float(rel.mean())
        sem = float(rel.std(ddof=1) / np.sqrt(n))
        out["modes"].append({
            "f0": f0,
            "n": int(n),
            "bias_rel": round(bias, 4),
            "bias_sem": round(sem, 4),
            "rms_rel": round(float(np.sqrt((rel ** 2).mean())), 4),
            # information floor for one record of this length
            "cov_floor": round(
                1.0 / np.sqrt(2.0 * zeta * 2.0 * np.pi * f0 * t_sec), 4),
            # bias resolved at 2 sem?
            "bias_resolved": bool(abs(bias) > 2.0 * sem),
        })
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--zetas", default="0.005,0.01,0.02")
    ap.add_argument("--t", default="120,240")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    cells = []
    for zeta in (float(z) for z in args.zetas.split(",")):
        for t_sec in (float(t) for t in args.t.split(",")):
            cell = run_cell(zeta, t_sec, args.seeds)
            cells.append(cell)
            print(f"# {json.dumps(cell)}", file=sys.stderr, flush=True)
    result = {"metric": "ssi_damping_bias_fit", "i_rows": I_ROWS,
              "fs": FS, "freqs": TRUE_FREQS, "cells": cells}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    # Markdown table for DESIGN.md.
    print("| zeta | T | mode | n | bias +- sem | rms | CoV floor | resolved |")
    print("|---|---|---|---|---|---|---|---|")
    for c in cells:
        for m in c["modes"]:
            if "bias_rel" not in m:
                continue
            print(f"| {c['zeta_pct']:.1f}% | {c['t_sec']:.0f} s "
                  f"| {m['f0']:.1f} Hz | {m['n']} "
                  f"| {m['bias_rel']*100:+.1f}% +- {m['bias_sem']*100:.1f}% "
                  f"| {m['rms_rel']*100:.1f}% | {m['cov_floor']*100:.1f}% "
                  f"| {'YES' if m['bias_resolved'] else 'no'} |")
    print(json.dumps({"metric": "ssi_damping_bias_fit",
                      "cells": len(cells), "seeds": args.seeds}))


if __name__ == "__main__":
    main()
