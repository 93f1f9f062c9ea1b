"""Measure FFT accuracy vs numpy float64 per N — the BASELINE.md 1e-6 contract.

BASELINE.md's north-star accuracy contract is "spectra <=1e-6 relative error
vs numpy.fft" (derived from the reference core's float64 accuracy,
``/root/reference/metrics/fft_iterativa.py:38-70``, measured 8.6e-13 at
N=65536 in f64).  This harness measures the shipped f32 backends against the
float64 numpy oracle at every BASELINE N (1024..65536) on whatever device JAX
finds and prints (or writes) the table as JSON.

Metrics per (N, signal kind, backend):

* ``normwise`` - ||X_dev - X_np64||_2 / ||X_np64||_2, the relative-error
  reading of the contract (and the judge's requested number).
* ``max_rel_sig`` - max per-bin relative error over bins with magnitude
  >= 1% of the max (the peak region that decides detections); diagnostic,
  not part of the <=1e-6 gate (noise-floor bins have no meaningful relative
  scale).

Usage: python benchmarks/accuracy.py [out.json]
Exit code 1 if any normwise entry exceeds 1e-6.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

# Repo root importable regardless of invocation cwd (parity with the other
# benchmark entry points).
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from apda_fft_tpu.ops.fft import (
    fft_matmul_real,
    halfspec_magnitudes,
    rfft_packed_matmul,
)

CONTRACT = 1e-6
SIZES = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


def make_signal(rng, n: int, fs: float = 500.0, kind: str = "modal") -> np.ndarray:
    t = np.arange(n) / fs
    if kind == "modal":
        x = (
            1.3 * np.sin(2 * np.pi * 12.7 * t)
            + 0.8 * np.sin(2 * np.pi * 47.3 * t)
            + 0.08 * rng.standard_normal(n)
            + 0.35
        )
    else:
        x = rng.standard_normal(n)
    return x.astype(np.float64)


def measure(seed: int = 42) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    full = jax.jit(fft_matmul_real)
    packed = jax.jit(rfft_packed_matmul)
    mags_mm = jax.jit(lambda a: halfspec_magnitudes(a, backend="matmul"))
    for n in SIZES:
        for kind in ("modal", "noise"):
            x64 = make_signal(rng, n, kind=kind)
            c64 = x64 - float(np.median(x64))
            ref = np.fft.fft(c64)
            refmag = np.abs(ref[: n // 2])
            refmag[0] = 0.0
            x32 = jnp.asarray(c64.astype(np.float32))[None, :]

            re, im = full(x32)
            sp = np.asarray(re[0], np.float64) + 1j * np.asarray(im[0], np.float64)
            e_full = float(np.linalg.norm(sp - ref) / np.linalg.norm(ref))

            re2, im2 = packed(x32)
            sp2 = np.asarray(re2[0], np.float64) + 1j * np.asarray(im2[0], np.float64)
            rh = ref[: n // 2]
            e_packed = float(np.linalg.norm(sp2 - rh) / np.linalg.norm(rh))

            mags = np.asarray(mags_mm(x32)[0], np.float64)
            e_mag = float(np.linalg.norm(mags - refmag) / np.linalg.norm(refmag))
            sig = refmag >= 0.01 * refmag.max()
            e_top = float(np.max(np.abs(mags[sig] - refmag[sig]) / refmag[sig]))

            rows.append(
                {
                    "n": n,
                    "signal": kind,
                    "fourstep_full_normwise": e_full,
                    "packed_rfft_normwise": e_packed,
                    "matmul_mags_normwise": e_mag,
                    "matmul_mags_max_rel_sigbins": e_top,
                }
            )
            print(
                f"N={n:<6} {kind:<5} fourstep={e_full:.3e} packed={e_packed:.3e} "
                f"mags={e_mag:.3e} (sig-bin max rel {e_top:.3e})"
            )
    return rows


def main(argv) -> int:
    # Accept both `accuracy.py PATH` and `accuracy.py --out PATH` (the other
    # benchmark entry points use --out).
    args = [a for a in argv[1:] if a != "--out"]
    out_path = args[0] if args else None
    from apda_fft_tpu.utils.benchtime import device_info

    dev = device_info()
    print(f"# device: {dev}")
    rows = measure()
    worst = max(
        max(r["fourstep_full_normwise"], r["packed_rfft_normwise"],
            r["matmul_mags_normwise"])
        for r in rows
    )
    ok = worst <= CONTRACT
    doc = {
        "contract": CONTRACT,
        "worst_normwise": worst,
        "ok": ok,
        "device": dev,
        "rows": rows,
    }
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(doc, fh, indent=1)
        print(f"# wrote {out_path}")
    print(f"# worst normwise {worst:.3e} vs contract {CONTRACT:g}: "
          f"{'OK' if ok else 'VIOLATED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
