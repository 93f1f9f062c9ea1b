"""Welch path vs a float64 oracle: end-to-end decision fuzz.

The epoch pipeline's decisions are gated against the float64 oracle on
hardware every round; this extends the same discipline to the newly-wired
Welch surface (round 3): a pure-numpy float64 model of
``analyze_welch``'s chain (frame -> mean-detrend -> pad -> normalized
hann -> rfft magnitudes, DC zeroed -> RMS power average -> detector)
versus the f32 device path, over a fixed randomized corpus.

Unlike the raw-mags detector fuzz (which feeds identical pre-quantized
values to both sides), the f32 spectrum+average here genuinely differs
from float64 at the ~1e-7 level, so exact agreement is an empirical
claim about threshold margins - the same claim the on-device e2e fuzz
(``benchmarks/fuzz.py``) makes for the epoch path.
"""

import numpy as np
import pytest

from apda_fft_tpu.models.streaming import analyze_welch
from tests.oracle import oracle_prominence_peaks, oracle_resolution_peaks
from tests.test_detector_fuzz import _spec_from_mags


def _oracle_welch_mags(x, window, hop, taper="hann", detrend="mean"):
    """float64 model of _segment_mags + RMS power averaging."""
    x = np.asarray(x, np.float64)
    t = len(x)
    w = (t - window) // hop + 1
    n_fft = 1
    while n_fft < window:
        n_fft <<= 1
    segs = np.stack([x[s * hop : s * hop + window] for s in range(w)])
    if detrend == "mean":
        segs = segs - segs.mean(axis=1, keepdims=True)
    if window < n_fft:
        segs = np.pad(segs, ((0, 0), (0, n_fft - window)))
    if taper == "hann":
        i = np.arange(n_fft, dtype=np.float64)
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / max(window - 1.0, 1.0))
        win[window:] = 0.0  # taper spans the data, zero over the pad
        win = win / win.mean()
        segs = segs * win
    mags = np.abs(np.fft.rfft(segs))[:, : n_fft // 2]
    mags[:, 0] = 0.0
    avg = np.sqrt(np.mean(mags * mags, axis=0))
    return avg


def _signal(rng, n, fs):
    t = np.arange(n) / fs
    x = rng.standard_normal(n)
    for _ in range(int(rng.integers(1, 4))):
        f = float(rng.uniform(0.05, 0.9) * fs / 2)
        a = float(rng.uniform(0.2, 1.5))
        x += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return x.astype(np.float32)  # wire precision: both sides see f32 samples


@pytest.mark.parametrize("seed", range(12))
def test_welch_decisions_match_float64_oracle(seed):
    rng = np.random.default_rng(8100 + seed)
    for _ in range(5):
        n = int(rng.choice([4096, 8192]))
        window = int(rng.choice([512, 1024]))
        fs = float(rng.choice([31.25, 62.5, 125.0, 250.0, 500.0]))
        mode = ("flexible", "rigid")[int(rng.integers(0, 2))]
        x = _signal(rng, n, fs)
        hop = window // 2

        avg64 = _oracle_welch_mags(x, window, hop)
        # Oracle detectors on the f64-averaged spectrum (magnitude order,
        # thresholds, rounding - the full reference decision chain).
        if mode == "flexible":
            ref = oracle_prominence_peaks(_spec_from_mags(avg64), fs)
        else:
            ref = oracle_resolution_peaks(_spec_from_mags(avg64), fs)

        res = analyze_welch(x, fs, window=window, hop=hop, mode=mode)
        got = [int(i) for i in np.asarray(res.idx)[: int(res.count)]]
        assert got == [p["idx"] for p in ref], (seed, n, window, fs, mode)
