"""Frequency-domain integration: analytic checks, leakage, severity.

Tolerances are set from a float64 numpy oracle sweep over worst-case
half-bin off-grid tones (see ops/integrate.py module docstring): with
the default taper + soft high-pass, amplitude error is <= 0.08% for
tones >= 2.5x f_highpass; the tolerances below carry ~3-5x margin on
top of that for the float32 device path.
"""

import numpy as np
import pytest

from apda_fft_tpu.ops.integrate import (
    G_TO_MMS2,
    displacement,
    integrate_acceleration,
    velocity,
    velocity_rms,
)

FS = 500.0
N = 4096
MID = slice(N // 4, 3 * N // 4)  # flat region of the default Tukey taper


def tone(a0=2.0, f0=25.0, n=N, fs=FS):
    t = np.arange(n) / fs
    return (a0 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), t


def amp(y):
    """Amplitude estimate robust to sampling phase: sqrt(2) * RMS."""
    return np.sqrt(2.0) * np.sqrt(np.mean(np.square(y[MID])))


def test_velocity_analytic_amplitude_and_phase():
    a0, f0 = 2.0, 25.0
    x, t = tone(a0, f0)
    v = np.asarray(velocity(x, FS))
    w = 2 * np.pi * f0
    # a = a0 sin(wt)  ->  v = -(a0/w) cos(wt)
    assert amp(v) == pytest.approx(a0 / w, rel=2e-3)
    corr = np.corrcoef(v[MID], -np.cos(w * t[MID]))[0, 1]
    assert corr > 0.9999


def test_displacement_analytic():
    a0, f0 = 2.0, 25.0
    x, t = tone(a0, f0)
    d = np.asarray(displacement(x, FS))
    w = 2 * np.pi * f0
    # d = -(a0/w^2) sin(wt): antiphase with the acceleration.
    assert amp(d) == pytest.approx(a0 / w**2, rel=2e-3)
    assert np.corrcoef(d[MID], -np.sin(w * t[MID]))[0, 1] > 0.999


def test_off_bin_leakage_controlled():
    # A half-bin off-grid tone is the worst case: its leakage skirt lands
    # in the 1/w^2-amplified low bins.  Hard-cut + untapered, displacement
    # blows up (measured 58% at this N); the default taper + soft
    # transition must hold the worst case to well under 1%.
    a0 = 2.0
    f0 = (np.round(25.0 * N / FS) + 0.5) * FS / N  # exactly half-bin off
    x, _ = tone(a0, f0)
    w = 2 * np.pi * f0
    d_hard = np.asarray(displacement(x, FS, edge_taper=0.0, transition=0.0))
    d_default = np.asarray(displacement(x, FS))
    assert abs(amp(d_hard) - a0 / w**2) > 0.10 * a0 / w**2  # the trap
    assert amp(d_default) == pytest.approx(a0 / w**2, rel=2e-3)


def test_off_bin_leakage_sweep():
    # Worst-case half-bin tones across the band: amplitude error stays
    # under 0.3% for both orders (oracle worst case 0.08%).
    a0 = 2.0
    db = FS / N
    for f_mid in (8.0, 25.0, 60.0, 150.0):
        f0 = (np.round(f_mid / db) + 0.5) * db
        x, _ = tone(a0, f0)
        w = 2 * np.pi * f0
        v = np.asarray(velocity(x, FS))
        d = np.asarray(displacement(x, FS))
        assert amp(v) == pytest.approx(a0 / w, rel=3e-3), f"vel f0={f0}"
        assert amp(d) == pytest.approx(a0 / w**2, rel=3e-3), f"disp f0={f0}"


def test_highpass_removes_low_tone():
    t = np.arange(N) / FS
    lo = 1.0 * np.sin(2 * np.pi * 1.0 * t)
    hi = 1.0 * np.sin(2 * np.pi * 50.0 * t)
    v = np.asarray(velocity((lo + hi).astype(np.float32), FS, f_highpass=10.0))
    # Only the 50 Hz term survives (50 Hz is above the 10->20 Hz
    # transition band): amplitude 1/(2 pi 50).
    assert amp(v) == pytest.approx(1.0 / (2 * np.pi * 50.0), rel=5e-3)


def test_velocity_rms_analytic_and_units():
    a0, f0 = 2.0, 25.0
    x, _ = tone(a0, f0)
    r = float(velocity_rms(x, FS, band=(10.0, 200.0)))
    expect = a0 / (2 * np.pi * f0) / np.sqrt(2)
    assert r == pytest.approx(expect, rel=2e-3)
    # g -> mm/s conversion constant: 1 g = 9806.65 mm/s^2 exactly.
    assert G_TO_MMS2 == 9806.65
    assert r * G_TO_MMS2 == pytest.approx(expect * 9806.65, rel=2e-3)


def test_velocity_rms_band_excludes_out_of_band_tone():
    t = np.arange(N) / FS
    x = (np.sin(2 * np.pi * 5.0 * t) + 0.5 * np.sin(2 * np.pi * 60.0 * t)
         ).astype(np.float32)
    r = float(velocity_rms(x, FS, band=(30.0, 200.0)))
    expect = 0.5 / (2 * np.pi * 60.0) / np.sqrt(2)  # 5 Hz tone excluded
    assert r == pytest.approx(expect, rel=5e-3)


def test_batched_and_validation():
    xs = np.stack([tone(2.0, 25.0)[0], tone(1.0, 40.0)[0]])
    v = np.asarray(velocity(xs, FS))
    assert v.shape == xs.shape
    np.testing.assert_allclose(v[1], np.asarray(velocity(xs[1], FS)), rtol=1e-6)
    r = np.asarray(velocity_rms(xs, FS))
    assert r.shape == (2,)
    with pytest.raises(ValueError):
        integrate_acceleration(np.zeros(4), FS)
    with pytest.raises(ValueError):
        integrate_acceleration(np.zeros(64), FS, order=3)
    with pytest.raises(ValueError):
        integrate_acceleration(np.zeros(64), FS, edge_taper=1.5)
    with pytest.raises(ValueError):
        integrate_acceleration(np.zeros(64), FS, transition=-0.5)
    with pytest.raises(ValueError):
        velocity_rms(np.zeros(64), FS, band=(0.0, 10.0))


def test_double_integration_consistency():
    # displacement == velocity integrated once more (same spectral path;
    # the second pass uses a hard cut + no taper so the already-gated,
    # already-tapered velocity passes through its own passband unchanged).
    x, _ = tone(2.0, 25.0)
    d = np.asarray(displacement(x, FS, f_highpass=5.0))
    v = np.asarray(velocity(x, FS, f_highpass=5.0))
    d2 = np.asarray(velocity(v, FS, f_highpass=5.0, transition=0.0,
                             edge_taper=0.0))
    np.testing.assert_allclose(d[MID], d2[MID], atol=3e-6)


def test_float64_oracle_agreement():
    # The jitted float32 path agrees with a float64 numpy re-derivation
    # of the same formulation to float32 roundoff.
    a0, f0 = 2.0, 25.3
    x64 = a0 * np.sin(2 * np.pi * f0 * np.arange(N) / FS)
    n = N
    t = np.arange(n) / (n - 1)
    alpha = 0.3
    win = np.ones(n)
    lo = t < alpha / 2
    win[lo] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (t[lo] - alpha / 2)))
    hi = t >= 1 - alpha / 2
    win[hi] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (t[hi] - 1 + alpha / 2)))
    xc = x64 - x64.mean()
    spec = np.fft.rfft(xc * win)
    freqs = np.fft.rfftfreq(n, 1 / FS)
    w = 2 * np.pi * freqs
    f_hp = 8.0 * FS / n
    ramp = np.clip((freqs - f_hp) / f_hp, 0, 1)
    gate = np.where(freqs < f_hp, 0.0, 0.5 - 0.5 * np.cos(np.pi * ramp))
    wsafe = np.where(w > 0, w, 1.0)
    oracle = np.fft.irfft(spec * (-1j) * gate / wsafe, n=n)
    got = np.asarray(velocity(x64.astype(np.float32), FS))
    scale = np.max(np.abs(oracle))
    assert np.max(np.abs(got - oracle)) / scale < 1e-5
