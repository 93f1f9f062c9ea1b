"""Frequency-domain integration: acceleration -> velocity / displacement.

Structural serviceability works in velocity and displacement, but the
sensors measure acceleration; the reference leaves the conversion to the
server side entirely (its L4 workflow stops at spectra + peaks,
``GT_FFT_v5.py:620-679``).  Time-domain integration of a measured
(offset-, drift- and noise-contaminated) accelerometer signal diverges;
the field standard is omega-arithmetic in the frequency domain with a
high-pass cut: ``V(w) = A(w) / (iw)``, ``D(w) = -A(w) / w^2``, low bins
removed.  One rfft -> scale -> irfft per record, batched, as one jitted
XLA FFT program.

Two leakage defenses, both validated against a float64 oracle on
worst-case half-bin off-grid tones (tests/test_integrate.py):

* a Tukey edge taper (default alpha=0.3) suppresses the rectangular
  window's slowly-decaying skirt before it reaches the ``1/w^order``
  amplified low bins;
* the high-pass is a raised-cosine *transition band* from ``f_highpass``
  to ``(1 + transition) * f_highpass`` instead of a hard cut - leakage
  landing just above the cut (where a hard gate passes it at full,
  enormously amplified weight) is rolled off smoothly.

Measured worst-case amplitude error (RMS-based, flat mid-region, tones
>= 2.5x f_highpass, N in {1024, 4096, 16384}): velocity <= 0.08%,
displacement <= 0.08%.  With a hard cut and no taper the same worst-case
displacement error is 58% - see test_off_bin_leakage_controlled.

Also provides the ISO 10816/20816-style *vibration severity*
(band-limited velocity RMS), computed directly from the velocity
spectrum via Parseval - no inverse transform, immune to the irfft's
edge transients.

Units are the input's: acceleration in g integrates to g*s; multiply by
``G_TO_MMS2`` (9806.65) for mm/s.  The gateway's ``vibration_severity``
option does that conversion (sensor samples are g).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _tukey(n: int, alpha: float) -> np.ndarray:
    """Tukey (tapered-cosine) window, float64, flat over ``1 - alpha``."""
    t = np.arange(n) / (n - 1)
    w = np.ones(n)
    lo = t < alpha / 2
    w[lo] = 0.5 * (1.0 + np.cos(2.0 * np.pi / alpha * (t[lo] - alpha / 2)))
    hi = t >= 1.0 - alpha / 2
    w[hi] = 0.5 * (1.0 + np.cos(2.0 * np.pi / alpha * (t[hi] - 1.0 + alpha / 2)))
    return w


@functools.partial(jax.jit, static_argnames=("order", "n"))
def _integrate_impl(x, win, fs, f_hp, transition, *, order: int, n: int):
    dtype = x.dtype
    xc = x - jnp.mean(x, axis=-1, keepdims=True)
    spec = jnp.fft.rfft(xc * win, axis=-1)
    freqs = jnp.fft.rfftfreq(n, d=1.0 / fs).astype(jnp.float32)
    w = 2.0 * jnp.pi * freqs
    # High-pass gate: 0 below f_hp, raised-cosine up to (1+transition)*f_hp,
    # 1 above.  transition == 0 degenerates to the hard cut (denominator is
    # clamped; the ramp then saturates within one bin).
    denom = jnp.maximum(f_hp * transition, 1e-30)
    ramp = jnp.clip((freqs - f_hp) / denom, 0.0, 1.0)
    gate = jnp.where(freqs < f_hp, 0.0, 0.5 - 0.5 * jnp.cos(jnp.pi * ramp))
    gate = jnp.where(transition > 0, gate, (freqs >= f_hp).astype(gate.dtype))
    wsafe = jnp.where(w > 0, w, 1.0)
    scale = gate * wsafe ** (-float(order))
    rot = (-1j) ** order  # 1/(iw) = -i/w
    return jnp.fft.irfft(spec * (rot * scale), n=n, axis=-1).astype(dtype)


def integrate_acceleration(
    x, fs, *, order: int = 1, f_highpass=None, transition: float = 1.0,
    edge_taper: float = 0.3,
):
    """Integrate acceleration record(s) ``x`` (``[..., T]``) ``order`` times.

    Args:
      x: time records, last axis is time (input units, e.g. g).
      fs: sampling rate (Hz).
      order: 1 -> velocity, 2 -> displacement.
      f_highpass: frequency below which content is discarded (Hz).
        Default ``8 * fs / T`` (eight analysis-bin widths).  Content is
        zero below ``f_highpass`` and fully passed above
        ``(1 + transition) * f_highpass``; treat ~``2.5 * f_highpass``
        as the accurate-passband edge.
      transition: width of the raised-cosine high-pass roll-off as a
        fraction of ``f_highpass`` (default 1.0 = one octave; 0 = hard
        cut).  The soft roll-off is the main defense against off-bin
        leakage that lands just above the cut and is amplified by
        ``1/w^order`` (measured on the N=4096 worst case: hard cut
        untapered 58% displacement error, defaults 0.02%).
      edge_taper: Tukey-window alpha applied before the transform (0
        disables; default 0.3).  The taper distorts only the outer
        ``alpha/2`` of each end - read results from the flat middle.

    Returns:
      Integrated record(s), same shape, units ``input * s^order``.
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("integration needs at least 8 samples")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 (velocity) or 2 (displacement), got {order}")
    if not 0.0 <= edge_taper <= 1.0:
        raise ValueError(f"edge_taper must be in [0, 1], got {edge_taper}")
    if transition < 0.0:
        raise ValueError(f"transition must be >= 0, got {transition}")
    fs = float(fs)
    f_hp = float(f_highpass) if f_highpass is not None else 8.0 * fs / n
    win = (jnp.asarray(_tukey(n, edge_taper), x.dtype) if edge_taper > 0
           else jnp.ones((n,), x.dtype))
    return _integrate_impl(
        x, win, fs, f_hp, float(transition), order=order, n=n)


def velocity(x, fs, *, f_highpass=None, transition: float = 1.0,
             edge_taper: float = 0.3):
    """Velocity from acceleration (``order=1``); see ``integrate_acceleration``."""
    return integrate_acceleration(
        x, fs, order=1, f_highpass=f_highpass, transition=transition,
        edge_taper=edge_taper)


def displacement(x, fs, *, f_highpass=None, transition: float = 1.0,
                 edge_taper: float = 0.3):
    """Displacement from acceleration (``order=2``); see ``integrate_acceleration``."""
    return integrate_acceleration(
        x, fs, order=2, f_highpass=f_highpass, transition=transition,
        edge_taper=edge_taper)


@functools.partial(jax.jit, static_argnames=("n",))
def _severity_impl(x, fs, f_lo, f_hi, *, n: int):
    xc = x - jnp.mean(x, axis=-1, keepdims=True)
    spec = jnp.fft.rfft(xc, axis=-1)
    freqs = jnp.fft.rfftfreq(n, d=1.0 / fs).astype(jnp.float32)
    w = 2.0 * jnp.pi * freqs
    band = (freqs >= f_lo) & (freqs <= f_hi) & (w > 0)
    vmag2 = jnp.where(band, jnp.abs(spec) ** 2 / jnp.where(w > 0, w, 1.0) ** 2, 0.0)
    # Parseval for the one-sided rfft of a real series: interior bins carry
    # their conjugate twins' power; DC is cut by the band, Nyquist (even n)
    # is its own twin.
    weight = jnp.full((n // 2 + 1,), 2.0, vmag2.dtype)
    weight = weight.at[0].set(1.0)
    if n % 2 == 0:
        weight = weight.at[-1].set(1.0)
    mean_sq = jnp.sum(vmag2 * weight, axis=-1) / (n * n)
    return jnp.sqrt(mean_sq)


def velocity_rms(x, fs, band=(10.0, 1000.0)):
    """Band-limited velocity RMS of acceleration record(s) - the ISO
    10816/20816 vibration-severity quantity.

    Computed from the velocity spectrum via Parseval (no inverse
    transform, no edge taper: leakage is power-conserving, the band cut
    excludes the 1/w-amplified low bins, and a window would need its own
    power correction for <0.1% gain).  ``band`` is ``(f_lo, f_hi)`` in Hz;
    ``f_hi`` is clamped to Nyquist.  Units: ``input * s`` RMS (g in ->
    g*s; x 9806.65 for the ISO mm/s).
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 8:
        raise ValueError("severity needs at least 8 samples")
    fs = float(fs)
    f_lo, f_hi = float(band[0]), min(float(band[1]), fs / 2.0)
    if not 0.0 < f_lo < f_hi:
        raise ValueError(f"need 0 < f_lo < f_hi <= fs/2, got {band}")
    return _severity_impl(x, fs, f_lo, f_hi, n=n)


G_TO_MMS2 = 9806.65  # 1 g in mm/s^2: converts g*s velocities to ISO mm/s
