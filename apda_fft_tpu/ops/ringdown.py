"""Free-decay (ring-down) damping estimation - the shock-transient story.

A 0xC1 shock transient is free decay: x(t) ~ A * exp(-zeta * w0 * t) *
sin(wd * t + phi).  The spectral half-power width the detectors use (and
the reference uses, ``get_peak_prominence.py:89-112``) is the right tool
for operational (forced/ambient) response; for free decay the textbook
estimator is the logarithmic decrement - fit the log of the decay
envelope.  This module implements it batched on device: band-select around the
modal line in the frequency domain, analytic signal via the half-spectrum
trick (Hilbert), linear least squares on the log envelope.  One jitted
program, vmappable over transients.

Beyond-reference capability (the reference never analyzes shock data);
pairs with the gateway's opt-in ``analyze_shock``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from apda_fft_tpu.ops import fft as fft_ops


@functools.partial(jax.jit, static_argnames=("n_fft", "band_rel"))
def _ringdown_impl(x, fs, f0, *, n_fft: int, band_rel: float):
    dtype = x.dtype
    n = x.shape[-1]
    fs = jnp.asarray(fs, dtype)
    f0 = jnp.asarray(f0, dtype)

    # Analytic signal restricted to the modal band: FFT, keep positive
    # frequencies within band_rel of f0 (doubled - the Hilbert half-spectrum
    # trick), inverse FFT.  Mean-center first (free decay rides on the
    # sensor's DC offset).
    xc = x - jnp.mean(x, axis=-1, keepdims=True)
    if n < n_fft:
        xc = jnp.pad(xc, [(0, 0)] * (xc.ndim - 1) + [(0, n_fft - n)])
    spec = jnp.fft.fft(xc, axis=-1)
    # freqs broadcasts over batched fs/f0: [..., n_fft].
    freqs = jnp.arange(n_fft, dtype=dtype) * (fs[..., None] / n_fft)
    lo = (f0 * (1.0 - band_rel))[..., None]
    hi = (f0 * (1.0 + band_rel))[..., None]
    # Clamp strictly below Nyquist: bins at/above fs/2 are the conjugate
    # half-spectrum, and doubling them corrupts the analytic envelope
    # (silently 4x-biased damping for f0 near fs/2).
    band = (freqs >= lo) & (freqs <= hi) & (freqs < fs[..., None] * 0.5)
    analytic = jnp.fft.ifft(jnp.where(band, spec * 2.0, 0.0), axis=-1)[..., :n]
    env = jnp.abs(analytic).astype(dtype)

    # Fit log(env) from the envelope peak to where it decays to 5% of the
    # peak (noise floor); weighted least squares with the mask.
    peak_i = jnp.argmax(env, axis=-1)
    peak_v = jnp.take_along_axis(env, peak_i[..., None], axis=-1)
    iota = jnp.arange(n)
    floor = jnp.asarray(0.05, dtype) * peak_v
    above = env > floor
    # Fit window: from the envelope peak to the first sample after it that
    # drops below the 5% noise floor.
    in_decay = (iota >= peak_i[..., None]) & above
    # Close the window at the first below-floor sample after the peak.
    below_after = (iota >= peak_i[..., None]) & ~above
    first_below = jnp.where(
        jnp.any(below_after, axis=-1),
        jnp.argmax(below_after, axis=-1),
        jnp.asarray(n, jnp.int64 if iota.dtype == jnp.int64 else jnp.int32),
    )
    fit = in_decay & (iota < first_below[..., None])

    t = iota.astype(dtype) / fs[..., None]
    logy = jnp.log(jnp.maximum(env, jnp.asarray(1e-30, dtype)))
    w = fit.astype(dtype)
    sw = jnp.sum(w, axis=-1)
    swx = jnp.sum(w * t, axis=-1)
    swy = jnp.sum(w * logy, axis=-1)
    swxx = jnp.sum(w * t * t, axis=-1)
    swxy = jnp.sum(w * t * logy, axis=-1)
    denom = sw * swxx - swx * swx
    slope = jnp.where(denom != 0, (sw * swxy - swx * swy) / denom, 0.0)

    # x(t) ~ exp(-zeta*w0*t): slope = -zeta*2*pi*f0 (light damping: wd ~ w0).
    zeta = jnp.where(f0 > 0, -slope / (2.0 * jnp.pi * f0), 0.0)
    return zeta, sw


def ringdown_damping(
    x,
    fs,
    f0,
    band_rel: float = 0.2,
    min_cycles: float = 3.0,
):
    """Damping ratio ``zeta`` of a free-decay transient by log decrement.

    Args:
      x: ``[..., N]`` transient record(s) (e.g. 0xC1 shock samples).
      fs: sampling rate (Hz), scalar or broadcastable.
      f0: modal frequency (Hz) to band-select, e.g. the detected peak
        (scalar or batch-shaped).
      band_rel: half-bandwidth of the modal band as a fraction of ``f0``.
      min_cycles: estimates whose fit window spans fewer oscillation
        cycles than this return NaN (too short to trust).

    Returns:
      ``zeta`` (damping ratio, NOT percent; batch-shaped).  For the
      reference-style percent, multiply by 100.
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    n_fft = fft_ops.next_pow2(x.shape[-1])
    zeta, n_fit = _ringdown_impl(x, fs, f0, n_fft=n_fft, band_rel=band_rel)
    fs_a = jnp.asarray(fs, x.dtype)
    f0_a = jnp.asarray(f0, x.dtype)
    cycles = n_fit / fs_a * f0_a
    return jnp.where(cycles >= min_cycles, zeta, jnp.nan)
