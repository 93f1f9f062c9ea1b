"""Shock Response Spectrum - damage-potential characterization of shocks.

The SRS is the industry-standard way to quantify what a shock transient
can do to a structure: drive a bank of single-degree-of-freedom
oscillators (natural frequencies on a log grid, common Q of 10) with the
measured base acceleration and record each oscillator's extreme absolute
response.  The reference uploads 0xC1 shock records raw and never
analyzes them (``GT_FFT_v5.py:514-554``); this module adds the analysis
the downstream engineer would otherwise run by hand.

Design: the SDOF bank uses the ISO 18431-4 ramp-invariant
(Smallwood) digital filter, whose second-order recurrence is evaluated as
a *parallel* first-order affine recurrence with
``jax.lax.associative_scan`` - log2(T) elementwise passes over a
``[T, F]`` layout (time x frequency bank), no sequential Python, no
``lax.scan`` serialization.  The whole bank evaluates in one jitted
program, vmappable over a batch of transients.

Numerical design note (measured, see ``tests/test_srs.py`` and
docs/DESIGN.md): the obvious scan element - the 2x2 *companion* matrix
``[[-a1, -a2], [1, 0]]`` - is tree-UNSTABLE in f32 for poles near the
unit circle (low ``fn*dt``, light damping): companion products cancel
catastrophically, amplifying ulp-level reassociation differences by up
to ~1e8 (observed: a 3.6x wrong maximax on XLA:CPU while the
mathematically identical eager graph was fine).  The recurrence is
therefore evaluated in *realified-diagonal coordinates*: the companion
matrix is similar to the scaled rotation ``E*R(K)`` (eigenvalues
``E*exp(+-iK)``), and products of scaled rotations are
orthogonal-times-scalar - perfectly conditioned at every tree level.
With ``z = P^-1 [y[t], y[t-1]]``, ``P = [[alpha, -beta], [1, 0]]``:

    z[t] = [[alpha, -beta], [beta, alpha]] z[t-1] + [0, -u[t]/beta]
    y[t] = alpha*z1[t] - beta*z2[t]

where ``alpha = E*cos(K)``, ``beta = E*sin(K)`` and ``u`` is the FIR
part (fully parallel).  Measured f32 accuracy vs a float64 sequential
``scipy.signal.lfilter`` oracle: 3.6e-6 max relative error across the
bank (the companion form measured 2.9e-5 on its well-conditioned bins
and diverged on low ones).  Coefficients are computed host-side in
float64; only the recurrence runs in f32 on device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def srs_frequencies(
    f_min: float, f_max: float, points_per_octave: int = 6
) -> np.ndarray:
    """Log-spaced SDOF natural-frequency bank, ``points_per_octave`` per octave.

    Includes ``f_min`` exactly; the last point is the largest grid point
    ``<= f_max`` (plus ``f_max`` itself if the grid undershoots by more
    than 1%), matching standard SRS practice of a 1/6-octave grid.
    """
    if f_min <= 0 or f_max <= f_min:
        raise ValueError(f"need 0 < f_min < f_max, got ({f_min}, {f_max})")
    if points_per_octave < 1:
        # 0 would divide by zero below and produce an all-NaN bank that
        # sails through the (0, fs/2) validation (NaN comparisons are
        # False); fail at the argument instead.
        raise ValueError(
            f"points_per_octave must be >= 1, got {points_per_octave}")
    n_oct = math.log2(f_max / f_min)
    n = int(math.floor(n_oct * points_per_octave)) + 1
    freqs = f_min * (2.0 ** (np.arange(n) / points_per_octave))
    if f_max / freqs[-1] > 1.01:
        freqs = np.append(freqs, f_max)
    return freqs


def _sdof_params(
    freqs: np.ndarray, fs: float, q: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-oscillator ``(E, E cos K, E sin K)`` in float64.

    ``E = exp(-zeta wn dt)`` is the per-sample decay; ``K = wd dt`` the
    per-sample damped phase advance.
    """
    freqs = np.asarray(freqs, np.float64)
    if np.any(freqs <= 0) or np.any(freqs >= fs / 2):
        raise ValueError("SRS bank frequencies must lie in (0, fs/2)")
    zeta = 1.0 / (2.0 * q)
    dt = 1.0 / float(fs)
    wn = 2.0 * np.pi * freqs
    k = wn * np.sqrt(1.0 - zeta * zeta) * dt
    e = np.exp(-zeta * wn * dt)
    return e, e * np.cos(k), e * np.sin(k)


def smallwood_coefficients(
    freqs: np.ndarray, fs: float, q: float = 10.0
) -> tuple[np.ndarray, np.ndarray]:
    """ISO 18431-4 ramp-invariant SDOF filter coefficients, float64.

    Returns ``(b, a)`` with shapes ``[3, F]`` / ``[3, F]`` (``a[0] == 1``):
    the absolute-acceleration model - base acceleration in, oscillator
    absolute acceleration out.
    """
    freqs = np.asarray(freqs, np.float64)
    e, c, s = _sdof_params(freqs, fs, q)
    zeta = 1.0 / (2.0 * q)
    k = 2.0 * np.pi * freqs * np.sqrt(1.0 - zeta * zeta) / float(fs)
    sp = s / k
    b = np.stack([1.0 - sp, 2.0 * (sp - c), e * e - sp])
    a = np.stack([np.ones_like(c), -2.0 * c, e * e])
    return b, a


def _combine(left, right):
    # Composition of affine recurrence steps s -> M s + v: right after left.
    l11, l12, l21, l22, lv1, lv2 = left
    r11, r12, r21, r22, rv1, rv2 = right
    return (
        r11 * l11 + r12 * l21,
        r11 * l12 + r12 * l22,
        r21 * l11 + r22 * l21,
        r21 * l12 + r22 * l22,
        r11 * lv1 + r12 * lv2 + rv1,
        r21 * lv1 + r22 * lv2 + rv2,
    )


@functools.partial(jax.jit, static_argnames=("pad",))
def _srs_impl(x, b, alpha, beta, *, pad: int):
    """Maximax / positive / negative SRS of ``x`` over the coefficient bank.

    x: ``[..., T]`` base acceleration.  b: ``[3, F]`` FIR coefficients;
    alpha/beta: ``[F]`` scaled-rotation entries (``E cos K`` / ``E sin K``
    - see the module docstring for why rotation coordinates, not the
    companion matrix).  Returns ``(maximax, pos, neg)`` each ``[..., F]``.
    """
    dtype = x.dtype
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    # FIR part is fully parallel: u[t] = b0 x[t] + b1 x[t-1] + b2 x[t-2].
    xm1 = jnp.roll(x, 1, axis=-1).at[..., 0].set(0.0)
    xm2 = jnp.roll(x, 2, axis=-1).at[..., :2].set(0.0)
    u = (
        x[..., None] * b[0]
        + xm1[..., None] * b[1]
        + xm2[..., None] * b[2]
    )  # [..., T, F]
    # IIR part as an affine recurrence in rotation coordinates:
    #   z[t] = E R(K) z[t-1] + [0, -u[t]/beta];  y[t] = alpha z1 - beta z2.
    # Every scan element's matrix is orthogonal-times-scalar, so the
    # parallel tree is conditioned like the sequential fold.
    shape = u.shape
    al = jnp.broadcast_to(alpha.astype(dtype), shape)
    be = jnp.broadcast_to(beta.astype(dtype), shape)
    _, _, _, _, z1, z2 = jax.lax.associative_scan(
        _combine,
        (al, -be, be, al, jnp.zeros(shape, dtype), -u / beta.astype(dtype)),
        axis=-2,
    )
    y = alpha.astype(dtype) * z1 - beta.astype(dtype) * z2
    return (
        jnp.max(jnp.abs(y), axis=-2),
        jnp.max(y, axis=-2),
        jnp.min(y, axis=-2),
    )


@dataclasses.dataclass(frozen=True)
class SRSResult:
    """SRS over a frequency bank; arrays are batch-shaped ``[..., F]``.

    ``maximax`` is the classic reported spectrum (largest absolute
    oscillator acceleration over primary + residual phases, input units);
    ``positive`` / ``negative`` are the signed extremes.  ``pseudo_velocity``
    is ``maximax / wn`` (input-units x seconds) - exact for an undamped
    oscillator and the standard damage-potential proxy at Q = 10.
    """

    freqs: np.ndarray
    maximax: np.ndarray
    positive: np.ndarray
    negative: np.ndarray
    q: float

    @property
    def pseudo_velocity(self) -> np.ndarray:
        return self.maximax / (2.0 * np.pi * self.freqs)

    def peak(self) -> tuple[float, float]:
        """(frequency, maximax value) of the spectrum's largest entry.

        Batched results reduce over the whole batch (the worst oscillator
        anywhere in the batch).
        """
        mm = np.asarray(self.maximax)
        flat = mm.reshape(-1, mm.shape[-1])
        i = int(np.argmax(np.max(flat, axis=0)))
        return float(self.freqs[i]), float(np.max(flat[:, i]))


def shock_response_spectrum(
    x,
    fs: float,
    freqs=None,
    *,
    q: float = 10.0,
    f_min: float | None = None,
    f_max: float | None = None,
    points_per_octave: int = 6,
    residual: bool = True,
) -> SRSResult:
    """Shock Response Spectrum of transient(s) ``x`` (``[..., T]``, any units).

    Args:
      x: base-acceleration record(s); last axis is time.
      fs: sampling rate in Hz.
      freqs: explicit natural-frequency bank (Hz). Default: a
        ``points_per_octave`` log grid from ``f_min`` (default ``fs/100``)
        to ``f_max`` (default ``fs/4``).
      q: oscillator quality factor (damping ``zeta = 1/(2q)``; Q=10 is the
        universal test-standard default).
      residual: include the free-decay phase after the record ends by
        zero-padding one period of the slowest oscillator (the damped
        residual's global extreme occurs within its first period).

    Returns:
      ``SRSResult`` - maximax/positive/negative spectra ``[..., F]`` plus
      the bank and pseudo-velocity.
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    if x.shape[-1] < 3:
        raise ValueError("SRS needs at least 3 samples")
    if freqs is None:
        lo = f_min if f_min is not None else fs / 100.0
        hi = f_max if f_max is not None else fs / 4.0
        freqs = srs_frequencies(lo, hi, points_per_octave)
    freqs = np.asarray(freqs, np.float64)
    b, _ = smallwood_coefficients(freqs, fs, q)
    _, alpha, beta = _sdof_params(freqs, fs, q)
    pad = int(math.ceil(fs / float(freqs.min()))) if residual else 0
    mm, pos, neg = _srs_impl(
        x,
        jnp.asarray(b, x.dtype),
        jnp.asarray(alpha, x.dtype),
        jnp.asarray(beta, x.dtype),
        pad=pad,
    )
    return SRSResult(
        freqs=freqs,
        maximax=np.asarray(mm),
        positive=np.asarray(pos),
        negative=np.asarray(neg),
        q=float(q),
    )
