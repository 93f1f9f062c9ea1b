"""Anti-aliased integer decimation - mixed-ODR sensor fusion.

Deployed arrays mix output data rates: a footbridge deck node at 250 Hz
next to a pylon node at 62.5 Hz (the ODR enum of the wire protocol,
reference ``protocol_decoder.py:5-8``).  Cross-sensor analysis (FDD mode
shapes, SSI, coherence) needs every channel on ONE time base, which the
reference - analyzing each file in isolation (``GT_FFT_v5.py:620-679``) -
never had to face.  This module brings a faster channel down to a slower
channel's rate without aliasing its out-of-band content into the shared
band.

Design: the polyphase FIR decimator is ONE
``lax.conv_general_dilated`` with ``window_strides=q`` - XLA lowers the
strided 1-D convolution to one library call, and the whole [S, T] batch runs in
a single fused program.  The windowed-sinc taps are designed host-side in
float64 (tiny, shape-static) and baked into the compiled program as a
constant.  Semantics match ``scipy.signal.resample_poly(x, 1, q,
window=taps*q)`` exactly (same even-symmetric kernel, same zero-padded
edges, same output grid) - cross-checked in tests/test_resample.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "decimate",
    "design_decimation_taps",
    "decimation_factor",
    "rational_factors",
    "resample_rational",
]


def decimation_factor(fs_from: float, fs_to: float, *, rel_tol: float = 1e-6):
    """Integer factor ``q`` with ``fs_from == q * fs_to``, else ``None``.

    The helper callers use to decide whether two rates are fusable by
    plain decimation (the hardware ODR grid is dyadic, so in practice
    every pair of rates divides evenly).
    """
    fs_from = float(fs_from)
    fs_to = float(fs_to)
    if fs_to <= 0 or fs_from <= 0:
        return None
    q = fs_from / fs_to
    qi = int(round(q))
    if qi < 1 or abs(q - qi) > rel_tol * q:
        return None
    return qi


def rational_factors(fs_from: float, fs_to: float, *, max_den: int = 64):
    """Smallest ``(up, down)`` with ``fs_from * up / down == fs_to``.

    ``None`` when no rational relation with denominator ≤ ``max_den``
    exists (within 1e-9 relative).  Generalizes :func:`decimation_factor`
    to rate pairs like 100 → 62.5 Hz (``(5, 8)``).
    """
    from fractions import Fraction

    fs_from = float(fs_from)
    fs_to = float(fs_to)
    if fs_from <= 0 or fs_to <= 0:
        return None
    frac = Fraction(fs_to / fs_from).limit_denominator(max_den)
    if frac.numerator < 1:
        return None
    if abs(float(frac) * fs_from - fs_to) > 1e-9 * fs_to:
        return None
    return frac.numerator, frac.denominator


@functools.lru_cache(maxsize=64)
def design_decimation_taps(q: int, ntaps_per_phase: int = 12,
                           cutoff_rel: float = 0.8) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass for decimation by ``q`` (float64).

    Cutoff ``cutoff_rel / (2q)`` cycles/sample (80% of the new Nyquist -
    the usual transition-band allowance), ``2 * ntaps_per_phase * q + 1``
    taps (odd = exactly linear phase, integer group delay), Kaiser
    ``beta=8.6`` (~90 dB stopband), normalized to unit DC gain.
    """
    if q < 1:
        raise ValueError(f"decimation factor must be >= 1, got {q}")
    if ntaps_per_phase < 2:
        raise ValueError(f"ntaps_per_phase must be >= 2, got {ntaps_per_phase}")
    if not 0.0 < cutoff_rel <= 1.0:
        raise ValueError(f"cutoff_rel must be in (0, 1], got {cutoff_rel}")
    length = 2 * ntaps_per_phase * q + 1
    n = np.arange(length, dtype=np.float64) - (length - 1) / 2.0
    fc = cutoff_rel / (2.0 * q)
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(length, 8.6)
    return h / h.sum()


@functools.partial(jax.jit, static_argnames=("q", "half", "n_out"))
def _decimate_impl(x, taps, *, q: int, half: int, n_out: int):
    # [B, T] -> NCW conv layout; taps flipped so the conv computes true
    # correlation-with-symmetric-kernel = filtering (h is even-symmetric,
    # but stay explicit about the convention).
    lhs = x[:, None, :]
    rhs = taps[::-1][None, None, :].astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(q,),
        padding=[(half, half + (q - 1))],
        dimension_numbers=("NCW", "OIW", "NCW"),
        # Library rule: f32 matmuls/convs default to reduced precision on an
        # accelerator (TF32 on a GPU); the anti-aliasing filter carries the
        # alias-floor contract, so force full f32.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :n_out]


@functools.lru_cache(maxsize=64)
def _rational_taps(up: int, down: int, ntaps_per_phase: int,
                   cutoff_rel: float) -> np.ndarray:
    """Lowpass for rational resampling on the ``up``-dilated grid.

    Cutoff at ``cutoff_rel / (2 * max(up, down))`` cycles/up-sample (the
    narrower of the anti-image and anti-alias constraints), gain ``up``
    (zero-stuffing spreads unit energy over ``up`` phases).
    """
    m = max(up, down)
    length = 2 * ntaps_per_phase * m + 1
    n = np.arange(length, dtype=np.float64) - (length - 1) / 2.0
    fc = cutoff_rel / (2.0 * m)
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(length, 8.6)
    return h / h.sum() * up


@functools.partial(jax.jit, static_argnames=("up", "down", "half", "n_out"))
def _resample_impl(x, taps, *, up: int, down: int, half: int, n_out: int):
    lhs = x[:, None, :]
    rhs = taps[::-1][None, None, :].astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(down,),
        # Right pad: the last output sample sits at dilated position
        # (n_out-1)*down + half, up to `up + down` past the last dilated
        # input sample (the dilated grid ends up-1 zeros short of T*up).
        padding=[(half, half + up + down)],
        lhs_dilation=(up,),
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :n_out]


def resample_rational(records, up: int, down: int, *,
                      ntaps_per_phase: int = 12, cutoff_rel: float = 0.8,
                      dtype=jnp.float32) -> np.ndarray:
    """Rational-rate resampling of ``[..., T]`` records by ``up / down``.

    The polyphase form (`scipy.signal.resample_poly` semantics: output
    sample ``n`` is the band-limited signal at ``t = n * down / (up * fs)``,
    length ``ceil(T * up / down)``), run as ONE dilated strided
    convolution — ``lhs_dilation=up`` zero-stuffs the input inside the conv,
    so no up-sampled intermediate is ever materialized in device memory.  Covers the
    non-dyadic rate pairs :func:`decimate` cannot (e.g. 100 → 62.5 Hz via
    ``up=5, down=8``); for ``up == 1`` prefer :func:`decimate` (identical
    result, cheaper taps).
    """
    up = int(up)
    down = int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got ({up}, {down})")
    if ntaps_per_phase < 2:
        raise ValueError(f"ntaps_per_phase must be >= 2, got {ntaps_per_phase}")
    if not 0.0 < cutoff_rel <= 1.0:
        raise ValueError(f"cutoff_rel must be in (0, 1], got {cutoff_rel}")
    from math import gcd

    g = gcd(up, down)
    up //= g
    down //= g
    x = np.asarray(records)
    if x.ndim == 0:
        raise ValueError("records must have a time axis")
    t = x.shape[-1]
    if up == 1 and down == 1:
        return np.asarray(x, np.float64)
    if t < 2 * down:
        raise ValueError(f"record too short to resample by {up}/{down}: T={t}")
    taps = _rational_taps(up, down, ntaps_per_phase, cutoff_rel)
    half = (len(taps) - 1) // 2
    n_out = -(-t * up // down)
    lead = x.shape[:-1]
    xb = jnp.asarray(x.reshape((-1, t)), dtype)
    y = _resample_impl(xb, jnp.asarray(taps), up=up, down=down, half=half,
                       n_out=n_out)
    return np.asarray(y, np.float64).reshape(lead + (n_out,))


def decimate(records, q: int, *, ntaps_per_phase: int = 12,
             cutoff_rel: float = 0.8, dtype=jnp.float32) -> np.ndarray:
    """Anti-aliased decimation of ``[..., T]`` records by integer ``q``.

    Output sample ``n`` is the lowpass-filtered input at position ``n*q``
    (zero-phase: the FIR's integer group delay is folded into the conv
    padding), length ``ceil(T / q)`` - the grid
    ``scipy.signal.resample_poly(x, 1, q)`` uses, so decimated channels
    stay time-aligned with native slow channels sampled at the same
    instants.  ``q=1`` is the identity (no filtering).

    One strided convolution per call; returns float64 numpy (host
    boundary, like the other host-facing analysis helpers).
    """
    q = int(q)
    if q < 1:
        raise ValueError(f"decimation factor must be >= 1, got {q}")
    x = np.asarray(records)
    if x.ndim == 0:
        raise ValueError("records must have a time axis")
    if q == 1:
        return np.asarray(x, np.float64)
    t = x.shape[-1]
    if t < 2 * q:
        raise ValueError(f"record too short to decimate by {q}: T={t}")
    taps = design_decimation_taps(q, ntaps_per_phase, cutoff_rel)
    half = (len(taps) - 1) // 2
    n_out = -(-t // q)  # ceil
    lead = x.shape[:-1]
    xb = jnp.asarray(x.reshape((-1, t)), dtype)
    y = _decimate_impl(xb, jnp.asarray(taps), q=q, half=half, n_out=n_out)
    return np.asarray(y, np.float64).reshape(lead + (n_out,))
