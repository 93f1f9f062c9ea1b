"""Operational modal analysis (FDD) - beyond-reference capability.

The reference analyzes every sensor channel in isolation: one file, one
spectrum, one peak list (``GT_FFT_v5.py:620-679``).  Cross-sensor structure
- which physical MODE a peak belongs to, and the mode SHAPE (relative
amplitude and sign of the motion at each sensor) - is invisible to it,
although its deployments are exactly the multi-sensor arrays (footbridges,
tunnels) the technique was invented for.

Frequency-Domain Decomposition (Brincker/Zhang/Andersen 2001) is the
standard output-only modal-identification method:

1. estimate the cross-spectral density (CSD) matrix ``G(f) [S, S]`` over
   all ``S`` sensors (Welch-averaged, same conventions as
   :func:`~apda_fft_tpu.models.streaming.cross_psd`),
2. singular-value-decompose ``G(f)`` at every frequency line; the first
   singular value ``s1(f)`` is an SDOF-like spectrum whose peaks are the
   structural modes (even when two modes share a bin in every single
   auto-spectrum), and the first singular vector at a peak is the mode
   shape,
3. the ``s2/s1`` ratio at a peak measures mode separation (a repeated or
   closely spaced mode keeps ``s2`` high).

Design: the segment spectra of all sensors come from ONE batched
matmul-FFT dispatch ([S, W, H] in one program); the CSD matrix is two
einsum contractions over the segment axis; and the per-frequency SVD is a
*batched power iteration with one deflation* in all-real arithmetic
([H, S, S] x [H, S] einsum matvecs inside a ``lax.scan``) - G(f) is
Hermitian PSD, so its singular triplets are its eigen triplets and power
iteration on the complex matrix embedded as (re, im) pairs is exact.  No
``eigh``/SVD custom call (it breaks SPMD partitioning, and was chosen
against on the earlier chip; ROADMAP S5/D7 re-decide it on the GPU), no
complex dtype on device.  Every contraction runs at ``Precision.HIGHEST``
(full f32; a GPU would otherwise use TF32).

Validated against ``numpy.linalg.eigh`` on the host-assembled complex CSD
and against a synthetic multi-sensor modal model (known shapes recovered
with MAC > 0.99) in ``tests/test_modal.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from apda_fft_tpu.models import pipeline as _pipeline
from apda_fft_tpu.models.streaming import (
    DETRENDS,
    _bin_freqs,
    _segment_spectra,
    _taper_power_sum,
)
from apda_fft_tpu.ops import fft as fft_ops

#: Power-iteration steps for the per-frequency dominant eigenpair.  The
#: iterate converges as (s2/s1)**t; at 60 steps even a 0.9 ratio (very
#: closely spaced modes) is resolved to ~2e-3; the whole [H, S] sweep is
#: small batched matvecs at S <= 32.
_POWER_ITERS = 60


class FDDResult(NamedTuple):
    """Modes identified by FDD, plus the singular-value spectra behind them.

    ``k`` mode slots (``count`` valid, unused slots ``idx = -1`` / zeros),
    ``S`` sensors, ``H`` frequency bins.  Mode shapes are unit-norm complex
    vectors phase-rotated so the largest-magnitude component is real
    positive; a physical (proportionally damped) mode has components close
    to real, so ``shape_re`` carries the signed shape and ``shape_im`` its
    distance from physical realness.
    """

    count: np.ndarray  # [] int32 - number of valid mode slots
    idx: np.ndarray  # [k] int32 bin index, -1 = empty
    freq: np.ndarray  # [k] Hz (detector 4-dp rounding convention)
    damping: np.ndarray  # [k] percent of critical, from the s1 bell's
    #: half-power width (the detectors' convention; zeros where rejected)
    sv_ratio: np.ndarray  # [k] s2/s1 at the peak - mode-separation measure
    shape_re: np.ndarray  # [k, S] mode shape, real part
    shape_im: np.ndarray  # [k, S] mode shape, imaginary part
    freqs: np.ndarray  # [H] bin frequencies (plotting axis)
    sv1: np.ndarray  # [H] first singular value of G(f) (density units)
    sv2: np.ndarray  # [H] second singular value (noise/secondary-mode floor)
    damping_efdd: np.ndarray  # [k] percent, enhanced-FDD log-decrement
    #: estimate (NaN when efdd=False or the per-mode fit is untrustworthy)
    kurtosis: np.ndarray = None  # [k] narrowband kurtosis per mode (NaN when
    #: harmonics=False): ~1.5 flags a deterministic harmonic, ~3 a true
    #: stochastic structural mode (see :func:`harmonic_indicator`)

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    def shapes(self) -> np.ndarray:
        """Complex [k, S] mode-shape matrix (host convenience view)."""
        return self.shape_re + 1j * self.shape_im

    def harmonic_mask(self, kurtosis_max: float = 2.2) -> np.ndarray:
        """Boolean [k]: True where the mode looks like a forced harmonic.

        Requires ``fdd(..., harmonics=True)``; slots without a kurtosis
        measurement (NaN) are never flagged.
        """
        if self.kurtosis is None:
            return np.zeros(self.idx.shape[-1], bool)
        with np.errstate(invalid="ignore"):
            return np.asarray(self.kurtosis < kurtosis_max) & np.isfinite(
                self.kurtosis
            )


def csd_matrix(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype=jnp.float32,
):
    """One-sided cross-spectral density matrix ``(freqs, gr, gi)``.

    ``records`` is ``[S, T]`` (S simultaneously sampled sensor channels);
    the result is ``gr + 1j*gi`` of shape ``[H, S, S]`` with
    ``G[f, a, b] = E[conj(X_a(f)) * X_b(f)]`` Welch-scaled to density
    units - the S x S generalization of :func:`~apda_fft_tpu.models.streaming.cross_psd`
    (same segmenting/taper/scaling conventions; diagonal equals
    ``welch_psd``).  Hermitian by construction; DC is zeroed like the rest
    of the library.  All S channels are framed and FFT'd in one batched
    dispatch and the S x S contraction over segments runs as two einsums.
    """
    records = jnp.asarray(records, dtype)
    if records.ndim != 2:
        raise ValueError(f"records must be [S, T], got shape {records.shape}")
    if records.shape[0] < 1:
        raise ValueError("need at least one sensor channel")
    if hop is not None and hop < 1:
        raise ValueError(f"hop must be >= 1 (or None for 50% overlap), got {hop}")
    hop = max(window // 2, 1) if hop is None else hop
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")
    n_fft = fft_ops.next_pow2(window)
    wsum2 = float(window) if taper == "none" else _taper_power_sum(taper, window)
    scale = jnp.asarray(2.0 / (float(np.asarray(fs)) * wsum2), records.dtype)
    gr, gi = _csd_impl(records, scale, window=window, hop=hop, taper=taper,
                       detrend=detrend)
    return _bin_freqs(fs, n_fft, dtype), gr, gi


@functools.partial(
    jax.jit, static_argnames=("window", "hop", "taper", "detrend")
)
def _csd_impl(records, scale, *, window, hop, taper, detrend):
    re, im = _segment_spectra(
        records, window=window, hop=hop, taper=taper, detrend=detrend
    )  # [S, W, H]
    w = re.shape[-2]
    s = jnp.asarray(scale / w, re.dtype)
    # G[h, a, b] = scale * mean_w conj(X_a) X_b
    #   Re = (xr_a xr_b + xi_a xi_b),  Im = (xr_a xi_b - xi_a xr_b)
    hp = jax.lax.Precision.HIGHEST  # full f32: no TF32 on a GPU
    gr = (jnp.einsum("awh,bwh->hab", re, re, precision=hp)
          + jnp.einsum("awh,bwh->hab", im, im, precision=hp)) * s
    gi = (jnp.einsum("awh,bwh->hab", re, im, precision=hp)
          - jnp.einsum("awh,bwh->hab", im, re, precision=hp)) * s
    # DC zeroed (library-wide convention; the detrend already removed it).
    return gr.at[0].set(0.0), gi.at[0].set(0.0)


def _matvec(gr, gi, vr, vi):
    """Batched Hermitian matvec ``y = G v`` in (re, im) parts, [..., S]."""
    hp = jax.lax.Precision.HIGHEST
    yr = jnp.einsum("...ab,...b->...a", gr, vr, precision=hp) - jnp.einsum(
        "...ab,...b->...a", gi, vi, precision=hp
    )
    yi = jnp.einsum("...ab,...b->...a", gr, vi, precision=hp) + jnp.einsum(
        "...ab,...b->...a", gi, vr, precision=hp
    )
    return yr, yi


def _power_top(gr, gi, iters: int):
    """Dominant eigenpair of batched Hermitian PSD ``G`` via power iteration.

    Returns ``(lam [..., ], vr [..., S], vi [..., S])`` with ``v`` unit-norm.
    The start vector is ``G @ u`` with ``u`` a fixed slightly graded real
    vector: one matvec makes the start live in the column space (so an
    exactly rank-1 G converges in a single step) and the grading breaks the
    measure-zero case of ``u`` orthogonal to the dominant eigenvector.
    """
    s = gr.shape[-1]
    u = 1.0 + jnp.arange(s, dtype=gr.dtype) / jnp.asarray(3.0 + s, gr.dtype)
    vr, vi = _matvec(gr, gi, jnp.broadcast_to(u, gr.shape[:-1]), jnp.zeros(gr.shape[:-1], gr.dtype))

    def norm(vr, vi):
        n = jnp.sqrt(jnp.sum(vr * vr + vi * vi, axis=-1, keepdims=True))
        inv = jnp.where(n > 0, 1.0 / jnp.where(n > 0, n, 1.0), 0.0)
        return vr * inv, vi * inv

    vr, vi = norm(vr, vi)

    def step(carry, _):
        vr, vi = carry
        yr, yi = _matvec(gr, gi, vr, vi)
        return norm(yr, yi), None

    (vr, vi), _ = jax.lax.scan(step, (vr, vi), None, length=iters)
    # Rayleigh quotient (real for Hermitian G): lam = v^H G v.
    yr, yi = _matvec(gr, gi, vr, vi)
    lam = jnp.sum(vr * yr + vi * yi, axis=-1)
    return lam, vr, vi


def _phase_fix(vr, vi):
    """Rotate each vector so its largest-|.| component is real positive."""
    j = jnp.argmax(vr * vr + vi * vi, axis=-1)
    pr = jnp.take_along_axis(vr, j[..., None], axis=-1)
    pi = jnp.take_along_axis(vi, j[..., None], axis=-1)
    m = jnp.sqrt(pr * pr + pi * pi)
    cr = jnp.where(m > 0, pr / jnp.where(m > 0, m, 1.0), 1.0)
    ci = jnp.where(m > 0, pi / jnp.where(m > 0, m, 1.0), 0.0)
    # v * conj(p/|p|)
    return vr * cr + vi * ci, vi * cr - vr * ci


@functools.partial(jax.jit, static_argnames=("iters",))
def sv_spectra(gr, gi, iters: int = _POWER_ITERS):
    """First two singular triplets of batched Hermitian PSD matrices.

    ``(s1, s2, vr, vi)`` with leading batch shape (one entry per frequency
    line): ``s1/s2`` the top two singular values (= eigenvalues; G is PSD)
    and ``v`` the unit first singular vector, phase-fixed.  ``s2`` comes
    from one Hotelling deflation ``G - s1 v v^H`` followed by a second
    power iteration - exact for Hermitian matrices, and the only two
    quantities FDD consumes.
    """
    s1, vr, vi = _power_top(gr, gi, iters)
    # Deflate: G' = G - s1 * v v^H  (Re: vr vr^T + vi vi^T; Im: vi vr^T - vr vi^T).
    l1 = s1[..., None, None]
    dr = gr - l1 * (vr[..., :, None] * vr[..., None, :]
                    + vi[..., :, None] * vi[..., None, :])
    di = gi - l1 * (vi[..., :, None] * vr[..., None, :]
                    - vr[..., :, None] * vi[..., None, :])
    s2, _, _ = _power_top(dr, di, iters)
    # Numerical floor: deflation roundoff can leave s2 a hair negative or
    # above s1 on rank-1 inputs; clamp into the mathematically valid band.
    s2 = jnp.clip(s2, 0.0, s1)
    vr, vi = _phase_fix(vr, vi)
    return s1, s2, vr, vi


def fdd_segments(t: int, window: int, hop: int | None = None) -> int:
    """Number of Welch segments :func:`fdd`/:func:`csd_matrix` will frame.

    The single place for the framing arithmetic, so callers (e.g. the CLI)
    can pre-check ">= 2 segments" with the SAME hop they will pass instead
    of approximating it.
    """
    hop = max(window // 2, 1) if hop is None else hop
    if t < window:
        return 0
    return (t - window) // hop + 1


@functools.partial(jax.jit, static_argnames=("window",))
def _band_kurtosis_impl(records, k_idx, n_bins, *, window):
    """Narrowband kurtosis per (mode, sensor) + band energy weights.

    ``records [S, T]``, ``k_idx [M]`` peak bin indices, ``n_bins [M]``
    half-bandwidths in bins.  Non-overlapping boxcar segments are
    band-masked in the frequency domain and synthesized back with two
    [H, window] matmuls (no complex dtype, no irfft custom call);
    kurtosis is computed over every segment sample.  Returns
    ``(kur [M, S], energy [M, S])``.
    """
    re, im = _segment_spectra(
        records, window=window, hop=window, taper="none", detrend="mean"
    )  # [S, W, H]
    h = re.shape[-1]
    n_fft = 2 * h
    k = jnp.arange(h, dtype=jnp.int32)
    # Band mask per mode: |k - k_m| <= n_bins_m, DC excluded. [M, H]
    band = (
        (jnp.abs(k[None, :] - k_idx[:, None]) <= n_bins[:, None])
        & (k[None, :] > 0)
    ).astype(re.dtype)
    mr = re[None, :, :, :] * band[:, None, None, :]  # [M, S, W, H]
    mi = im[None, :, :, :] * band[:, None, None, :]
    # Real synthesis over the un-padded sample range: x[t] = (2/N) *
    # sum_k (re cos(2 pi k t / N) - im sin(.)).  Nyquist is not in the
    # half spectrum and DC is masked, so the factor 2 is exact.
    t = jnp.arange(window, dtype=re.dtype)
    ang = (2.0 * jnp.pi / n_fft) * k.astype(re.dtype)[:, None] * t[None, :]
    hp = jax.lax.Precision.HIGHEST
    x = (
        jnp.einsum("mswh,ht->mswt", mr, jnp.cos(ang), precision=hp)
        - jnp.einsum("mswh,ht->mswt", mi, jnp.sin(ang), precision=hp)
    ) * (2.0 / n_fft)
    xm = x - jnp.mean(x, axis=(-2, -1), keepdims=True)
    m2 = jnp.mean(xm * xm, axis=(-2, -1))  # [M, S]
    m4 = jnp.mean(xm**4, axis=(-2, -1))
    tiny = jnp.asarray(np.finfo(np.float32).tiny, m2.dtype)
    kur = m4 / jnp.maximum(m2 * m2, tiny)
    return kur, m2


def harmonic_indicator(
    records,
    fs,
    freqs_hz,
    *,
    window: int = 1024,
    rel_bandwidth: float = 0.02,
    min_bins: int = 3,
    dtype=jnp.float32,
) -> np.ndarray:
    """Narrowband-kurtosis harmonic indicator per candidate frequency.

    Rotating machinery (HVAC, generators, traffic machinery) injects
    *deterministic* harmonics that output-only modal analysis happily
    identifies as structural modes - the classic OMA pitfall.  The standard
    discriminator (Brincker/Andersen/Jacobsen, "Eliminating the Influence
    of Harmonic Components in Operational Modal Analysis") is the
    probability density of the band-filtered response: a sinusoid's
    narrowband response has an arcsine density with kurtosis 1.5, a
    stochastically excited structural mode is Gaussian with kurtosis 3.0.

    ``records [S, T]`` (or ``[T]``) is band-filtered around each frequency
    in ``freqs_hz`` (half-bandwidth ``max(min_bins, rel_bandwidth * f / df)``
    bins) and the kurtosis of each sensor's filtered response is averaged
    across sensors weighted by band energy (a sensor at a node of the mode
    carries no information and would otherwise pull the estimate toward
    its noise's 3.0).  Returns ``[len(freqs_hz)]`` float64; NaN where the
    frequency is out of band or carries no energy.  Values near 1.5 flag
    harmonics, near 3.0 genuine modes - threshold midway (2.2, the
    :meth:`FDDResult.harmonic_mask` default).

    Beyond-reference capability: the reference
    (``GT_FFT_v5.py:620-679``) reports every spectral peak as-is.
    """
    records = jnp.asarray(records, dtype)
    if records.ndim == 1:
        records = records[None, :]
    if records.ndim != 2:
        raise ValueError(f"records must be [S, T] or [T], got {records.shape}")
    if window < 8:
        raise ValueError(f"window must be >= 8, got {window}")
    if records.shape[-1] < window:
        raise ValueError(
            f"record too short for kurtosis estimation: T={records.shape[-1]}"
            f" < window={window}"
        )
    if not 0.0 < rel_bandwidth < 0.5:
        raise ValueError(f"rel_bandwidth must be in (0, 0.5), got {rel_bandwidth}")
    fs = float(np.asarray(fs))
    freqs_hz = np.atleast_1d(np.asarray(freqs_hz, np.float64))
    n_fft = fft_ops.next_pow2(window)
    h = n_fft // 2
    df = fs / n_fft
    f_safe = np.where(np.isfinite(freqs_hz), freqs_hz, 0.0)
    k_idx = np.rint(f_safe / df).astype(np.int32)
    n_bins = np.maximum(min_bins, np.rint(rel_bandwidth * f_safe / df)).astype(
        np.int32
    )
    valid = (k_idx > 0) & (k_idx < h) & np.isfinite(freqs_hz)
    kur, energy = _band_kurtosis_impl(
        records,
        jnp.asarray(np.where(valid, k_idx, 1)),
        jnp.asarray(np.where(valid, n_bins, 0)),
        window=window,
    )
    kur = np.asarray(kur, np.float64)
    w = np.asarray(energy, np.float64)  # [M, S]
    tot = w.sum(axis=-1)
    out = np.full(len(freqs_hz), np.nan)
    ok = valid & (tot > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = (kur * w).sum(axis=-1) / np.where(tot > 0, tot, 1.0)
    out[ok] = avg[ok]
    return out


def _efdd_zeta(
    sv1: np.ndarray,
    vr: np.ndarray,
    vi: np.ndarray,
    i0: int,
    fs: float,
    window: int,
    mac_min: float = 0.8,
) -> float:
    """Enhanced-FDD damping (percent) for the mode peaking at bin ``i0``.

    EFDD (Brincker/Ventura/Andersen 2001): around each picked peak, the
    bins whose first singular VECTOR still matches the peak's mode shape
    (MAC >= ``mac_min``) form that mode's SDOF spectral bell; the inverse
    transform of the bell is the mode's free-decay autocorrelation, and a
    log-decrement fit of its envelope estimates damping without the
    resolution-limited bias of the half-power width.  Two refinements on
    the textbook recipe, both mattering at gateway-scale windows:

    * the bell is additionally floored at 2% of the peak's power so a
      MAC-degenerate geometry (S=1 makes MAC identically 1) cannot sweep
      unrelated spectrum into the bell;
    * Welch estimation multiplies the true autocorrelation by the
      segment-length Bartlett factor ``(1 - t/T_seg)``, which reads as
      extra damping; the fit subtracts ``log(1 - t/T_seg)`` exactly
      instead of absorbing the bias.

    Returns NaN when the fit is untrustworthy: bell narrower than 3 bins,
    fewer than 2 oscillation cycles above the fit floor, or a non-positive
    decay estimate.
    """
    h = sv1.shape[0]
    phi_r, phi_i = vr[i0], vi[i0]
    dot_r = vr @ phi_r + vi @ phi_i
    dot_i = vr @ phi_i - vi @ phi_r
    mac = dot_r * dot_r + dot_i * dot_i  # unit vectors: |<phi(f), phi0>|^2
    in_bell = (mac >= mac_min) & (sv1 >= 0.02 * sv1[i0])
    lo = i0
    while lo > 0 and in_bell[lo - 1]:
        lo -= 1
    hi = i0
    while hi < h - 1 and in_bell[hi + 1]:
        hi += 1
    if hi - lo + 1 < 3:
        return float("nan")

    bell = np.zeros(h + 1, np.float64)
    bell[lo : hi + 1] = sv1[lo : hi + 1]
    r = np.fft.irfft(bell, n=2 * h)  # modal autocorrelation, dt = 1/fs
    n = r.shape[0]

    # Analytic envelope (Hilbert via the half-spectrum trick).
    spec = np.fft.fft(r)
    spec[1 : n // 2] *= 2.0
    spec[n // 2 + 1 :] = 0.0
    env = np.abs(np.fft.ifft(spec))

    # Fit from the t=0 peak down to the 5% floor, only over the first half
    # (the irfft correlation is circular: the back half mirrors the front).
    t = np.arange(n) / fs
    t_seg = window / fs
    fit = (env > 0.05 * env[0]) & (np.arange(n) < n // 2) & (t < 0.95 * t_seg)
    if fit.sum() < 4:
        return float("nan")
    f0 = i0 * fs / (2 * h)
    if f0 <= 0 or (fit.sum() / fs) * f0 < 2.0:  # < 2 cycles above floor
        return float("nan")
    # log env = log A - zeta*w0*t + log(1 - t/T_seg)  -> subtract the known
    # Bartlett term, then ordinary least squares for the slope.  (Computed
    # on the fit window only: past t_seg the Bartlett argument is invalid,
    # and those lags are already excluded above.)
    tw = t[fit]
    yw = np.log(np.maximum(env[fit], 1e-300)) - np.log1p(-tw / t_seg)
    slope = np.polyfit(tw, yw, 1)[0]
    zeta = -slope / (2.0 * np.pi * f0)
    if not np.isfinite(zeta) or zeta <= 0:
        return float("nan")
    return 100.0 * zeta


def fdd(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    k: int | None = None,
    max_candidates: int | None = None,
    selection: str = "auto",
    iters: int = _POWER_ITERS,
    efdd: bool = False,
    harmonics: bool = False,
    dtype=jnp.float32,
    mesh=None,
    mesh_axis: str | None = None,
) -> FDDResult:
    """Frequency-Domain Decomposition over ``[S, T]`` multi-sensor records.

    CSD matrix -> per-frequency top-2 singular triplets -> the flexible
    prominence detector run on the equivalent-magnitude first-singular-value
    spectrum ``sqrt(s1(f))`` (so thresholds, shoulder rejection, 4-dp
    rounding, and the half-power damping estimate all follow the library's
    established conventions, ``utils/get_peak_prominence.py:149-226``) ->
    mode shapes gathered from the first singular vectors at the accepted
    peaks.  See the module docstring for the method and its device mapping.

    ``k`` defaults to the flexible detector's 4 slots; raise it for
    structures with more active modes in band.  Needs at least 2 segments
    (use ``window <= T // 2``); more segments average the CSD estimate
    down - the usual Welch trade-off.

    ``efdd=True`` additionally runs the enhanced-FDD damping estimator
    per accepted mode (MAC-selected SDOF bell -> modal autocorrelation ->
    Bartlett-corrected log decrement; see :func:`_efdd_zeta`), filling
    ``damping_efdd`` - usually much closer to the true damping ratio than
    the resolution-limited half-power ``damping``.

    ``harmonics=True`` additionally computes the narrowband-kurtosis
    harmonic indicator per accepted mode (see :func:`harmonic_indicator`),
    filling ``kurtosis``; :meth:`FDDResult.harmonic_mask` then flags
    machinery harmonics masquerading as structural modes.

    ``mesh`` (a ``jax.sharding.Mesh``) runs the per-bin power-iteration
    SVD SPMD with the FREQUENCY axis sharded over ``mesh_axis`` (default:
    the mesh's first axis) - each bin's eigenpair is independent, so the
    heavy ``[H, S, S]`` stage scales linearly over devices with no
    collectives; the detector then runs with the SPMD-safe selection.
    Decisions are identical to the single-device run (mesh-parity is
    asserted in tests and the multichip dryrun).
    """
    records = jnp.asarray(records, dtype)
    if records.ndim != 2:
        raise ValueError(f"records must be [S, T], got shape {records.shape}")
    if hop is not None and hop < 1:
        raise ValueError(f"hop must be >= 1 (or None for 50% overlap), got {hop}")
    n_seg = fdd_segments(records.shape[-1], window, hop)
    if n_seg < 2:
        raise ValueError(
            f"need >= 2 segments: T={records.shape[-1]} with window={window}"
        )
    if k is None:
        k = _pipeline.default_k("flexible")
    n_fft = fft_ops.next_pow2(window)
    if max_candidates is None:
        max_candidates = _pipeline.default_max_candidates(n_fft)

    freqs, gr, gi = csd_matrix(
        records, fs, window, hop, taper=taper, detrend=detrend, dtype=dtype
    )
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axis = mesh_axis or mesh.axis_names[0]
        sharding = NamedSharding(mesh, PartitionSpec(axis, None, None))
        gr = jax.device_put(gr, sharding)
        gi = jax.device_put(gi, sharding)
        if selection == "auto":
            # lax.top_k has no SPMD partitioning rule; the sharded s1
            # spectrum must keep partitionable selection ops.
            selection = "auto_spmd"
    s1, s2, vr, vi = sv_spectra(gr, gi, iters=iters)

    # Equivalent-magnitude spectrum: sqrt of the power-like s1, so the
    # detector's -3 dB half-power width (and with it the damping estimate)
    # operates on the same scale convention as a single channel's magnitude
    # spectrum.  DC is already zero.
    mags = jnp.sqrt(jnp.maximum(s1, 0.0))[None, :]
    fs_b = jnp.asarray(fs, mags.dtype).reshape(1)
    det = _pipeline._detect_from_mags(
        mags, fs_b, n_fft=n_fft, mode="flexible", k=k,
        max_candidates=max_candidates, refine=False, selection=selection,
    )

    count = int(np.asarray(det.count)[0])
    idx = np.asarray(det.idx)[0]
    s1_h, s2_h = np.asarray(s1), np.asarray(s2)
    vr_h, vi_h = np.asarray(vr), np.asarray(vi)
    valid = idx >= 0
    safe = np.where(valid, idx, 0)
    ratio = np.where(
        valid & (s1_h[safe] > 0), s2_h[safe] / np.where(s1_h[safe] > 0, s1_h[safe], 1.0), 0.0
    ).astype(s1_h.dtype)
    shape_re = np.where(valid[:, None], vr_h[safe], 0.0).astype(s1_h.dtype)
    shape_im = np.where(valid[:, None], vi_h[safe], 0.0).astype(s1_h.dtype)
    zeta_e = np.full(idx.shape, np.nan, s1_h.dtype)
    if efdd:
        fs_f = float(np.asarray(fs))
        for slot in range(count):
            zeta_e[slot] = _efdd_zeta(
                s1_h.astype(np.float64), vr_h.astype(np.float64),
                vi_h.astype(np.float64), int(idx[slot]), fs_f, window,
            )
    kurt = np.full(idx.shape, np.nan)
    if harmonics and count:
        freq_h = np.asarray(det.freq)[0]
        kurt[:count] = harmonic_indicator(
            records, fs, freq_h[:count], window=window, dtype=dtype
        )
    return FDDResult(
        count=np.asarray(det.count)[0],
        idx=idx,
        freq=np.asarray(det.freq)[0],
        damping=np.asarray(det.damping)[0],
        sv_ratio=ratio,
        shape_re=shape_re,
        shape_im=shape_im,
        freqs=np.asarray(freqs),
        sv1=s1_h,
        sv2=s2_h,
        damping_efdd=zeta_e,
        kurtosis=kurt,
    )


class ModeTrack:
    """One persistent structural mode over time (frequency + shape).

    ``ref_shape`` is the complex mode shape at track birth (the healthy
    baseline); every later observation records its MAC against that
    baseline, so a sustained MAC drop - the classic shape-based damage
    indicator, invisible to frequency-only tracking - is a first-class
    output.
    """

    def __init__(self, track_id: int, t, freq: float, shape: np.ndarray,
                 damping: float):
        self.track_id = track_id
        self.times = [t]
        self.freqs = [float(freq)]
        self.dampings = [float(damping)]
        self.ref_shape = np.asarray(shape, np.complex128)
        self.last_shape = self.ref_shape
        self.macs = [1.0]
        self.missed = 0
        self.observed = 1
        self.alerted = False  # one shape alert per track (dedup lives here,
        #: not in an unbounded caller-side set)
        self.damping_alerted = False  # same dedup policy, damping alert

    @property
    def last_freq(self) -> float:
        return self.freqs[-1]

    def sustained_mac(self, k: int = 3) -> float:
        """Median MAC of the last ``k`` observations vs the birth shape."""
        k = max(1, min(k, len(self.macs)))
        return float(np.median(self.macs[-k:]))

    def sustained_damping(self, k: int = 3) -> float:
        """Median damping (percent) of the last ``k`` observations."""
        k = max(1, min(k, len(self.dampings)))
        return float(np.median(self.dampings[-k:]))

    @property
    def birth_damping(self) -> float:
        """Damping (percent) at track birth — the healthy baseline."""
        return float(self.dampings[0])

    def damping_estimate(self, k: int | None = None) -> tuple[float, float, int]:
        """Aggregated damping over the last ``k`` observations:
        ``(mean_pct, sem_pct, n)``.

        Single-record SSI damping is variance-bound at the output-only
        information floor ``CoV ~ 1/sqrt(2 zeta w0 T)`` — ~15% per epoch at
        zeta=0.5%, f0=3 Hz, T=240 s, and a longer correlation horizon does
        NOT tighten it (measured, docs/DESIGN.md "Damping fidelity study").
        Precision comes from trend aggregation: the mean over n epochs
        shrinks the error as 1/sqrt(n) (measured sem 4.8-7.1% at n=12), so
        ~25-50 epochs reach the 2-3% band.  ``sem_pct`` is the standard
        error of that mean (0 when n < 2); NaN observations (rejected
        fits) are excluded.
        """
        d = np.asarray(self.dampings, np.float64)
        d = d[np.isfinite(d) & (d > 0)]
        if k is not None:
            d = d[-max(1, k):]
        n = d.size
        if n == 0:
            return float("nan"), float("nan"), 0
        mean = float(d.mean())
        sem = float(d.std(ddof=1) / np.sqrt(n)) if n >= 2 else 0.0
        return mean, sem, n

    def damping_windows(self, k: int = 5):
        """Disjoint (baseline, recent) damping aggregates for trend tests.

        Baseline = the first ``min(k, n//2)`` valid observations (the
        healthy condition the track was born in), recent = the last
        ``min(k, n - nb)``; each returns ``(mean_pct, sem_pct, n)``.  None
        when fewer than 2 valid observations exist.  Disjointness matters:
        overlapping windows would dilute a real rise with its own baseline.
        """
        d = np.asarray(self.dampings, np.float64)
        d = d[np.isfinite(d) & (d > 0)]
        if d.size < 2:
            return None
        nb = max(1, min(k, d.size // 2))
        nr = max(1, min(k, d.size - nb))

        def agg(x: np.ndarray):
            m = float(x.mean())
            s = float(x.std(ddof=1) / np.sqrt(x.size)) if x.size >= 2 else 0.0
            return m, s, int(x.size)

        return agg(d[:nb]), agg(d[-nr:])

    def observe(self, t, freq: float, shape: np.ndarray, damping: float,
                history_cap: int = 0) -> None:
        shape = np.asarray(shape, np.complex128)
        self.times.append(t)
        self.freqs.append(float(freq))
        self.dampings.append(float(damping))
        self.macs.append(float(modal_assurance(shape, self.ref_shape)[0, 0]))
        self.last_shape = shape
        self.missed = 0
        self.observed += 1
        if history_cap and len(self.freqs) > history_cap:
            # Trim the MIDDLE: keep the birth head (the MAC baseline's
            # context) and the recent tail - bounds months-long tracks
            # (same policy as tracking.PeakTracker).
            cut = slice(8, 9)
            del self.times[cut], self.freqs[cut], self.dampings[cut], self.macs[cut]

    def to_dict(self) -> dict:
        return {
            "track_id": self.track_id,
            "epochs": self.observed,
            "times": [float(t) for t in self.times],
            "freqs": [float(f) for f in self.freqs],
            "dampings": [float(d) for d in self.dampings],
            "macs": [float(m) for m in self.macs],
            "ref_shape": [[float(c.real), float(c.imag)] for c in self.ref_shape],
            "last_shape": [[float(c.real), float(c.imag)] for c in self.last_shape],
            "missed": self.missed,
            "alerted": self.alerted,
            "damping_alerted": self.damping_alerted,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModeTrack":
        ref = np.asarray([complex(re, im) for re, im in d["ref_shape"]])
        tr = cls(int(d["track_id"]), d["times"][0] if d.get("times") else 0,
                 d["freqs"][0], ref, d["dampings"][0])
        tr.times = list(d.get("times", [0.0] * len(d["freqs"])))
        tr.freqs = [float(f) for f in d["freqs"]]
        tr.dampings = [float(x) for x in d["dampings"]]
        tr.macs = [float(m) for m in d["macs"]]
        tr.last_shape = np.asarray(
            [complex(re, im) for re, im in d["last_shape"]]
        )
        tr.observed = int(d["epochs"])
        tr.missed = int(d.get("missed", 0))
        tr.alerted = bool(d.get("alerted", False))
        tr.damping_alerted = bool(d.get("damping_alerted", False))
        return tr

    def __len__(self) -> int:
        return len(self.freqs)


class ModalTracker:
    """Track FDD modes across epochs by frequency AND mode shape.

    Frequency-only tracking (:class:`~apda_fft_tpu.models.tracking.PeakTracker`)
    cannot follow two modes through a crossing (temperature can move close
    modes past each other) and cannot see shape change at constant
    frequency.  This tracker matches each epoch's :class:`FDDResult` modes
    to persistent :class:`ModeTrack`\\ s by a combined criterion: a pair is
    admissible iff the relative frequency distance is within ``rel_tol``
    AND the MAC against the track's birth shape is at least ``mac_min``;
    admissible pairs are taken greedily by the combined normalized
    distance, shape first (``1 - MAC`` weighted double).

    ``shape_alerts()`` lists tracks whose sustained (median-of-3) MAC vs
    their birth shape has dropped below ``mac_alert`` - the shape-based
    damage indicator.

    Host-side numpy by design (k <= a handful of modes per epoch).
    """

    #: retired tracks kept for history (oldest dropped past this)
    ARCHIVE_KEEP = 64
    #: per-archived-track observation cap (birth head 8 + recent tail)
    ARCHIVE_OBS_KEEP = 64

    def __init__(self, rel_tol: float = 0.05, mac_min: float = 0.7,
                 mac_alert: float = 0.9, max_missed: int = 5,
                 history_cap: int = 2048):
        self.rel_tol = rel_tol
        self.mac_min = mac_min
        self.mac_alert = mac_alert
        self.max_missed = max_missed
        #: per-live-track observation cap (middle-trimmed past it; 0 = off)
        self.history_cap = history_cap
        self._tracks: list[ModeTrack] = []
        self._archive: list[ModeTrack] = []
        self._next_id = 0
        self._epoch = 0

    def update(self, res, t=None) -> list[ModeTrack]:
        """Match one epoch's modes; returns the tracks matched or born.

        Accepts an :class:`FDDResult` or an
        :class:`~apda_fft_tpu.models.ssi.SSIResult` (duck-typed on the
        ``modes`` list) — SSI's pole damping is the better input for
        :meth:`damping_alerts`, FDD's shapes for :meth:`shape_alerts`.
        """
        t = self._epoch if t is None else t
        self._epoch += 1
        if hasattr(res, "modes"):  # SSIResult
            freqs = [m.freq for m in res.modes]
            shapes = [m.shape for m in res.modes]
            damps = [m.damping for m in res.modes]
            n = len(freqs)
        else:  # FDDResult
            n = int(res.count)
            freqs = [float(res.freq[i]) for i in range(n)]
            shapes = [res.shapes()[i] for i in range(n)]
            damps = [float(res.damping[i]) for i in range(n)]

        live = []
        for tr in self._tracks:
            if tr.missed < self.max_missed:
                live.append(tr)
                continue
            # Retired tracks can never grow again: trim their observation
            # lists hard and bound the archive itself (oldest out first) so
            # a months-long gateway process stays bounded.
            if len(tr.freqs) > self.ARCHIVE_OBS_KEEP:
                head, tail = 8, self.ARCHIVE_OBS_KEEP - 8
                cut = slice(head, len(tr.freqs) - tail)
                del tr.times[cut], tr.freqs[cut], tr.dampings[cut], tr.macs[cut]
            self._archive.append(tr)
        if len(self._archive) > self.ARCHIVE_KEEP:
            del self._archive[: len(self._archive) - self.ARCHIVE_KEEP]
        self._tracks = live

        # Admissible (track, mode) pairs, greedily by combined distance.
        cand: list[tuple[float, int, int]] = []
        for ti, tr in enumerate(live):
            for ni in range(n):
                df = abs(freqs[ni] - tr.last_freq)
                if tr.last_freq <= 0 or df > self.rel_tol * tr.last_freq:
                    continue
                mac = float(modal_assurance(shapes[ni], tr.ref_shape)[0, 0])
                if mac < self.mac_min:
                    continue
                score = df / (self.rel_tol * tr.last_freq) + 2.0 * (1.0 - mac)
                cand.append((score, ti, ni))
        cand.sort()
        used_t: set[int] = set()
        used_n: set[int] = set()
        out: list[ModeTrack] = []
        for _, ti, ni in cand:
            if ti in used_t or ni in used_n:
                continue
            used_t.add(ti)
            used_n.add(ni)
            live[ti].observe(t, freqs[ni], shapes[ni], damps[ni],
                             history_cap=self.history_cap)
            out.append(live[ti])
        for ti, tr in enumerate(live):
            if ti not in used_t:
                tr.missed += 1
        for ni in range(n):
            if ni not in used_n:
                tr = ModeTrack(self._next_id, t, freqs[ni], shapes[ni], damps[ni])
                self._next_id += 1
                self._tracks.append(tr)
                out.append(tr)
        return out

    def tracks(self) -> list[ModeTrack]:
        return list(self._tracks) + list(self._archive)

    def shape_alerts(self, min_epochs: int = 3) -> list[ModeTrack]:
        """Tracks whose sustained MAC vs birth shape fell below ``mac_alert``."""
        return [
            tr for tr in self._tracks
            if tr.observed >= min_epochs and tr.sustained_mac() < self.mac_alert
        ]

    def to_dict(self) -> dict:
        """JSON-serializable state (gateway restart persistence).

        The shape/damping baselines ARE the damage references: losing them
        on a process restart would silently re-baseline a degraded
        structure as healthy, so the gateway persists trackers alongside
        its drift state.
        """
        return {
            "rel_tol": self.rel_tol,
            "mac_min": self.mac_min,
            "mac_alert": self.mac_alert,
            "max_missed": self.max_missed,
            "history_cap": self.history_cap,
            "next_id": self._next_id,
            "epoch": self._epoch,
            "tracks": [tr.to_dict() for tr in self._tracks],
            "archive": [tr.to_dict() for tr in self._archive],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ModalTracker":
        mt = cls(rel_tol=float(d["rel_tol"]), mac_min=float(d["mac_min"]),
                 mac_alert=float(d["mac_alert"]),
                 max_missed=int(d["max_missed"]),
                 history_cap=int(d.get("history_cap", 2048)))
        mt._next_id = int(d["next_id"])
        mt._epoch = int(d["epoch"])
        mt._tracks = [ModeTrack.from_dict(x) for x in d.get("tracks", [])]
        mt._archive = [ModeTrack.from_dict(x) for x in d.get("archive", [])]
        return mt

    def damping_alerts(self, rel_increase: float = 0.5,
                       min_epochs: int = 5, sem_z: float = 2.0) -> list[ModeTrack]:
        """Tracks whose damping rose ≥ ``rel_increase`` AND whose rise is
        statistically resolved.

        The second classic damage/condition indicator alongside shape
        change: cracking and loosening connections typically RAISE modal
        damping well before frequency moves measurably.  Single-epoch SSI
        damping is variance-bound at the output-only information floor
        ``CoV ~ 1/sqrt(2 zeta w0 T)`` — ~15% per epoch at zeta=0.5%
        (measured, docs/DESIGN.md "Damping fidelity study" + the round-5
        50-seed bias fit) — so the trigger compares DISJOINT baseline and
        recent window means (:meth:`ModeTrack.damping_windows`) and
        additionally requires the rise to clear ``sem_z`` combined
        standard errors: ``recent - base > sem_z*sqrt(sem_b^2 + sem_r^2)``
        (a noisy epoch pair can otherwise fake a +50% rise).  Windows of
        one observation carry sem 0, degenerating to the relative test.
        A zero/invalid birth damping (FDD's rejected-width zeros) never
        alerts — feed SSI results for trustworthy damping tracking.
        """
        out = []
        for tr in self._tracks:
            if tr.observed < min_epochs or tr.birth_damping <= 0:
                continue
            w = tr.damping_windows()
            if w is None:
                continue
            (mb, sb, _), (mr, sr, _) = w
            if mr < (1.0 + rel_increase) * mb:
                continue
            if (mr - mb) <= sem_z * float(np.hypot(sb, sr)):
                continue
            out.append(tr)
        return out


def modal_assurance(a, b) -> np.ndarray:
    """Modal Assurance Criterion matrix between two shape sets.

    ``a`` is ``[ka, S]`` (or ``[S]``), ``b`` ``[kb, S]``; returns the
    ``[ka, kb]`` matrix ``|a_i^H b_j|^2 / (|a_i|^2 |b_j|^2)`` in [0, 1] -
    1 means the shapes are identical up to complex scale, ~0 orthogonal.
    The standard mode-pairing/validation statistic (host-side numpy
    utility; complex or real inputs).
    """
    a = np.atleast_2d(np.asarray(a))
    b = np.atleast_2d(np.asarray(b))
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(f"sensor counts differ: {a.shape[-1]} vs {b.shape[-1]}")
    num = np.abs(a.conj() @ b.T) ** 2
    na = np.sum(np.abs(a) ** 2, axis=-1)
    nb = np.sum(np.abs(b) ** 2, axis=-1)
    den = np.outer(na, nb)
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
