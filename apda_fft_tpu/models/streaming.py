"""Streaming epochs: frame continuous records into windows on-device.

BASELINE config 4 ("64-channel x 16-window streaming epoch, N=8192: fused
window->FFT->magnitude->peak pipeline, one XLA program"): instead of the
gateway assembling one file per acquisition, continuous per-channel records
are framed into (overlapping) windows with a gather inside the same jitted
program that analyzes them - nothing touches the host between raw record and
peak list.
"""

from __future__ import annotations

import functools
from collections import deque
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp

from apda_fft_tpu.models import pipeline as _pipeline
from apda_fft_tpu.models.pipeline import analyze_epoch
from apda_fft_tpu.models.results import EpochResult
from apda_fft_tpu.ops import fft as fft_ops


def frame_records(records: jnp.ndarray, window: int, hop: int) -> jnp.ndarray:
    """Frame ``[..., T]`` records into ``[..., W, window]`` views (strided gather).

    W = floor((T - window) / hop) + 1; windows may overlap (hop < window).
    """
    t = records.shape[-1]
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if window > t:
        raise ValueError(f"window {window} longer than record {t}")
    if hop < 1:
        raise ValueError("hop must be >= 1")
    w = (t - window) // hop + 1
    if hop == window:
        # Non-overlapping framing is a pure reshape (after trimming any
        # ragged tail) - no gather.
        trimmed = records[..., : w * window]
        return trimmed.reshape(*records.shape[:-1], w, window)
    if w <= 256:
        # Overlapping windows with statically-known starts: W contiguous
        # slices stacked - XLA lowers to copies/concats, still no gather.
        # (Unrolls W slices at trace time, so cap it; beyond the cap fall
        # back to the phase decomposition / gather below.)
        return jnp.stack(
            [records[..., s : s + window] for s in range(0, w * hop, hop)],
            axis=-2,
        )
    if window % hop == 0:
        # hop divides window (e.g. Welch's 50% overlap): the overlapping
        # framing decomposes into p = window//hop interleaved NON-overlap
        # framings, each a pure reshape - no gather.  Global frame
        # j = q*p + i is phase i's block q (start q*window + i*hop); phases
        # short by a block are zero-padded and the pad lands at j >= W, so
        # the final slice removes exactly the dummies.
        p = window // hop
        wmax = -(-w // p)
        phases = []
        for i in range(p):
            wi = (w - i + p - 1) // p
            xi = records[..., i * hop : i * hop + wi * window]
            fi = xi.reshape(*records.shape[:-1], wi, window)
            if wi < wmax:
                pad = [(0, 0)] * (fi.ndim - 2) + [(0, wmax - wi), (0, 0)]
                fi = jnp.pad(fi, pad)
            phases.append(fi)
        stacked = jnp.stack(phases, axis=-2)  # [..., wmax, p, window]
        return stacked.reshape(*records.shape[:-1], wmax * p, window)[..., :w, :]
    starts = jnp.arange(w) * hop
    idx = starts[:, None] + jnp.arange(window)[None, :]  # [W, window]
    return records[..., idx]


def analyze_stream(
    records,
    fs,
    window: int,
    hop: int | None = None,
    **kwargs,
) -> EpochResult:
    """Frame ``[C, T]`` (or ``[T]``) records and analyze every window.

    Returns an :class:`EpochResult` with batch shape ``[C, W]`` (or ``[W]``).
    ``kwargs`` pass through to :func:`analyze_epoch` (mode, backend, k, ...).
    """
    records = jnp.asarray(records)
    hop = window if hop is None else hop
    framed = frame_records(records, window, hop)
    return analyze_epoch(framed, fs, **kwargs)


DETRENDS = ("median", "mean")


def _bin_freqs(fs, n_fft: int, dtype) -> jnp.ndarray:
    """Half-spectrum bin frequencies; per-channel fs broadcasts to [..., H]."""
    fs_arr = jnp.asarray(fs, dtype)
    freqs = jnp.arange(n_fft // 2, dtype=dtype) * (fs_arr[..., None] / n_fft)
    return freqs.reshape((-1,)) if fs_arr.ndim == 0 else freqs


def _taper_power_sum(name: str, window: int) -> float:
    """sum(w_norm**2) of the coherent-gain-normalized taper, in true float64
    on the host (the jnp path would silently truncate to f32 without x64)."""
    import numpy as _np

    w = {"hann": _np.hanning, "hamming": _np.hamming, "blackman": _np.blackman}[name](window)
    w = w / w.mean()
    return float(_np.sum(w * w))


def _segment_front_end(records, *, window, hop, taper, detrend):
    """Frame -> detrend -> pad -> taper: flat segments [B, n_fft] + lead shape.

    The single implementation behind :func:`_segment_mags` (magnitudes) and
    :func:`_segment_spectra` (complex spectra) - one place for the
    detrend/pad/taper edge cases.
    """
    if window < 2:
        raise ValueError(f"window must be >= 2, got {window}")
    framed = frame_records(records, window, hop)
    n_fft = fft_ops.next_pow2(window)
    lead = framed.shape[:-1]
    flat = framed.reshape((-1, window))
    if detrend == "mean":
        segs = flat - jnp.mean(flat, axis=-1, keepdims=True)
        if window < n_fft:
            segs = jnp.pad(segs, ((0, 0), (0, n_fft - window)))
    else:
        segs = fft_ops.center_and_pad(flat, n_fft, None)
    if taper != "none":
        segs = segs * fft_ops.taper_window(
            taper, n_fft, segs.dtype, window if window < n_fft else None
        )
    return segs, lead


@functools.partial(
    jax.jit,
    static_argnames=("window", "hop", "taper", "backend", "detrend", "precision"),
)
def _segment_mags(records, *, window, hop, taper, backend, detrend="median",
                  precision="highest"):
    """Frame -> detrend -> taper -> half-spectrum magnitudes.

    The shared segment front end of :func:`spectrogram`,
    :func:`analyze_welch`, and :func:`welch_psd`; returns ``[..., W, H]``.

    ``detrend="median"`` is the reference front end's centering;
    ``"mean"`` is the scipy/Welch convention and avoids the per-segment
    sort, which otherwise dominates the front end's device time at scale
    (the two differ only in the DC-adjacent bins the taper's leakage
    reaches; DC itself is always zeroed).
    """
    segs, lead = _segment_front_end(
        records, window=window, hop=hop, taper=taper, detrend=detrend
    )
    mags = fft_ops.halfspec_magnitudes(segs, backend=backend, precision=precision)
    return mags.reshape(lead + (mags.shape[-1],))


def spectrogram(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "none",
    backend: str = "matmul",
    dtype=jnp.float32,
    detrend: str = "median",
    precision: str = "highest",
):
    """Magnitude spectrogram of ``[..., T]`` records: ``(freqs, mags)``.

    Frames records (``hop`` defaults to ``window``, non-overlapping),
    detrends each segment (``"median"`` default = reference front-end
    semantics; ``"mean"`` = scipy convention, faster - see
    :func:`_segment_mags`; DC zeroed either way), optionally tapers, and
    returns the half-spectrum magnitudes ``mags[..., W, H]`` with the bin
    frequencies ``freqs[H]`` in Hz.  The time-frequency companion of
    :func:`analyze_stream`.
    """
    records = jnp.asarray(records, dtype)
    hop = window if hop is None else hop
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")
    n_fft = fft_ops.next_pow2(window)
    return _bin_freqs(fs, n_fft, dtype), _segment_mags(
        records, window=window, hop=hop, taper=taper, backend=backend,
        detrend=detrend, precision=precision,
    )


def welch_psd(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    backend: str = "matmul",
    dtype=jnp.float32,
    detrend: str = "mean",
    precision: str = "highest",
):
    """One-sided Welch power spectral density: ``(freqs, psd)``.

    Units: ``input_units^2 / Hz`` (the engineering convention, matching
    ``scipy.signal.welch`` with the same symmetric window, segmenting, and
    the default ``detrend="mean"`` - cross-checked bin-by-bin in tests).
    ``detrend="median"`` switches to the reference front end's centering
    (differs from scipy only in the DC-adjacent bin).  The DC bin is always
    zeroed.  ``psd`` has shape ``[..., H]``; ``hop`` defaults to 50%
    overlap.
    """
    records = jnp.asarray(records, dtype)
    hop = max(window // 2, 1) if hop is None else hop
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")
    n_fft = fft_ops.next_pow2(window)
    mags = _segment_mags(
        records, window=window, hop=hop, taper=taper, backend=backend,
        detrend=detrend, precision=precision,
    )
    mean_power = jnp.mean(mags * mags, axis=-2)  # [..., H]
    # _segment_mags tapers with w/mean(w); undo that normalization and apply
    # the standard one-sided density scaling 2/(fs*sum(w^2)).  (H = n_fft/2
    # excludes the Nyquist bin; DC is zeroed upstream so its factor-2 excess
    # is moot.)
    wsum2 = float(window) if taper == "none" else _taper_power_sum(taper, window)
    fs_arr = jnp.asarray(fs, dtype)
    psd = mean_power * (2.0 / (fs_arr[..., None] * wsum2))
    return _bin_freqs(fs, n_fft, dtype), psd


@functools.partial(
    jax.jit,
    static_argnames=(
        "window", "hop", "n_fft", "mode", "k", "backend", "max_candidates",
        "refine", "taper", "selection", "detrend", "precision",
    ),
)
def _welch_impl(
    records, fs, half_corr, *, window, hop, n_fft, mode, k, backend,
    max_candidates, refine, taper, selection, detrend, precision="highest",
):
    mags = _segment_mags(
        records, window=window, hop=hop, taper=taper, backend=backend,
        detrend=detrend, precision=precision,
    )                                                    # [..., W, H]
    lead = mags.shape[:-2]
    # Welch: average segment POWER, report RMS magnitude (same scale as a
    # single segment's spectrum; the zeroed DC bin stays zero).
    avg = jnp.sqrt(jnp.mean(mags * mags, axis=-2))       # [..., H]
    avg_flat = avg.reshape((-1, avg.shape[-1]))
    fs_flat = jnp.broadcast_to(jnp.asarray(fs, avg.dtype), lead).reshape((-1,))
    corr_flat = (
        half_corr.reshape((-1, half_corr.shape[-1])) if half_corr is not None else None
    )
    res = _pipeline._detect_from_mags(
        avg_flat, fs_flat, n_fft=n_fft, mode=mode, k=k,
        max_candidates=max_candidates, refine=refine, selection=selection,
        half_corr=corr_flat,
    )
    return type(res)(*(x.reshape(lead + x.shape[1:]) for x in res))


def analyze_welch(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    mode: str = "flexible",
    k: int | None = None,
    backend: str = "matmul",
    max_candidates: int | None = None,
    refine: bool = False,
    dtype=jnp.float32,
    selection: str = "auto",
    detrend: str = "mean",
    precision: str = "highest",
) -> EpochResult:
    """Welch-averaged spectral peak detection over long records.

    Beyond-reference capability for noisy long acquisitions: frame ``[C, T]``
    (or ``[T]``) records into ``W`` (optionally overlapping) segments,
    detrend and taper each (mean detrend + hann by default - the standard
    Welch recipe), average the segment power spectra, and run the peak detector
    once per channel on the RMS-averaged magnitude spectrum.  Averaging
    shrinks the noise floor's variance by ~W while line components stay
    put, so weak tones that per-segment detection misses become clean
    peaks.  Returns an :class:`EpochResult` with batch shape ``[C]`` (or
    scalar batch ``[]`` semantics matching ``analyze_epoch`` on ``[T]``).

    ``hop`` defaults to ``window // 2`` (50% overlap, the usual Welch
    choice).  ``max_candidates`` defaults to the static
    ``default_max_candidates(n_fft)`` (averaged spectra are smooth; pass a
    larger int if ``result.n_candidates`` reports overflow).
    """
    fs_orig = fs  # pre-cast float64 rate (rigid non-dyadic wipe rounding)
    records = jnp.asarray(records, dtype)
    hop = max(window // 2, 1) if hop is None else hop
    n_fft = fft_ops.next_pow2(window)
    if mode not in ("flexible", "rigid", "adaptive"):
        raise ValueError(f"unknown mode {mode!r}")
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")
    if precision not in fft_ops.PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {fft_ops.PRECISIONS}"
        )
    if precision == "fast" and backend != "matmul":
        raise ValueError(
            'precision="fast" applies to the matmul backend only '
            f"(got backend={backend!r})"
        )
    if k is None:
        k = _pipeline.default_k(mode)
    if max_candidates is None:
        max_candidates = _pipeline.default_max_candidates(n_fft)
    half_corr = None
    if mode in ("rigid", "adaptive") and not any(
        isinstance(x, jax.core.Tracer) for x in (records, fs)
    ):
        half_corr = _pipeline._rigid_corr_batch(fs_orig, records.shape[:-1], n_fft)
    return _welch_impl(
        records, fs, half_corr, window=window, hop=hop, n_fft=n_fft, mode=mode,
        k=k, backend=backend, max_candidates=max_candidates, refine=refine,
        taper=taper, selection=selection, detrend=detrend, precision=precision,
    )




@functools.partial(
    jax.jit, static_argnames=("window", "hop", "taper", "detrend")
)
def _segment_spectra(records, *, window, hop, taper, detrend):
    """Complex half-spectra of every segment: ``(re, im)`` each [..., W, H].

    Same framing/detrend/taper conventions as :func:`_segment_mags` (DC is
    NOT zeroed here - cross-spectral estimators handle bin 0 themselves).
    """
    segs, lead = _segment_front_end(
        records, window=window, hop=hop, taper=taper, detrend=detrend
    )
    re, im = fft_ops.fft_matmul_real(segs, half=True)
    h = re.shape[-1]
    return re.reshape(lead + (h,)), im.reshape(lead + (h,))


def _cross_moments(x, y, fs, window, hop, taper, detrend, dtype, want_autos=True):
    """Shared core of :func:`cross_psd` / :func:`coherence`.

    Validates, stacks the pair into ONE jitted :func:`_segment_spectra`
    dispatch (halving program launches), and returns the Welch-averaged
    second moments ``(pxx, pyy, pr, pi, n_fft)`` with the cross terms in
    scipy's ``conj(X) * Y`` sign convention.  ``want_autos=False`` skips
    the auto-spectra (cross_psd discards them; this math runs outside jit
    so skipping is a real saving), returning None in their slots.
    """
    x = jnp.asarray(x, dtype)
    y = jnp.asarray(y, dtype)
    if x.shape != y.shape:
        raise ValueError(f"x and y shapes differ: {x.shape} vs {y.shape}")
    hop = max(window // 2, 1) if hop is None else hop
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if detrend not in DETRENDS:
        raise ValueError(f"unknown detrend {detrend!r}; expected one of {DETRENDS}")
    n_fft = fft_ops.next_pow2(window)
    re, im = _segment_spectra(
        jnp.stack([x, y]), window=window, hop=hop, taper=taper, detrend=detrend
    )
    (xr, yr), (xi, yi) = re, im
    pxx = jnp.mean(xr * xr + xi * xi, axis=-2) if want_autos else None
    pyy = jnp.mean(yr * yr + yi * yi, axis=-2) if want_autos else None
    pr = jnp.mean(xr * yr + xi * yi, axis=-2)
    pi = jnp.mean(xr * yi - xi * yr, axis=-2)
    return pxx, pyy, pr, pi, n_fft


def cross_psd(
    x,
    y,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype=jnp.float32,
):
    """One-sided cross power spectral density ``(freqs, pxy)``.

    Welch-averaged ``E[conj(X(f)) * Y(f)]`` (the scipy sign convention:
    positive phase = ``y`` leads ``x``) with the same segmenting,
    symmetric-window, and scaling conventions as :func:`welch_psd`
    (cross-checked against ``scipy.signal.csd`` incl. phase).
    ``x``/``y`` are ``[..., T]`` records with matching shapes.

    Returns ``pxy`` as a HOST numpy complex array (not jittable: the
    device math is kept all-real, and the complex view is assembled on the
    host).
    """
    _, _, pr, pi, n_fft = _cross_moments(
        x, y, fs, window, hop, taper, detrend, dtype, want_autos=False
    )
    wsum2 = float(window) if taper == "none" else _taper_power_sum(taper, window)
    fs_arr = jnp.asarray(fs, dtype)
    scale = 2.0 / (fs_arr[..., None] * wsum2)
    import numpy as _np

    pxy = _np.asarray(pr * scale) + 1j * _np.asarray(pi * scale)
    pxy[..., 0] = 0.0  # DC zeroed, matching welch_psd
    return _bin_freqs(fs, n_fft, dtype), pxy


def coherence(
    x,
    y,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype=jnp.float32,
):
    """Magnitude-squared coherence ``(freqs, cxy)`` in [0, 1].

    ``|Pxy|^2 / (Pxx * Pyy)`` with Welch averaging (matching
    ``scipy.signal.coherence``): ~1 where the two channels see the same
    (linearly related) signal, ~0 where they are independent - the
    multi-sensor test for "is this the same structural mode?".  Requires
    overlap-averaging over several segments (single-segment coherence is
    identically 1).
    """
    freqs, cxy, _ = coherence_with_phase(
        x, y, fs, window, hop, taper=taper, detrend=detrend, dtype=dtype
    )
    return freqs, cxy


def coherence_with_phase(
    x,
    y,
    fs,
    window: int,
    hop: int | None = None,
    *,
    taper: str = "hann",
    detrend: str = "mean",
    dtype=jnp.float32,
):
    """Coherence plus cross-spectral phase from ONE segment-FFT pass.

    ``(freqs, cxy, phase_deg)``: the coherent-band question ("same mode?")
    and the mode-shape sign/lag question ("at what phase?") usually come
    together, and answering them via separate :func:`coherence` +
    :func:`cross_psd` calls segments and FFTs both channels twice.  Phase
    is scale-invariant, so the unscaled cross moments carry it directly
    (scipy's ``conj(X)*Y`` sign convention: positive = ``y`` leads ``x``).
    """
    pxx, pyy, pr, pi, n_fft = _cross_moments(
        x, y, fs, window, hop, taper, detrend, dtype
    )
    denom = pxx * pyy
    cxy = jnp.where(denom > 0, (pr * pr + pi * pi) / jnp.where(denom > 0, denom, 1.0), 0.0)
    cxy = cxy.at[..., 0].set(0.0)
    phase_deg = jnp.degrees(jnp.arctan2(pi, pr))
    return _bin_freqs(fs, n_fft, dtype), cxy, phase_deg


def analyze_epochs_pipelined(
    epochs: Iterable,
    fs,
    *,
    depth: int = 4,
    mode: str = "flexible",
    n_fft: int | None = None,
    analyze=analyze_epoch,
    **kwargs,
) -> Iterator[EpochResult]:
    """Analyze a stream of epochs with up to ``depth`` dispatches in flight.

    The dynamic candidate budget's exactness contract normally costs one
    *blocking* scalar readback per epoch (``analyze_epoch``'s overflow
    check), which serializes host dispatch across epochs.  This generator
    defers that check: each epoch is dispatched immediately with the sticky
    budget (async, no readback), and the overflow validation happens only
    when its result is yielded - re-running just the rare overflowing epoch
    with a larger budget, exactly like the sequential dynamic loop.  Results
    are yielded in input order and are decision-identical to calling
    :func:`analyze_epoch` per epoch (the budget only sizes the scan stage;
    validated decisions never depend on it).

    The sticky per-``(n_fft, mode)`` budget table is shared with
    ``analyze_epoch``; in-flight epochs may use a budget up to ``depth``
    epochs stale, which costs at most an extra re-run, never exactness.

    Args:
      epochs: iterable of ``[..., L]`` sample arrays (one epoch each).
      fs: sampling rate, shared by the stream (scalar or broadcastable).
      depth: max epochs in flight (1 = sequential-but-deferred).
      mode: ``"flexible"`` or ``"rigid"`` (``"adaptive"``'s per-window
        fallback needs an immediate readback - use ``analyze_epoch``).
      n_fft: optional fixed FFT length; default per-epoch ``next_pow2(L)``.
      analyze: the epoch function (default :func:`analyze_epoch`); pass
        e.g. ``functools.partial(analyze_epoch_sharded, mesh=mesh)`` to
        pipeline mesh-sharded epochs.
      **kwargs: forwarded to ``analyze`` (backend, k, refine, ...).
        ``max_candidates`` is managed here and rejected.
    """
    # Validate eagerly (this is a plain function returning a generator, so
    # misconfiguration fails at the call site, not at the first next()).
    if mode not in ("flexible", "rigid"):
        raise ValueError(
            f"pipelined analysis supports 'flexible' or 'rigid', got {mode!r}"
        )
    if "max_candidates" in kwargs:
        raise ValueError(
            "analyze_epochs_pipelined manages the candidate budget; pin one "
            "via analyze_epoch instead"
        )
    if "lengths" in kwargs:
        raise ValueError(
            "a stream-wide lengths array would misapply to every epoch; use "
            "analyze_records for ragged records"
        )
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dtype = kwargs.get("dtype", jnp.float32)

    def dispatch(samples):
        samples = jnp.asarray(samples, dtype)
        nf = n_fft if n_fft is not None else fft_ops.next_pow2(samples.shape[-1])
        h = max(nf // 2, 1)
        key = (nf, mode)
        if mode == "rigid":
            budget = _pipeline._DYNAMIC_FLOOR  # unused by the rigid detector
        else:
            budget = min(
                _pipeline._dynamic_budget.get(key, _pipeline._DYNAMIC_FLOOR), h
            )
        res = analyze(
            samples, fs, n_fft=nf, mode=mode, max_candidates=budget, **kwargs
        )
        return samples, nf, h, key, budget, res

    def finalize(item) -> EpochResult:
        samples, nf, h, key, budget, res = item
        if mode == "rigid" or res.n_candidates.size == 0:
            return res
        # Exactness criterion: every window's greedy walk either completed
        # within the budget prefix or saw all its candidates (n_required <=
        # budget) - see EpochResult.n_required.
        n_req = int(jax.device_get(jnp.max(res.n_required)))
        while n_req > budget and budget < h:
            budget = min(
                max(
                    _pipeline._pow2_at_least(n_req),
                    _pipeline._dynamic_budget_hwm.get(key, 0),
                    _pipeline._DYNAMIC_FLOOR,
                ),
                h,
            )
            res = analyze(
                samples, fs, n_fft=nf, mode=mode, max_candidates=budget, **kwargs
            )
            n_req = int(jax.device_get(jnp.max(res.n_required)))
        _pipeline._dynamic_budget[key] = min(
            max(_pipeline._pow2_at_least(n_req), _pipeline._DYNAMIC_FLOOR), h
        )
        _pipeline._dynamic_budget_hwm[key] = max(
            _pipeline._dynamic_budget_hwm.get(key, 0), budget
        )
        return res

    def generate():
        pending: deque = deque()
        for samples in epochs:
            if len(pending) >= depth:
                yield finalize(pending.popleft())
            pending.append(dispatch(samples))
        while pending:
            yield finalize(pending.popleft())

    return generate()
