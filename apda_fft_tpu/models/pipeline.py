"""The epoch batch pipeline - one XLA program per acquisition epoch.

This is the batched replacement for the reference's per-file workflow
(``GT_FFT_v5.py:620-679``: load file -> ``start_fft`` -> one of two peak
pickers -> metrics bookkeeping).  Instead of one Python loop per sensor file,
an *epoch* of windows ``[..., N]`` is analyzed by a single jitted program:

    center(median) -> pad -> FFT -> |.| half-spectrum -> adaptive peak detect

with everything vmapped over the window batch and no host round-trips.

``mode="flexible"`` selects the prominence detector (footbridges etc.),
``mode="rigid"`` the resolution detector (tunnels etc.), mirroring the
``is_flexibile_structure`` config switch (``GT_FFT_v5.py:639-642``).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from apda_fft_tpu.models.results import EpochResult
from apda_fft_tpu.ops import fft as fft_ops
from apda_fft_tpu.ops.peaks_prominence import prominence_peaks
from apda_fft_tpu.ops.peaks_resolution import resolution_peaks

MODES = ("flexible", "rigid", "adaptive")


def default_k(mode: str) -> int:
    """Reference defaults: top-4 in flexible/adaptive mode, top-5 in rigid mode."""
    return 5 if mode == "rigid" else 4


def default_max_candidates(n_fft: int) -> int:
    """Static candidate budget scaled to spectrum size.

    Noise-dominated spectra have ~1-2% of bins as threshold-crossing local
    maxima, so a fixed budget truncates on long windows (measured: 56-114
    candidates at H=4096, where 32 dropped real peaks).  H/64 with a floor of
    32 and a cap of 512 keeps every tested corpus exact while leaving the
    N<=4096 fast path untouched.

    This is the fallback when the dynamic budget (the default) cannot run -
    i.e. when ``analyze_epoch`` is called under an outer ``jit`` trace where
    the candidate count cannot be read back.  Note pure-noise windows can
    exceed it even at N=4096 (measured up to 90 threshold-crossing maxima at
    H=2048); the dynamic budget handles those exactly.
    """
    return max(32, min(512, (n_fft // 2) // 64))


#: Sticky per-(n_fft, mode) dynamic candidate budgets (power-of-two bucketed
#: so the number of distinct compiled programs stays <= log2(H)).  The floor
#: is 2: a clean two-mode window needs exactly that, and the detector's scans
#: cost O(M*H) per window, so each halving of the budget halves them.  The
#: budget follows the last epoch's count, so workloads alternating
#: quiet/noisy epochs on the same key pay one extra *small-budget* pass per
#: upward transition (cheaper than running quiet epochs at the noisy
#: budget); the overflow re-run jumps straight to the key's high-water mark
#: so repeated growth steps are never paid.
_dynamic_budget: dict[tuple[int, str], int] = {}
_dynamic_budget_hwm: dict[tuple[int, str], int] = {}
#: Sticky per-(n_fft, mode) two-tier split, or absent for a flat budget.
#: Value ``(m_small, s_cap)``: the dynamic path runs the whole epoch at the
#: small budget and re-detects only the <= s_cap windows whose greedy walk
#: self-reports ``n_required > m_small`` at the full budget, inside the same
#: program (no extra readback).  Learned from the per-grid n_required counts
#: of the last exact epoch; any tier failure falls back to a flat re-run.
#: The grid and the straggler capacity were tuned on the earlier chip and
#: have not been re-tuned for the GPU (ROADMAP S4).
_dynamic_tier: dict[tuple[int, str], tuple[int, int]] = {}
#: m_small candidates: powers of two plus 1.5x points - two per octave keeps
#: the compile-cache bounded while letting the split land near the measured
#: optimum (12 beats both 8 and 16 on the reference noisy corpus).
_TIER_GRID = (4, 6, 8, 12, 16, 24, 32, 48, 64)
#: Observability: stats of the most recent dynamic-budget run on this
#: *thread* (budget used, true candidate max, number of passes).  Read by
#: SpectralPipeline into ``last_metrics``; thread-local so concurrent
#: pipelines cannot cross-contaminate each other's metrics.
_dynamic_tls = threading.local()


def last_dynamic_stats() -> dict:
    d = getattr(_dynamic_tls, "stats", None)
    if d is None:
        d = _dynamic_tls.stats = {}
    return d


_DYNAMIC_FLOOR = 2


def _is_multidevice(x) -> bool:
    """True when ``x`` is committed across more than one device (sharded)."""
    sharding = getattr(x, "sharding", None)
    return sharding is not None and len(sharding.device_set) > 1


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def _effective_mc(
    budget: int, h: int, n_windows: int, tier: tuple[int, int] | None
) -> int | tuple[int, int, int]:
    """The impl budget for one dynamic pass: the flat int, or the two-tier
    ``(m_small, m_big, s_cap)`` when a learned split applies.  Never tiers at
    ``budget == h``: a flat run there is unconditionally exact while a tiered
    one can still overflow its straggler capacity (the dynamic loop's
    ``budget >= h`` exit assumes exactness)."""
    if (
        tier is not None
        and tier[0] * 2 <= budget
        and budget < h
        and n_windows >= 4 * min(tier[1], n_windows)
    ):
        return (tier[0], budget, tier[1])
    return budget


def steady_state_max_candidates(
    n_fft: int, mode: str, n_windows: int
) -> int | tuple[int, int, int]:
    """What the dynamic budget would run for the next ``n_windows``-window
    epoch on ``(n_fft, mode)`` - the flat int budget or the two-tier split.

    For benchmarks/tools that pin the steady-state program after a warmup
    epoch (e.g. ``bench.py``), so the measured XLA program is exactly the one
    a long-running gateway executes."""
    h = max(n_fft // 2, 1)
    key = (n_fft, mode)
    budget = min(_dynamic_budget.get(key, _DYNAMIC_FLOOR), h)
    return _effective_mc(budget, h, n_windows, _dynamic_tier.get(key))


def _tier_capacity(b: int) -> int:
    """Straggler capacity for a ``b``-window epoch: pow2(b/16) in [32, 512].

    Sized so the learning rule's ``count <= s_cap // 2`` headroom makes
    epoch-to-epoch capacity overflow rare (measured: need-counts are stable
    within ~2x across seeds and noise levels - docs/DESIGN.md) while the big
    pass stays a small fraction of the epoch.
    """
    return max(32, min(512, _pow2_at_least(b // 16)))


def refine_subbin(mags: jnp.ndarray, idx: jnp.ndarray, ds: jnp.ndarray) -> jnp.ndarray:
    """Sub-bin frequency via parabolic interpolation on the magnitude spectrum.

    An extension beyond the reference (high-resolution modal analysis): fit a
    parabola through (idx-1, idx, idx+1) magnitudes; vertex offset
    ``0.5*(m[-1]-m[+1]) / (m[-1]-2*m[0]+m[+1])`` in bins, clamped to +-0.5.
    Empty slots (idx < 0) return 0.
    """
    h = mags.shape[-1]
    safe = jnp.clip(idx, 1, h - 2)
    # One-hot masked reductions instead of three jnp.take: a k-element
    # gather from [H] lowers to scalarized element access per window under
    # vmap (docs/DESIGN.md "Gather-free candidate extraction"); clip keeps
    # safe-1/safe+1 in range so each mask hits exactly one bin (exact sum).
    iota = jnp.arange(h)
    zeros = jnp.zeros_like(mags)

    def pick(offset):
        hit = iota[None, :] == (safe[:, None] + offset)
        return jnp.sum(jnp.where(hit, mags[None, :], zeros[None, :]), axis=-1)

    m0, m1, m2 = pick(-1), pick(0), pick(1)
    denom = m0 - 2.0 * m1 + m2
    delta = jnp.where(jnp.abs(denom) > 1e-30, 0.5 * (m0 - m2) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    refined = (safe.astype(mags.dtype) + delta) * ds
    return jnp.where(idx >= 0, refined, 0.0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_fft",
        "mode",
        "k",
        "backend",
        "max_candidates",
        "refine",
        "has_lengths",
        "center",
        "selection",
        "batch_chunk",
        "taper",
        "precision",
    ),
)
def _analyze_epoch_impl(
    samples: jnp.ndarray,
    fs: jnp.ndarray,
    lengths: jnp.ndarray | None,
    half_corr: jnp.ndarray | None = None,
    *,
    n_fft: int,
    mode: str,
    k: int,
    backend: str,
    max_candidates: int | tuple[int, int, int],
    refine: bool,
    has_lengths: bool,
    center: str = "auto",
    selection: str = "auto",
    batch_chunk: int = 2048,
    taper: str = "none",
    precision: str = "highest",
) -> EpochResult:
    lead = samples.shape[:-1]
    flat = samples.reshape((-1, samples.shape[-1]))
    fs_flat = jnp.broadcast_to(fs, lead).reshape((-1,)).astype(flat.dtype)
    len_flat = lengths.reshape((-1,)) if has_lengths else None
    corr_flat = (
        half_corr.reshape((-1, half_corr.shape[-1])) if half_corr is not None else None
    )

    # Very large epochs are processed in fixed-size chunks with lax.map -
    # still one XLA program - so the detector's [B, M, H] working set stays
    # bounded at any epoch size.  The 2048-window chunk was chosen on the
    # earlier chip and has not been re-tuned for the GPU (ROADMAP S3).
    b = flat.shape[0]
    if batch_chunk and b > batch_chunk:
        pad = (-b) % batch_chunk
        if pad:
            flat = jnp.pad(flat, ((0, pad), (0, 0)))
            fs_flat = jnp.pad(fs_flat, ((0, pad),), constant_values=1.0)
            if len_flat is not None:
                len_flat = jnp.pad(len_flat, ((0, pad),), constant_values=n_fft)
            if corr_flat is not None:
                corr_flat = jnp.pad(corr_flat, ((0, pad), (0, 0)))
        nc = flat.shape[0] // batch_chunk

        def chunk_fn(args):
            cs, cf, cl, cc = args
            return _analyze_epoch_impl(
                cs, cf, cl, cc, n_fft=n_fft, mode=mode, k=k, backend=backend,
                max_candidates=max_candidates, refine=refine,
                has_lengths=has_lengths, center=center, selection=selection,
                batch_chunk=0, taper=taper, precision=precision,
            )

        chunked = (
            flat.reshape(nc, batch_chunk, flat.shape[-1]),
            fs_flat.reshape(nc, batch_chunk),
            len_flat.reshape(nc, batch_chunk) if len_flat is not None else None,
            corr_flat.reshape(nc, batch_chunk, corr_flat.shape[-1])
            if corr_flat is not None else None,
        )
        res = jax.lax.map(chunk_fn, chunked)
        return EpochResult(
            *(x.reshape((-1,) + x.shape[2:])[:b].reshape(lead + x.shape[2:]) for x in res)
        )

    if center == "auto" and not has_lengths and flat.shape[-1] == n_fft:
        # Full, unpadded windows: subtracting a constant changes only the DC
        # bin of the transform - which is zeroed anyway (fft_iterativa.py:85)
        # - so the sort-based *median* is skipped.  The cheap *mean* is still
        # subtracted: in float32 a large raw DC offset (gravity counts) would
        # otherwise inject offset-scale roundoff into every bin; after mean
        # removal the residual constant (median - mean) is signal-scale and
        # its roundoff is of the same order as the FFT's own.  With
        # zero-padding the median subtraction is load-bearing (the pad stays
        # 0) and the full path below runs.  Pass center="always" to force it.
        # Under a taper the subtracted constant leaks into the DC-adjacent
        # bins via FFT(taper), so median-vs-mean is no longer DC-only
        # there; the shortcut's mean detrend is the standard windowed-
        # analysis convention (scipy/Welch) and runs ~7x faster than the
        # median sort at B=2048/N=4096 - center="always" restores the
        # reference-style median under a taper at that cost.
        windows = flat - jnp.mean(flat, axis=-1, keepdims=True)
    else:
        windows = fft_ops.center_and_pad(flat, n_fft, len_flat)
    if taper != "none":
        # Applied after centering (the zero-padded tail stays zero either
        # way); amplitude-normalized so peak magnitudes keep the reference
        # scale for on-bin tones.  The taper spans the DATA (valid prefix /
        # pre-pad length), not the padded n_fft.
        tlen = len_flat if len_flat is not None else (
            flat.shape[-1] if flat.shape[-1] < n_fft else None
        )
        windows = windows * fft_ops.taper_window(
            taper, windows.shape[-1], windows.dtype, tlen
        )
    mags = fft_ops.halfspec_magnitudes(windows, backend=backend, precision=precision)

    return EpochResult(
        *(x.reshape(lead + x.shape[1:]) for x in _detect_from_mags(
            mags, fs_flat, n_fft=n_fft, mode=mode, k=k,
            max_candidates=max_candidates, refine=refine, selection=selection,
            half_corr=corr_flat,
        ))
    )


def _rigid_corr_batch(fs_orig, lead, n_fft: int):
    """Per-window non-dyadic wipe-rounding tables, ``[*lead, ceil(H/50)]`` int8.

    Host-side companion of the rigid detector for arbitrary sampling rates:
    broadcasts the ORIGINAL (pre-float32-cast) rates over the batch shape and
    computes :func:`~apda_fft_tpu.ops.peaks_resolution.rigid_half_corrections`
    once per distinct rate.  Returns None when every table is empty - the
    dyadic case, which therefore compiles the exact same program as before
    this feature existed.
    """
    import numpy as np

    from apda_fft_tpu.ops.peaks_resolution import rigid_half_corrections

    h = n_fft // 2
    hq = len(range(25, h, 50))
    if hq == 0:
        return None
    fs_host = np.broadcast_to(
        np.asarray(jax.device_get(fs_orig), np.float64), lead
    ).reshape(-1)
    tables: dict[float, object] = {}
    out = None
    for i, v in enumerate(fs_host):
        key = float(v)
        if key not in tables:
            tables[key] = rigid_half_corrections(key, n_fft)
        c = tables[key]
        if c is not None:
            if out is None:
                out = np.zeros((fs_host.size, hq), np.int8)
            out[i] = c
    return out.reshape(tuple(lead) + (hq,)) if out is not None else None


def _flex_detect(
    mags: jnp.ndarray,
    fs_flat: jnp.ndarray,
    *,
    n_fft: int,
    k: int,
    max_candidates: int | tuple[int, int, int],
    selection: str = "auto",
):
    """Flexible-detector stage over a flat ``[B, H]`` batch.

    ``max_candidates`` is either a flat int budget, or the private two-tier
    split ``(m_small, m_big, s_cap)``: detect every window at ``m_small``,
    gather the <= ``s_cap`` windows whose walk self-reports
    ``n_required > m_small``, re-detect only those at ``m_big``, and
    scatter-merge - one program, no host readback.  Exactness bookkeeping
    rides the merged ``n_required``: a window the capacity could not re-run
    reports ``max(its pre-budget count, m_big + 1)``, so the dynamic loop's
    ``n_required <= budget`` check fails and triggers the flat re-run (a
    too-small report would silently claim exactness - see
    tests/test_two_tier.py).  The noisy-corpus win comes from the detector's
    O(M*H) scans running at M=m_small for ~95% of windows (docs/DESIGN.md
    "Two-tier candidate budget").
    """

    def flat_detect(m_b, f_b, budget: int):
        return jax.vmap(
            lambda m, f: prominence_peaks(
                m, f, n_fft, k=k, max_candidates=budget, selection=selection
            )
        )(m_b, f_b)

    if not isinstance(max_candidates, tuple):
        return flat_detect(mags, fs_flat, max_candidates)

    m_small, m_big, s_cap = max_candidates
    b = mags.shape[0]
    s_eff = min(s_cap, b)
    # Not worth a second pass: split no smaller than the budget, or batch too
    # small to amortize the gather/scatter around the straggler re-run.
    if m_small >= m_big or b < 4 * s_eff:
        return flat_detect(mags, fs_flat, m_big)

    r1 = flat_detect(mags, fs_flat, m_small)
    # n_required > m_small iff the walk did not complete within the small
    # budget's slot prefix (completed walks consume <= m_small slots), i.e.
    # the window's decisions are not yet reference-exact.
    need = r1.n_required > m_small
    # Stable sort: straggler indices first (ascending), clean windows after.
    order = jnp.argsort(jnp.logical_not(need), stable=True)
    sel = order[:s_eff]
    use2 = need[sel]
    r2 = flat_detect(mags[sel], fs_flat[sel], m_big)

    def merge(a1, a2):
        u = use2.reshape((s_eff,) + (1,) * (a2.ndim - 1))
        return a1.at[sel].set(jnp.where(u, a2, a1[sel]))

    merged = type(r1)(*(merge(a1, a2) for a1, a2 in zip(r1, r2)))
    # Capacity overflow: stragglers past s_eff still hold their (possibly
    # wrong) small-budget decisions.  Their pass-1 n_required is the true
    # pre-budget candidate count, which can be <= m_big - force it past the
    # budget so the exactness check cannot be satisfied by accident.
    selmask = jnp.zeros((b,), bool).at[sel].set(True)
    overflowed = need & jnp.logical_not(selmask)
    n_req = jnp.where(
        overflowed, jnp.maximum(merged.n_required, m_big + 1), merged.n_required
    )
    return merged._replace(n_required=n_req)


def _detect_from_mags(
    mags: jnp.ndarray,
    fs_flat: jnp.ndarray,
    *,
    n_fft: int,
    mode: str,
    k: int,
    max_candidates: int | tuple[int, int, int],
    refine: bool,
    selection: str = "auto",
    half_corr: jnp.ndarray | None = None,
) -> EpochResult:
    """Run the detector + finalize stage on precomputed half-spectrum
    magnitudes ``[B, H]`` (flat batch).  Shared by the epoch pipeline and
    the Welch-averaged path (``models.streaming.analyze_welch``).
    ``half_corr`` is the optional per-window ``[B, ceil(H/50)]`` non-dyadic
    wipe-rounding table (:func:`~apda_fft_tpu.ops.peaks_resolution.rigid_half_corrections`),
    used by the rigid/adaptive detector only."""

    def _rigid(m_b, f_b):
        if half_corr is None:
            return jax.vmap(lambda m, f: resolution_peaks(m, f, n_fft, k=k))(m_b, f_b)
        return jax.vmap(
            lambda m, f, c: resolution_peaks(m, f, n_fft, k=k, half_corr=c)
        )(m_b, f_b, half_corr)

    if mode == "flexible":
        det = _flex_detect(
            mags, fs_flat, n_fft=n_fft, k=k, max_candidates=max_candidates,
            selection=selection,
        )
        prom, damp, qf = det.prominence, det.damping, det.q_factor
        n_cand = det.n_candidates
        n_req = det.n_required
    elif mode == "rigid":
        det = _rigid(mags, fs_flat)
        zeros = jnp.zeros_like(det.freq)
        prom, damp, qf = zeros, zeros, zeros
        n_cand = det.n_candidates
        n_req = jnp.zeros_like(n_cand)
    elif mode == "adaptive":
        # Adaptive prominence + resolution fallback (BASELINE config 2): the
        # prominence detector's damping band can reject everything on very
        # sharp or very broad spectra; windows it leaves empty fall back to
        # the resolution detector, per window, inside the same program.
        flex = _flex_detect(
            mags, fs_flat, n_fft=n_fft, k=k, max_candidates=max_candidates,
            selection=selection,
        )
        rig = _rigid(mags, fs_flat)
        use_flex = (flex.count > 0)[:, None]
        zeros = jnp.zeros_like(flex.freq)
        det = flex._replace(
            count=jnp.where(flex.count > 0, flex.count, rig.count),
            idx=jnp.where(use_flex, flex.idx, rig.idx),
            freq=jnp.where(use_flex, flex.freq, rig.freq),
            mag=jnp.where(use_flex, flex.mag, rig.mag),
        )
        prom = jnp.where(use_flex, flex.prominence, zeros)
        damp = jnp.where(use_flex, flex.damping, zeros)
        qf = jnp.where(use_flex, flex.q_factor, zeros)
        n_cand = flex.n_candidates
        n_req = flex.n_required  # the rigid fallback has no budget to size
    else:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")

    if refine:
        ds = fs_flat / jnp.asarray(n_fft, mags.dtype)
        refined = jax.vmap(refine_subbin)(mags, det.idx, ds)
    else:
        refined = jnp.zeros_like(det.freq)

    return EpochResult(
        count=det.count,
        idx=det.idx,
        freq=det.freq,
        mag=det.mag,
        prominence=prom,
        damping=damp,
        q_factor=qf,
        refined_freq=refined,
        n_candidates=n_cand,
        n_required=n_req,
    )


@functools.lru_cache(maxsize=256)
def _detect_jit(n_fft: int, mode: str, k: int, mc, refine: bool, selection: str):
    """Cached jitted detector stage (one executable per static signature;
    mc is the flat int budget or the two-tier tuple)."""
    return jax.jit(functools.partial(
        _detect_from_mags, n_fft=n_fft, mode=mode, k=k, max_candidates=mc,
        refine=refine, selection=selection,
    ))


def detect_from_mags(
    mags,
    fs,
    *,
    n_fft: int,
    mode: str = "flexible",
    k: int | None = None,
    max_candidates: int | str | None = None,
    refine: bool = True,
    selection: str = "auto",
) -> EpochResult:
    """Detector + finalize stage over precomputed half-spectrum magnitudes.

    The flagship composition for sequence-parallel meshes: feed
    ``parallel.distributed_fft.distributed_halfspec_magnitudes`` output
    (``[B, H]``, sharded or not) here to run the SAME refined,
    dynamic-budget detector the single-device pipeline runs (BASELINE
    cfg2/cfg5) on top of the all_to_all FFT - ``max_candidates`` None /
    ``"dynamic"`` engages the sticky-budget overflow loop
    (:func:`_run_dynamic`, shared tables with :func:`analyze_epoch`), an
    int pins a static budget.  Multi-device inputs keep their sharding;
    the budget readback uses collective-free per-shard ``device_get``.

    ``mags`` must be the un-normalized half-spectrum magnitudes
    (``|FFT|[:, :n_fft//2]``, DC zeroed) the pipeline's front end produces.
    The rigid non-dyadic wipe-correction table is not applied on this
    surface (dyadic rates are exact; non-dyadic rates use the banker's
    snap, as under an outer trace).
    """
    mags = jnp.asarray(mags)
    if mags.ndim != 2:
        raise ValueError(f"mags must be [B, H], got shape {mags.shape}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if k is None:
        k = default_k(mode)
    fs_flat = jnp.broadcast_to(
        jnp.asarray(fs, mags.dtype), mags.shape[:1]
    )
    traced = isinstance(mags, jax.core.Tracer) or isinstance(fs_flat, jax.core.Tracer)
    dynamic = (
        max_candidates in (None, "dynamic")
        and mode in ("flexible", "adaptive")
        and not traced
        and mags.shape[0] > 0
    )
    if max_candidates == "dynamic" and traced:
        raise ValueError("max_candidates='dynamic' cannot run under an outer jit trace")
    if not dynamic:
        if not isinstance(max_candidates, int):
            max_candidates = default_max_candidates(n_fft)
        return _detect_jit(n_fft, mode, k, max_candidates, refine, selection)(
            mags, fs_flat
        )
    return _run_dynamic(
        lambda mc: _detect_jit(n_fft, mode, k, mc, refine, selection)(mags, fs_flat),
        n_fft=n_fft, mode=mode, n_windows=mags.shape[0],
    )


def analyze_epoch(
    samples,
    fs,
    *,
    n_fft: int | None = None,
    mode: str = "flexible",
    k: int | None = None,
    backend: str = "matmul",
    max_candidates: int | str | None = None,
    refine: bool = False,
    lengths=None,
    dtype=jnp.float32,
    center: str = "auto",
    selection: str = "auto",
    batch_chunk: int = 2048,
    taper: str = "none",
    precision: str = "highest",
) -> EpochResult:
    """Analyze one epoch of sensor windows in a single XLA program.

    Args:
      samples: ``[..., L]`` real acceleration windows (any leading batch shape,
        e.g. ``[channels, windows, L]``).
      fs: sampling rate in Hz - scalar or broadcastable to the batch shape.
      n_fft: FFT length (power of two). Defaults to ``next_pow2(L)``, matching
        the reference's pad-to-pow2 (``metrics/fft_iterativa.py:13-22``).
      mode: ``"flexible"`` (prominence detector, k=4), ``"rigid"``
        (resolution detector, k=5), or ``"adaptive"`` (prominence with
        per-window resolution fallback).
      backend: ``"matmul"`` (default; four-step DFT matmuls, the only
        SPMD-partitionable one) | ``"xla"`` (``jnp.fft``, cuFFT on a GPU).
        The default was chosen on the earlier chip and has not been
        re-measured against cuFFT per cell (ROADMAP S3).
      max_candidates: candidate budget for the flexible detector.  None (the
        default) or ``"dynamic"`` sizes it from the data: a sticky
        power-of-two budget with an overflow re-run, so results always match
        the unbounded reference at the cost of one scalar readback per epoch.
        An int pins a static budget (no readback; may truncate - check
        ``EpochResult.n_candidates``, the pre-budget count per window).
        Under an outer jit trace None falls back to the static
        ``default_max_candidates(n_fft)``.
      refine: also compute sub-bin interpolated peak frequencies.
      lengths: optional integer array (batch shape) of valid-prefix lengths
        for ragged windows.
      dtype: compute dtype (float32 on the accelerator; float64 works on CPU
        with x64).
      center: "auto" skips the median sort when it can only affect the
        (zeroed) DC bin; "always" forces it.
      selection: candidate ordering implementation ("auto" | "argmax" |
        "topk" | "sort"; "auto" picks argmax for small budgets - see
        ``ops.peaks_prominence.prominence_select``; the
        sharded path needs "sort").
      batch_chunk: epochs larger than this are processed in lax.map chunks
        to bound the on-chip working set (0 disables).
      taper: spectral-leakage window applied after centering - "none"
        (default, reference parity: rectangular), "hann", "hamming", or
        "blackman".  Amplitude-normalized by coherent gain so on-bin tone
        magnitudes keep the untapered scale; spans the valid/pre-pad data
        length.  Beyond-reference feature.  With center="auto" (default),
        full tapered windows use the fast mean detrend (the standard
        windowed-analysis convention); center="always" forces the
        reference-style median, which differs only in the DC-adjacent bins
        the taper's leakage reaches.

    Returns:
      :class:`EpochResult` with batch-shaped arrays.
    """
    samples = jnp.asarray(samples, dtype)
    if samples.ndim < 2:
        samples = samples[None, :]
    if n_fft is None:
        n_fft = fft_ops.next_pow2(samples.shape[-1])
    if k is None:
        k = default_k(mode)
    fs_orig = fs  # pre-cast rate: the float64 value the rigid wipe rounding needs
    fs = jnp.asarray(fs, dtype)
    has_lengths = lengths is not None
    if has_lengths:
        lengths = jnp.asarray(lengths, jnp.int32)
        lengths = jnp.broadcast_to(lengths, samples.shape[:-1])

    # Dynamic candidate budget (the default): run with a sticky power-of-two
    # budget, read back the true pre-budget candidate count, and re-run with a
    # bigger budget iff it overflowed - so decisions are always identical to
    # the unbounded reference, and the detector's O(M*H) scan stage is sized
    # by the data instead of a worst-case constant.  Costs one scalar device
    # readback per epoch; unavailable under an outer trace (tracers cannot be
    # read back), where the static default applies.
    traced = any(
        isinstance(x, jax.core.Tracer) for x in (samples, fs, lengths) if x is not None
    )
    empty = any(d == 0 for d in samples.shape[:-1])
    dynamic = (
        max_candidates in (None, "dynamic")
        and mode in ("flexible", "adaptive")
        and not traced
        # Zero-window epochs have no candidate counts to read back (and
        # nothing to get wrong); the static path returns the empty result.
        and not empty
    )
    if max_candidates == "dynamic" and traced:
        raise ValueError("max_candidates='dynamic' cannot run under an outer jit trace")
    if max_candidates not in (None, "dynamic") and not isinstance(max_candidates, int):
        raise ValueError(
            f"max_candidates must be an int, None or 'dynamic', got {max_candidates!r}"
        )
    if center not in ("auto", "always"):
        raise ValueError(f"unknown center {center!r}; expected 'auto' or 'always'")
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if precision not in fft_ops.PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {fft_ops.PRECISIONS}"
        )
    if precision == "fast" and backend != "matmul":
        raise ValueError(
            'precision="fast" applies to the matmul backend only '
            f"(got backend={backend!r})"
        )
    if not dynamic and not isinstance(max_candidates, int):
        max_candidates = default_max_candidates(n_fft)

    # Non-dyadic sampling rates: the rigid detector's exclusion-wipe rounding
    # at exact-half boundaries follows the float64 reference only via a
    # host-computed side table (ops.peaks_resolution.rigid_half_corrections).
    # None for the dyadic hardware rates (the common case - no extra operand,
    # same compiled program as before) and unavailable under an outer trace
    # (fs unreadable), where the banker's snap applies.
    half_corr = None
    if mode in ("rigid", "adaptive") and not traced and not empty:
        half_corr = _rigid_corr_batch(fs_orig, samples.shape[:-1], n_fft)

    kwargs = dict(
        n_fft=n_fft,
        mode=mode,
        k=k,
        backend=backend,
        refine=refine,
        has_lengths=has_lengths,
        center=center,
        selection=selection,
        batch_chunk=batch_chunk,
        taper=taper,
        precision=precision,
    )
    if not dynamic:
        return _analyze_epoch_impl(
            samples, fs, lengths, half_corr, max_candidates=max_candidates, **kwargs
        )

    # Adaptive mode outside a trace: run the prominence pass alone and only
    # pay for the resolution fallback when some window actually came back
    # empty (the in-program path runs both detectors for every window).
    # The merge is elementwise-identical to the traced adaptive branch.
    if mode == "adaptive":
        flex = analyze_epoch(
            samples, fs, n_fft=n_fft, mode="flexible", k=k, backend=backend,
            max_candidates=max_candidates, refine=refine, lengths=lengths,
            dtype=dtype, center=center, selection=selection,
            batch_chunk=batch_chunk, taper=taper,
            precision=precision,
        )
        if _is_multidevice(flex.count):
            any_empty = bool((np.asarray(jax.device_get(flex.count)) == 0).any())
        else:
            any_empty = int(jax.device_get(jnp.min(flex.count))) == 0
        if not any_empty:
            return flex
        rig = _analyze_epoch_impl(
            samples, fs, lengths, half_corr, max_candidates=_DYNAMIC_FLOOR,
            **{**kwargs, "mode": "rigid"},
        )
        use = flex.count > 0
        usek = use[..., None]
        return EpochResult(
            count=jnp.where(use, flex.count, rig.count),
            idx=jnp.where(usek, flex.idx, rig.idx),
            freq=jnp.where(usek, flex.freq, rig.freq),
            mag=jnp.where(usek, flex.mag, rig.mag),
            prominence=jnp.where(usek, flex.prominence, 0.0),
            damping=jnp.where(usek, flex.damping, 0.0),
            q_factor=jnp.where(usek, flex.q_factor, 0.0),
            refined_freq=jnp.where(usek, flex.refined_freq, rig.refined_freq),
            n_candidates=flex.n_candidates,
            n_required=flex.n_required,
        )

    n_windows = 1
    for d in samples.shape[:-1]:
        n_windows *= d
    return _run_dynamic(
        lambda mc: _analyze_epoch_impl(
            samples, fs, lengths, half_corr, max_candidates=mc, **kwargs
        ),
        n_fft=n_fft, mode=mode, n_windows=n_windows,
    )


def _run_dynamic(run_pass, *, n_fft: int, mode: str, n_windows: int) -> EpochResult:
    """The dynamic-budget host loop around one epoch pass.

    ``run_pass(mc)`` runs the epoch at candidate budget ``mc`` (a flat int
    or the private two-tier tuple) and returns an :class:`EpochResult`
    whose ``n_required`` implements the exactness contract (reports past
    the budget whenever any window's decisions are not reference-exact).
    Shared by :func:`analyze_epoch` (samples in) and
    :func:`detect_from_mags` (precomputed - possibly sequence-parallel -
    magnitudes in); both learn into the same sticky per-(n_fft, mode)
    budget/tier tables.
    """
    h = n_fft // 2
    key = (n_fft, mode)
    budget = min(_dynamic_budget.get(key, _DYNAMIC_FLOOR), max(h, 1))
    s_cap = _tier_capacity(n_windows)
    tier = _dynamic_tier.get(key)
    passes = 0
    while True:
        passes += 1
        # Two-tier split (when learned for this key and applicable at this
        # budget/batch): same exactness contract as the flat budget - the
        # merged n_required reports > budget whenever any window's decisions
        # are not reference-exact (including straggler-capacity overflow), so
        # the loop below re-runs on exactly the right condition.
        mc = _effective_mc(budget, h, n_windows, tier)
        res = run_pass(mc)
        # One fused readback: the epoch is exact iff every window's walk
        # either completed within the budget prefix or saw all its candidates
        # (n_required <= budget); n_candidates stays for observability only.
        # The per-grid counts feed the tier learning below (still one
        # transfer).
        nr = res.n_required
        if _is_multidevice(nr):
            # Host-side reduction for sharded epochs: an EAGER jnp.max/sum
            # over a multi-device array dispatches an XLA:CPU all-reduce
            # whose in-process rendezvous can time out and hard-abort when
            # other mesh programs' threads are live (observed: 7/8
            # participants, F rendezvous.cc:127).  Per-shard device_get has
            # no collective at all, and the arrays are tiny ([B] int32).
            nr_h = np.asarray(jax.device_get(nr)).ravel()
            n_req = int(nr_h.max())
            n_max = int(np.asarray(jax.device_get(res.n_candidates)).max())
            grid_counts = [int((nr_h > g).sum()) for g in _TIER_GRID]
        else:
            # One fused device-side readback (a single transfer).
            scalars = jax.device_get(
                jnp.stack(
                    [jnp.max(nr), jnp.max(res.n_candidates)]
                    + [jnp.sum((nr > g).astype(jnp.int32)) for g in _TIER_GRID]
                )
            )
            n_req, n_max = int(scalars[0]), int(scalars[1])
            grid_counts = [int(v) for v in scalars[2:]]
        if n_req <= budget or budget >= h:
            break
        # Any failure (budget too small, or tier capacity overflowed) falls
        # back to a flat re-run at the grown budget; the tier is re-learned
        # from the exact epoch's counts afterwards.
        tier = None
        budget = min(
            max(_pow2_at_least(n_req), _dynamic_budget_hwm.get(key, 0), _DYNAMIC_FLOOR),
            h,
        )
    _dynamic_budget[key] = min(max(_pow2_at_least(n_req), _DYNAMIC_FLOOR), h)
    _dynamic_budget_hwm[key] = max(_dynamic_budget_hwm.get(key, 0), budget)
    # Learn the split from this exact epoch: the smallest grid budget that
    # leaves at most half the straggler capacity needing the big pass (2x
    # headroom for epoch-to-epoch drift), provided it actually halves the
    # budget.  The counts are exact-n_required counts (the epoch passed the
    # exactness check above).
    new_tier = None
    if n_windows >= 4 * s_cap:
        for g, c in zip(_TIER_GRID, grid_counts):
            if g * 2 <= _dynamic_budget[key] and c <= s_cap // 2:
                new_tier = (g, s_cap)
                break
    if new_tier is None:
        _dynamic_tier.pop(key, None)
    else:
        _dynamic_tier[key] = new_tier
    stats = last_dynamic_stats()
    stats.clear()
    stats.update(
        candidate_budget=budget, n_candidates_max=n_max,
        n_required_max=n_req, budget_passes=passes,
        tier=(mc if isinstance(mc, tuple) else None),
    )
    return res


@dataclasses.dataclass
class PipelineConfig:
    """Static configuration for a :class:`SpectralPipeline`."""

    mode: str = "flexible"
    k: int | None = None
    backend: str = "matmul"
    max_candidates: int | str | None = None  # None = dynamic (data-sized) budget
    refine: bool = False
    dtype: Any = jnp.float32
    center: str = "auto"
    #: None = auto: "auto" single-device, "sort" when a mesh is used
    #: (lax.top_k has no SPMD partitioning rule).
    selection: str | None = None
    #: Spectral-leakage window ("none" = reference-parity rectangular).
    taper: str = "none"
    #: Spectrum precision: "highest" (1e-6 contract) | "fast" (opt-in reduced
    #: precision matmuls - see ops.fft.PRECISIONS).
    precision: str = "highest"

    @classmethod
    def from_gateway_flag(cls, is_flexibile_structure: bool, **kw) -> "PipelineConfig":
        """Map the reference's (typo'd, load-bearing) config flag
        ``is_flexibile_structure`` (``GT_FFT_v5.py:138,639-642``) to a mode."""
        return cls(mode="flexible" if is_flexibile_structure else "rigid", **kw)


class SpectralPipeline:
    """Stateful wrapper: compiled epoch analysis + self-profiling metrics.

    Mirrors the reference's habit of attaching CPU/wall/RSS metrics to every
    FFT run (``GT_FFT_v5.py:623-624,663-676``); here the same metric names are
    captured per epoch call (device wall time, host process time, peak RSS).
    """

    def __init__(self, config: PipelineConfig | None = None, mesh=None):
        from apda_fft_tpu.utils.profiling import EpochMetrics

        self.config = config or PipelineConfig()
        self.mesh = mesh  # optional jax.sharding.Mesh: run epochs data-parallel
        self._metrics = EpochMetrics()
        self.last_metrics: dict[str, float] = {}

    def __call__(self, samples, fs, *, n_fft: int | None = None, lengths=None) -> EpochResult:
        last_dynamic_stats().clear()  # don't inherit a previous call's stats
        with self._metrics.measure():
            result = jax.block_until_ready(self._run(samples, fs, n_fft, lengths))
        self.last_metrics = {
            **self._metrics.last,
            # dynamic-budget observability (empty on static-budget runs)
            **last_dynamic_stats(),
        }
        return result

    def welch(
        self, samples, fs, *, window: int, hop: int | None = None,
        taper: str = "hann",
    ) -> EpochResult:
        """Welch-averaged analysis under this pipeline's config + metrics.

        The Welch companion of ``__call__`` (signature matches what
        :func:`~apda_fft_tpu.models.batching.analyze_records_welch` expects
        from its ``analyze`` hook): mode/k/refine/backend/dtype come from
        ``self.config``, and ``last_metrics`` is populated exactly like an
        epoch call so gateway history reporting is uniform.
        """
        from apda_fft_tpu.models.streaming import analyze_welch

        cfg = self.config
        last_dynamic_stats().clear()
        with self._metrics.measure():
            result = jax.block_until_ready(
                analyze_welch(
                    samples, fs, window=window, hop=hop, taper=taper,
                    mode=cfg.mode, k=cfg.k, backend=cfg.backend,
                    refine=cfg.refine, dtype=cfg.dtype,
                    selection=cfg.selection or "auto",
                    precision=cfg.precision,
                    # averaged spectra are smooth; only an explicit int budget
                    # carries over (the epoch path's dynamic budget protocol
                    # needs the overflow readback analyze_welch doesn't do)
                    max_candidates=cfg.max_candidates
                    if isinstance(cfg.max_candidates, int) else None,
                )
            )
        self.last_metrics = {**self._metrics.last, **last_dynamic_stats()}
        return result

    def _run(self, samples, fs, n_fft, lengths) -> EpochResult:
        cfg = self.config
        if self.mesh is not None:
            from apda_fft_tpu.parallel.mesh import analyze_epoch_sharded

            result = analyze_epoch_sharded(
                jnp.asarray(samples, cfg.dtype),
                fs,
                mesh=self.mesh,
                lengths=lengths,
                n_fft=n_fft,
                mode=cfg.mode,
                k=cfg.k,
                backend=cfg.backend,
                max_candidates=cfg.max_candidates,
                refine=cfg.refine,
                dtype=cfg.dtype,
                center=cfg.center,
                taper=cfg.taper,
                precision=cfg.precision,
                **({"selection": cfg.selection} if cfg.selection else {}),
            )
        else:
            result = analyze_epoch(
                samples,
                fs,
                n_fft=n_fft,
                mode=cfg.mode,
                k=cfg.k,
                backend=cfg.backend,
                max_candidates=cfg.max_candidates,
                refine=cfg.refine,
                lengths=lengths,
                dtype=cfg.dtype,
                center=cfg.center,
                selection=cfg.selection or "auto",
                taper=cfg.taper,
                precision=cfg.precision,
            )
        return result
