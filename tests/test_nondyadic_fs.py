"""Non-dyadic sampling-rate exactness for the rigid detector.

The reference's exclusion wipe is ``round((idx*df)*0.02/df)`` in float64
(``get_peak_resolution.py:105,116-117``).  For dyadic hardware rates the
expression lands exactly on half-integers at ``idx % 25 == 0`` and the
device's banker's snap is exact; for non-dyadic rates the float64 value sits
an ulp OFF the half at ``idx % 50 == 25`` and the reference rounds by that
perturbation's direction - recovered on the host by
``rigid_half_corrections`` and shipped to the detector as a tiny table.

Three layers here: exhaustive table parity vs float64 over many rates,
a >= 500-case decision fuzz with exclusion-boundary-dense spectra, and a
pinned regression case where the correction provably changes the decision.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from apda_fft_tpu.ops.peaks_resolution import (
    _discard_count,
    resolution_peaks,
    rigid_half_corrections,
)
from tests.oracle import oracle_resolution_peaks
from tests.test_detector_fuzz import _spec_from_mags

NON_DYADIC_RATES = [100.0, 99.7, 333.33, 256.5, 123.456, 47.3, 1000.1, 7.77,
                    98.0, 441.0]
DYADIC_RATES = [31.25, 62.5, 125.0, 250.0, 500.0]


def _f64_reference_nd(fs, n):
    """The oracle's wipe width for every bin, in true float64."""
    ds = np.float64(fs) / np.float64(n)
    idx = np.arange(n // 2, dtype=np.float64)
    return np.round(((idx * ds) * np.float64(0.02)) / ds).astype(np.int64)


def _device_nd(fs, n):
    """The device path: f32 snap + optional host correction table."""
    h = n // 2
    ds32 = np.float32(np.float32(fs) / np.float32(n))
    freq32 = np.arange(h, dtype=np.float32) * ds32
    nd = np.asarray(
        _discard_count(jnp.asarray(freq32), jnp.asarray(ds32))
    ).astype(np.int64)
    corr = rigid_half_corrections(fs, n)
    if corr is not None:
        j = np.arange(h)
        mask = (j % 50) == 25
        nd[mask] += corr[j[mask] // 50]
    return nd


@pytest.mark.parametrize("fs", NON_DYADIC_RATES + DYADIC_RATES)
@pytest.mark.parametrize("n", [512, 4096, 65536])
def test_discard_count_exact_all_bins(fs, n):
    np.testing.assert_array_equal(_device_nd(fs, n), _f64_reference_nd(fs, n))


def test_corrections_none_for_dyadic_rates():
    # Dyadic rates ship no table: the compiled program is unchanged.
    for fs in DYADIC_RATES:
        for n in (512, 4096, 65536):
            assert rigid_half_corrections(fs, n) is None, (fs, n)
    # The probed non-dyadic rates all need one somewhere.
    assert rigid_half_corrections(99.7, 4096) is not None
    assert rigid_half_corrections(333.33, 1024) is not None


def _boundary_dense_mags(rng, h):
    """Random spectra with candidates planted at exclusion-boundary spacings.

    A spike at a half-boundary bin (j % 50 == 25) plus neighbors at exactly
    the wipe radius +/- 1: an off-by-one wipe width flips whether the
    neighbor survives as the next greedy candidate.
    """
    m = rng.uniform(0, 1, h)
    boundaries = np.arange(25, h - 1, 50)
    picks = rng.choice(boundaries, size=min(4, len(boundaries)), replace=False)
    for j in picks:
        j = int(j)
        m[j] = rng.uniform(20, 50)
        nd = int(np.round(j / 50))  # wipe radius scale
        for off in (-nd - 1, -nd, nd, nd + 1):
            t = j + off
            if 1 <= t < h - 1 and t != j:
                m[t] = rng.uniform(10, 19)
    m[0] = 0.0
    return m.astype(np.float32).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _jitted_resolution(n_fft: int, has_corr: bool):
    """One compiled detector per (n_fft, corr-presence): an eagerly-called
    resolution_peaks re-traces its while_loop every call (~0.4 s warm on
    CPU), which made the 500-case fuzz minutes-long for no coverage gain."""
    import jax

    if has_corr:
        return jax.jit(lambda m, f, c: resolution_peaks(m, f, n_fft, half_corr=c))
    return jax.jit(lambda m, f: resolution_peaks(m, f, n_fft))


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_nondyadic_decisions(seed):
    """>= 500 decision cases (25 seeds x 20 draws) exact vs the f64 oracle."""
    rng = np.random.default_rng(7000 + seed)
    for _ in range(20):
        h = int(rng.choice([256, 512, 1024]))
        fs = float(rng.choice(NON_DYADIC_RATES))
        mags = _boundary_dense_mags(rng, h)
        ref = oracle_resolution_peaks(_spec_from_mags(mags), fs)
        corr = rigid_half_corrections(fs, 2 * h)
        m32 = jnp.asarray(mags, jnp.float32)
        fs32 = jnp.float32(fs)
        if corr is not None:
            got = _jitted_resolution(2 * h, True)(m32, fs32, jnp.asarray(corr))
        else:
            got = _jitted_resolution(2 * h, False)(m32, fs32)
        got_idx = [int(i) for i in np.asarray(got.idx)[: int(got.count)]]
        assert got_idx == [p["idx"] for p in ref], (seed, h, fs)


def test_regression_wipe_boundary_flip():
    """Pinned case where the correction changes the decision (fs=99.7).

    At fs=99.7, N=1024 the f64 wipe width at bin 325 is 7 (x64 = 6.5+ulp)
    while the banker's snap gives 6.  A candidate planted at bin 332 is
    wiped by the corrected radius but SURVIVES the uncorrected one - so the
    uncorrected peak list provably diverges from the oracle and the
    corrected one matches it.
    """
    fs, n = 99.7, 1024
    h = n // 2
    corr = rigid_half_corrections(fs, n)
    assert corr is not None and corr[6] == 1  # bin 325 -> q=6: +1 vs banker's

    m = np.full(h, 0.01, np.float64)
    m[325] = 50.0
    m[332] = 30.0   # at radius 7: wiped by nd=7, survives nd=6
    m[100] = 20.0   # an unambiguous second peak far away
    m = m.astype(np.float32).astype(np.float64)

    ref = oracle_resolution_peaks(_spec_from_mags(m), fs)
    ref_idx = [p["idx"] for p in ref]
    assert 332 not in ref_idx  # the f64 reference wipes it

    got = resolution_peaks(
        jnp.asarray(m, jnp.float32), fs, n, half_corr=jnp.asarray(corr)
    )
    got_idx = [int(i) for i in np.asarray(got.idx)[: int(got.count)]]
    assert got_idx == ref_idx

    # Without the table the banker's snap keeps bin 332 - the divergence
    # this feature exists to close.
    raw = resolution_peaks(jnp.asarray(m, jnp.float32), fs, n)
    raw_idx = [int(i) for i in np.asarray(raw.idx)[: int(raw.count)]]
    assert 332 in raw_idx


def test_pipeline_threads_corrections_end_to_end():
    """analyze_epoch computes + applies the table from the float64 rate."""
    from apda_fft_tpu.models.pipeline import _rigid_corr_batch, analyze_epoch
    from apda_fft_tpu.ops.fft import halfspec_magnitudes, center_and_pad

    # Table construction: None for dyadic, per-row for mixed batches.
    assert _rigid_corr_batch(500.0, (4,), 1024) is None
    mixed = _rigid_corr_batch(np.asarray([500.0, 99.7]), (2,), 1024)
    assert mixed is not None and not mixed[0].any() and mixed[1].any()

    # End to end: decisions through analyze_epoch (rigid, fs=99.7) equal
    # running the detector manually on the same device spectra with the
    # table - proving the operand actually reaches the wipe.
    rng = np.random.default_rng(3)
    n = 1024
    x = rng.standard_normal((3, n)).astype(np.float32)
    t = np.arange(n)
    for f_bin in (325, 100):
        x += 30.0 / n * np.cos(2 * np.pi * f_bin * t / n)[None, :].astype(np.float32)
    fs = 99.7
    res = analyze_epoch(x, fs, n_fft=n, mode="rigid")

    mags = halfspec_magnitudes(center_and_pad(jnp.asarray(x), n), backend="matmul")
    corr = rigid_half_corrections(fs, n)
    for row in range(3):
        manual = resolution_peaks(
            mags[row], np.float32(fs), n, half_corr=jnp.asarray(corr)
        )
        want = [int(i) for i in np.asarray(manual.idx)[: int(manual.count)]]
        got = [int(i) for i in np.asarray(res.idx[row])[: int(res.count[row])]]
        assert got == want, row


def test_welch_threads_corrections():
    from apda_fft_tpu.models.streaming import analyze_welch

    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    res = analyze_welch(x, 99.7, window=1024, mode="rigid")
    assert int(res.count) >= 0  # smoke: non-dyadic rigid welch compiles + runs
