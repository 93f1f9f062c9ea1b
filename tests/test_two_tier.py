"""Two-tier candidate budget: decision-exactness and the learning loop.

The dynamic budget can split an epoch into a small-budget pass over every
window plus a big-budget re-detect of only the windows whose greedy walk
self-reports ``n_required > m_small`` (``pipeline._flex_detect``), inside one
program.  These tests pin the contract:

* a tiered run's decisions are IDENTICAL to the flat big-budget run whenever
  the straggler capacity suffices;
* capacity overflow is always self-reported past the budget (so the dynamic
  loop's ``n_required <= budget`` exactness check can never pass by accident);
* the dynamic loop learns / applies / abandons the split correctly end to end.

Design: docs/DESIGN.md "Two-tier candidate budget".
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from apda_fft_tpu.models import pipeline
from apda_fft_tpu.models.pipeline import (
    _analyze_epoch_impl,
    _flex_detect,
    _tier_capacity,
    analyze_epoch,
    last_dynamic_stats,
    steady_state_max_candidates,
)
from apda_fft_tpu.ops import fft as fft_ops

N = 4096
H = N // 2
FS = 500.0


def _noisy(batch: int, seed: int = 1234, noise: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(N) / FS
    x = noise * rng.standard_normal((batch, N)).astype(np.float64)
    for f, a, zeta in ((12.3, 0.9, 0.01), (47.7, 0.7, 0.008),
                       (88.4, 0.55, 0.015), (141.2, 0.45, 0.02)):
        phase = rng.uniform(0, 2 * np.pi, size=(batch, 1))
        x += a * np.sin(2 * np.pi * f * t[None, :] + phase) * np.exp(
            -zeta * 2 * np.pi * f * t[None, :]
        )
    return x.astype(np.float32)


def _mags(x: np.ndarray) -> jnp.ndarray:
    centered = jnp.asarray(x) - jnp.mean(jnp.asarray(x), axis=-1, keepdims=True)
    return fft_ops.halfspec_magnitudes(centered, backend="matmul")


@pytest.fixture(scope="module")
def corpus():
    x = _noisy(512)
    mags = _mags(x)
    fs = jnp.full((512,), FS, jnp.float32)
    flat = _flex_detect(mags, fs, n_fft=N, k=4, max_candidates=64)
    # The corpus must actually exercise tiering: noisy spectra with a spread
    # of n_required values.
    nr = np.asarray(flat.n_required)
    assert nr.max() > 8 and (nr <= 8).sum() > 256, nr.max()
    return x, mags, fs, flat


def _assert_same_decisions(got, want, where=None):
    sel = slice(None) if where is None else where
    np.testing.assert_array_equal(np.asarray(got.count)[sel], np.asarray(want.count)[sel])
    np.testing.assert_array_equal(np.asarray(got.idx)[sel], np.asarray(want.idx)[sel])
    np.testing.assert_array_equal(np.asarray(got.freq)[sel], np.asarray(want.freq)[sel])
    np.testing.assert_array_equal(np.asarray(got.mag)[sel], np.asarray(want.mag)[sel])


@pytest.mark.parametrize("m_small", [8, 12, 16])
def test_two_tier_matches_flat_when_capacity_suffices(corpus, m_small):
    _, mags, fs, flat = corpus
    need = int((np.asarray(flat.n_required) > m_small).sum())
    s_cap = 128
    assert need <= s_cap, "corpus drifted; raise s_cap"
    tiered = _flex_detect(mags, fs, n_fft=N, k=4, max_candidates=(m_small, 64, s_cap))
    _assert_same_decisions(tiered, flat)
    np.testing.assert_array_equal(
        np.asarray(tiered.n_required), np.asarray(flat.n_required)
    )
    np.testing.assert_array_equal(
        np.asarray(tiered.n_candidates), np.asarray(flat.n_candidates)
    )


def test_two_tier_overflow_self_reports_past_budget(corpus):
    _, mags, fs, flat = corpus
    nr = np.asarray(flat.n_required)
    m_small, m_big, s_cap = 4, 64, 32
    n_need = int((nr > m_small).sum())
    assert n_need > s_cap, "corpus drifted; lower s_cap"
    tiered = _flex_detect(mags, fs, n_fft=N, k=4, max_candidates=(m_small, m_big, s_cap))
    got_nr = np.asarray(tiered.n_required)
    # Every window the capacity could not re-run must report past m_big so
    # the dynamic loop can never accept the epoch; n_need - s_cap of them
    # exist.  (A too-small report would silently keep wrong small-budget
    # decisions: nr values in (m_small, m_big] are common - see `nr`.)
    assert ((nr > m_small) & (nr <= m_big)).any()
    assert int((got_nr > m_big).sum()) >= n_need - s_cap
    # Windows decided in pass 1 keep exact decisions and exact n_required.
    clean = nr <= m_small
    _assert_same_decisions(tiered, flat, where=clean)
    np.testing.assert_array_equal(got_nr[clean], nr[clean])


def test_two_tier_flat_fallbacks():
    x = _noisy(64)
    mags, fs = _mags(x), jnp.full((64,), FS, jnp.float32)
    flat = _flex_detect(mags, fs, n_fft=N, k=4, max_candidates=64)
    # Batch too small to amortize (b < 4*s_eff) and split >= budget: both
    # must produce the flat program's exact outputs.
    for mc in [(8, 64, 32), (64, 64, 8)]:
        got = _flex_detect(mags, fs, n_fft=N, k=4, max_candidates=mc)
        _assert_same_decisions(got, flat)
        np.testing.assert_array_equal(
            np.asarray(got.n_required), np.asarray(flat.n_required)
        )


def test_impl_threads_tuple_through_chunking(corpus):
    x, _, _, _ = corpus
    fs = jnp.full((512,), FS, jnp.float32)
    flat = _analyze_epoch_impl(
        jnp.asarray(x), fs, None, n_fft=N, mode="flexible", k=4,
        backend="matmul", max_candidates=64, refine=False, has_lengths=False,
        batch_chunk=128,
    )
    tiered = _analyze_epoch_impl(
        jnp.asarray(x), fs, None, n_fft=N, mode="flexible", k=4,
        backend="matmul", max_candidates=(12, 64, 32), refine=False,
        has_lengths=False, batch_chunk=128,
    )
    # 512 windows in 4 chunks of 128; s_eff=32 per chunk covers this
    # corpus's stragglers (they are spread roughly uniformly).
    _assert_same_decisions(tiered, flat)


def test_dynamic_loop_learns_and_applies_tier():
    pipeline._dynamic_budget.clear()
    pipeline._dynamic_budget_hwm.clear()
    pipeline._dynamic_tier.clear()
    x = _noisy(512)
    fs = np.full((512,), FS, np.float32)
    res1 = analyze_epoch(x, fs, n_fft=N, mode="flexible")
    key = (N, "flexible")
    tier = pipeline._dynamic_tier.get(key)
    assert tier is not None, last_dynamic_stats()
    m_small, s_cap = tier
    assert s_cap == _tier_capacity(512)
    assert m_small * 2 <= pipeline._dynamic_budget[key]
    # Steady state advertises the split; a second epoch runs it and must
    # produce decisions identical to a flat unbounded run.
    mc = steady_state_max_candidates(N, "flexible", 512)
    assert mc == (m_small, pipeline._dynamic_budget[key], s_cap)
    x2 = _noisy(512, seed=7)
    res2 = analyze_epoch(x2, fs, n_fft=N, mode="flexible")
    assert last_dynamic_stats()["tier"] == mc
    assert last_dynamic_stats()["budget_passes"] == 1
    ref2 = analyze_epoch(x2, fs, n_fft=N, mode="flexible", max_candidates=256)
    _assert_same_decisions(res2, ref2)
    del res1


def test_dynamic_loop_tier_overflow_recovers_exactly():
    pipeline._dynamic_budget.clear()
    pipeline._dynamic_budget_hwm.clear()
    pipeline._dynamic_tier.clear()
    key = (N, "flexible")
    fs = np.full((512,), FS, np.float32)
    # Learn a split on quiet-ish data...
    analyze_epoch(_noisy(512, noise=0.4), fs, n_fft=N, mode="flexible")
    tier = pipeline._dynamic_tier.get(key)
    if tier is None:
        pytest.skip("quiet corpus produced no split on this platform")
    # ...then force a much louder epoch through it: whatever happens (capacity
    # overflow and/or budget growth -> flat re-runs), the returned decisions
    # must match the flat unbounded run.
    loud = _noisy(512, seed=99, noise=3.0)
    res = analyze_epoch(loud, fs, n_fft=N, mode="flexible")
    ref = analyze_epoch(loud, fs, n_fft=N, mode="flexible", max_candidates=512)
    _assert_same_decisions(res, ref)
    stats = last_dynamic_stats()
    assert stats["n_required_max"] <= stats["candidate_budget"]


def test_clean_epochs_do_not_tier():
    pipeline._dynamic_budget.clear()
    pipeline._dynamic_budget_hwm.clear()
    pipeline._dynamic_tier.clear()
    rng = np.random.default_rng(0)
    t = np.arange(N) / FS
    x = (np.sin(2 * np.pi * 12.3 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t)
         + 0.01 * rng.standard_normal((512, N))).astype(np.float32)
    analyze_epoch(x, np.full((512,), FS, np.float32), n_fft=N, mode="flexible")
    # Clean data settles at a tiny flat budget; no split is stored (the grid
    # has no value with 2*g <= budget).
    assert (N, "flexible") not in pipeline._dynamic_tier
    assert last_dynamic_stats()["tier"] is None
    assert isinstance(steady_state_max_candidates(N, "flexible", 512), int)
