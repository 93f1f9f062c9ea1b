"""Single-window epochs (B=1) on the batched pipeline.

A lone window runs the same batched program as any epoch (cfg1/cfg2 of the
benchmark).  These pin its decisions against the float64 oracle and its
dynamic-budget host loop at B=1: the sticky budget, the overflow re-run,
walks that complete early despite candidate overflow, and the adaptive
fallback.
"""

import numpy as np
import pytest

import apda_fft_tpu.models.pipeline as P
from apda_fft_tpu.models.pipeline import analyze_epoch, last_dynamic_stats
from tests.oracle import oracle_analyze
from tests.signals import modal_signal


@pytest.fixture
def fresh_budgets():
    """Isolate the process-wide sticky budget tables."""
    tables = (P._dynamic_budget, P._dynamic_budget_hwm, P._dynamic_tier)
    saved = [dict(t) for t in tables]
    for t in tables:
        t.clear()
    yield
    for t, s in zip(tables, saved):
        t.clear()
        t.update(s)


def _window(n, fs, seed, kind="modal"):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    if kind == "modal":
        x = (
            np.sin(2 * np.pi * 0.025 * fs * t)
            + 0.6 * np.sin(2 * np.pi * 0.095 * fs * t)
            + 0.05 * rng.standard_normal(n)
            + 3.0
        )
    elif kind == "noise":
        x = rng.standard_normal(n)
    else:  # sparse impulses
        x = np.zeros(n)
        x[rng.integers(0, n, 8)] = 5.0 * rng.standard_normal(8)
    return x.astype(np.float32)


def _idx(res, row=0):
    return [int(i) for i in np.asarray(res.idx[row])[: int(res.count[row])]]


def _oracle(x, fs, mode):
    return [p["idx"] for p in oracle_analyze(x, fs, mode=mode)]


@pytest.mark.parametrize("mode", ["rigid", "flexible"])
@pytest.mark.parametrize("kind", ["modal", "noise", "impulse"])
def test_single_window_matches_oracle(mode, kind):
    n, fs = 1024, 500.0
    x = _window(n, fs, seed=7, kind=kind)
    res = analyze_epoch(x[None], fs, n_fft=n, mode=mode, refine=True)
    assert _idx(res) == _oracle(x, fs, mode)


@pytest.mark.parametrize("mode", ["rigid", "flexible"])
@pytest.mark.parametrize("n, fs, seed", [(4096, 500.0, 1), (1024, 62.5, 2), (2048, 62.5, 6)])
def test_single_window_n4096_and_low_fs(mode, n, fs, seed):
    x = modal_signal(n, fs, seed=seed).astype(np.float32)
    res = analyze_epoch(x[None], fs, n_fft=n, mode=mode)
    assert _idx(res) == _oracle(x, fs, mode), (n, fs)


@pytest.mark.parametrize("mode", ["flexible", "rigid", "adaptive"])
def test_single_window_equals_its_batched_row(mode):
    """B=1 and the same window inside a larger epoch decide identically
    (other budgets, possibly other programs) and refine alike."""
    n, fs = 2048, 250.0
    xs = np.stack([_window(n, fs, seed=s, kind=k)
                   for s, k in ((3, "modal"), (4, "noise"), (5, "impulse"))])
    batched = analyze_epoch(xs, fs, mode=mode, refine=True)
    for row in range(3):
        one = analyze_epoch(xs[row][None], fs, mode=mode, refine=True)
        assert _idx(one) == _idx(batched, row), row
        c = int(one.count[0])
        np.testing.assert_allclose(np.asarray(one.refined_freq[0])[:c],
                                   np.asarray(batched.refined_freq[row])[:c],
                                   rtol=1e-6)


def test_sticky_budget_carries_over_between_single_windows(fresh_budgets):
    n, fs = 1024, 500.0
    x = _window(n, fs, seed=3, kind="noise")
    analyze_epoch(x[None], fs, mode="flexible")
    learned = P._dynamic_budget[(n, "flexible")]
    first_passes = last_dynamic_stats()["budget_passes"]
    res = analyze_epoch(x[None], fs, mode="flexible")
    assert last_dynamic_stats()["budget_passes"] == 1  # the sticky budget fits
    assert last_dynamic_stats()["candidate_budget"] == learned
    assert first_passes >= 1 and _idx(res) == _oracle(x, fs, "flexible")


def test_overflow_rerun_on_single_window(fresh_budgets):
    # 71 bin-exact tones above bin 1000: every candidate fails the damping
    # floor (damping = 100/j % < 0.1%), so the walk never completes and
    # n_required = n_candidates = 71 - the floor budget of 2 overflows and
    # the host loop re-runs at a grown budget.
    fs, n = 500.0, 4096
    t = np.arange(n) / fs
    x = sum(np.sin(2 * np.pi * (b * fs / n) * t)
            for b in range(1100, 1313, 3)).astype(np.float32)
    res = analyze_epoch(x[None], fs, mode="flexible")
    assert last_dynamic_stats()["budget_passes"] >= 2
    assert P._dynamic_budget[(n, "flexible")] > 64
    flat = analyze_epoch(x[None], fs, mode="flexible", max_candidates=n // 2)
    assert _idx(res) == _idx(flat)
    assert int(res.count[0]) == int(flat.count[0])


def test_early_complete_walk_keeps_small_budget(fresh_budgets):
    # Noise window with > 64 pre-budget candidates whose greedy walk still
    # completes within the first few magnitude-ordered slots: n_required is
    # small, so the small budget is exact and stays sticky.
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    res = analyze_epoch(x[None], 500.0, mode="flexible")
    assert int(np.max(np.asarray(res.n_candidates))) > 64
    assert P._dynamic_budget[(4096, "flexible")] <= 64
    flat = analyze_epoch(x[None], 500.0, mode="flexible", max_candidates=2048)
    assert _idx(res) == _idx(flat) == _oracle(x, 500.0, "flexible")


def test_adaptive_single_window_matches_oracle(fresh_budgets):
    fs = 500.0
    for x in (_window(1024, fs, seed=11), _window(1024, fs, seed=12, kind="noise")):
        res = analyze_epoch(x[None], fs, mode="adaptive")
        assert _idx(res) == _oracle(x, fs, "adaptive")
