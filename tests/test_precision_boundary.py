"""The damping==MIN_DAMPING decision boundary, now EXACT (docs/DESIGN.md).

``tests/data/noise_damping_boundary_8192.npy`` is a pure-noise window
(found by randomized on-device fuzz, 2026-08-16) whose third-ranked peak has
damping ``bins/(2*idx) = 2/2000`` - exactly ON the MIN_DAMPING=0.1% filter
edge.  In round 2 the f32 filter compared ``1/(2*q) >= f32(0.001)``, whose
landing depended on platform reduction order: the accelerator pipeline
rejected the peak while CPU f32 and the float64 oracle accepted it - the
one carried fuzz miss (449/450).

Round 3 removed the flip at its root: damping's acceptance band is now the
EXACT integer comparison ``500*bins >= idx`` / ``50*bins <= 7*idx`` (the
``ds`` factors of ``q = (idx*ds)/(bins*ds)`` cancel), swept identical to
the reference's float64 chain over every (idx, bins) pair for every dyadic
rate (``ops/peaks_prominence.py prominence_finalize``).  What this fixture
now pins:

1. the f32 decisions equal the float64 oracle on the boundary window - on
   every platform, no characterized landing pair anymore;
2. at a 64-slot budget the window's 135 candidates are truncated, yet its
   greedy walk completes within the budget, so the decisions stay exact;
3. float64 still matches the oracle (the divergence was precision, and is
   now closed, not re-characterized).
"""

import os

import numpy as np
import pytest

from apda_fft_tpu.models.pipeline import analyze_epoch

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "noise_damping_boundary_8192.npy")
FS = 250.0
ORACLE_DECISIONS = [930, 416, 1000, 788]  # boundary peak accepted (d == 0.1% exactly)


def _idx(res):
    return [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]


def test_f32_matches_oracle_on_boundary_window():
    x = np.load(FIXTURE)
    batched = analyze_epoch(x[None], FS, mode="flexible")
    assert _idx(batched) == ORACLE_DECISIONS


def test_boundary_peak_is_exactly_on_the_edge():
    # The fixture stays meaningful only while the peak sits ON the boundary:
    # its width is 2 bins at idx 1000, so damping is exactly 2/2000 = 0.001.
    from tests.oracle import (
        _flank_valley, _half_power_bins, half_magnitudes, oracle_spectrum,
    )

    x = np.load(FIXTURE)
    mags = half_magnitudes(oracle_spectrum(x))
    j = 1000
    prom = mags[j] - max(_flank_valley(mags, j, -1), _flank_valley(mags, j, 1))
    assert _half_power_bins(mags, j, prom) == 2


def test_window_completes_within_budget_64_despite_candidate_overflow():
    # 135 pre-budget candidates, but the greedy walk reaches its 4th
    # acceptance after 21 magnitude-ordered slots: n_required=21 <= 64, so
    # the decisions at a 64-slot budget are exact and the dynamic budget
    # keeps them without a re-run.
    x = np.load(FIXTURE)
    res = analyze_epoch(x[None], FS, mode="flexible", max_candidates=64)
    assert int(res.n_candidates[0]) > 64  # 135: budget truncated the walk...
    assert int(res.n_required[0]) <= 64  # ...but the top-k was already decided
    assert _idx(res) == ORACLE_DECISIONS


@pytest.mark.slow
def test_f64_matches_oracle_on_boundary_window():
    from tests.oracle import oracle_analyze

    x = np.load(FIXTURE)
    ref = oracle_analyze(x, FS, mode="flexible")
    assert [p["idx"] for p in ref] == ORACLE_DECISIONS
    res = analyze_epoch(x[None].astype(np.float64), FS, mode="flexible",
                        dtype=np.float64)
    assert _idx(res) == ORACLE_DECISIONS
