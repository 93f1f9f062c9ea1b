"""Golden-trace parity: device detectors vs the float64 reference oracle.

The BASELINE.json gate is "peak frequencies bit-matched" to the reference.
Peak *indices* are the actual decisions; when indices match, frequencies
recomputed on host in float64 match the reference bit-for-bit.  These tests
assert exact index/count agreement across a randomized corpus, plus tolerance
agreement on magnitudes/damping (float32 vs float64 arithmetic).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from apda_fft_tpu import analyze_epoch
from tests.oracle import oracle_analyze
from tests.signals import modal_signal

CORPUS = [
    # (n_samples, fs, seed)
    (1024, 500.0, 0),
    (1024, 250.0, 1),
    (1000, 500.0, 2),  # ragged -> pad to 1024
    (4096, 500.0, 3),
    (4096, 100.0, 4),
    (4096, 250.0, 5),
    (2048, 62.5, 6),
    (4096, 500.0, 7),
    (4096, 500.0, 8),
    (1024, 125.0, 9),
    (4096, 31.25, 10),
    (8192, 500.0, 11),
    (16384, 500.0, 12),
    (65536, 500.0, 13),  # BASELINE config-5 scale; exercises budget auto-growth
]


def _run_device(x, fs, mode, dtype):
    n = len(x)
    n_fft = 1 << (n - 1).bit_length()
    if n == n_fft:
        res = analyze_epoch(x[None, :], fs, mode=mode, dtype=dtype)
    else:
        padded = np.zeros(n_fft)
        padded[:n] = x
        res = analyze_epoch(
            padded[None, :], fs, mode=mode, lengths=np.array([n]), dtype=dtype
        )
    return res, n_fft


@pytest.mark.parametrize("mode", ["flexible", "rigid"])
@pytest.mark.parametrize("case", CORPUS, ids=[f"n{c[0]}_fs{c[1]}_s{c[2]}" for c in CORPUS])
def test_peak_indices_match_oracle_f32(case, mode):
    n, fs, seed = case
    x = modal_signal(n, fs, seed=seed)
    ref = oracle_analyze(x, fs, mode=mode)
    res, n_fft = _run_device(x, fs, mode, jnp.float32)

    got_count = int(res.count[0])
    got_idx = [int(i) for i in np.asarray(res.idx[0])[:got_count]]
    ref_idx = [p["idx"] for p in ref]
    assert got_idx == ref_idx, f"peak indices diverge: got {got_idx} want {ref_idx}"
    assert got_count == len(ref)

    # Host-finished frequencies are bit-identical once indices agree.
    for slot, p in enumerate(ref):
        if mode == "flexible":
            assert round(got_idx[slot] * fs / n_fft, 4) == p["freq"]
        else:
            assert got_idx[slot] * (fs / n_fft) == p["freq"]
        got_mag = float(res.mag[0, slot])
        assert got_mag == pytest.approx(p["mag"], rel=2e-5, abs=1e-4)
        if mode == "flexible":
            assert float(res.damping[0, slot]) == pytest.approx(p["damping"], abs=0.02)
            assert float(res.q_factor[0, slot]) == pytest.approx(p["q-factor"], rel=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["flexible", "rigid"])
def test_randomized_sweep_f32(mode):
    """Wider randomized sweep: every window's decisions must match the oracle."""
    mismatches = []
    for seed in range(30):
        fs = [100.0, 250.0, 500.0][seed % 3]
        n = [1024, 2048, 4096][seed % 3]
        x = modal_signal(n, fs, seed=100 + seed)
        ref = oracle_analyze(x, fs, mode=mode)
        res, _ = _run_device(x, fs, mode, jnp.float32)
        got = [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]
        want = [p["idx"] for p in ref]
        if got != want:
            mismatches.append((seed, n, fs, got, want))
    assert not mismatches, f"{len(mismatches)}/30 windows diverged: {mismatches}"


@pytest.mark.parametrize("mode", ["flexible", "rigid"])
def test_exact_mode_f64(mode):
    """float64 device math must match the oracle decisions exactly."""
    for seed in (0, 1, 2, 3, 4):
        x = modal_signal(4096, 500.0, seed=seed)
        ref = oracle_analyze(x, 500.0, mode=mode)
        res, _ = _run_device(x, 500.0, mode, jnp.float64)
        got = [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]
        assert got == [p["idx"] for p in ref]


def test_no_peaks_on_pure_noise_threshold():
    """A flat spectrum (constant signal) yields zero peaks, no crash."""
    x = np.zeros(1024)
    res = analyze_epoch(x[None, :], 500.0, mode="flexible")
    assert int(res.count[0]) == 0
    res = analyze_epoch(x[None, :], 500.0, mode="rigid")
    assert int(res.count[0]) == 0


def test_selection_paths_agree_on_ties():
    """topk+lexsort candidate selection == stable argsort, incl. duplicate mags."""
    import jax.numpy as jnp
    from apda_fft_tpu.ops.peaks_prominence import prominence_peaks

    h = 512
    rng = np.random.default_rng(7)
    mags = rng.uniform(0.0, 1.0, h)
    # plant exactly-equal local maxima well above threshold
    for j in (50, 100, 200, 300, 400):
        mags[j - 1 : j + 2] = [1.0, 30.0, 1.0]
    for j in (150, 250):
        mags[j - 1 : j + 2] = [1.0, 45.0, 1.0]
    mags[0] = 0.0
    m = jnp.asarray(mags, jnp.float32)
    a = prominence_peaks(m, 500.0, 1024, selection="topk")
    b = prominence_peaks(m, 500.0, 1024, selection="sort")
    assert int(a.count) == int(b.count)
    np.testing.assert_array_equal(np.asarray(a.idx), np.asarray(b.idx))


@pytest.mark.slow
def test_scan_impls_agree_exhaustively():
    """Sparse-table doubling scans == masked reductions on adversarial spectra."""
    from apda_fft_tpu.ops.peaks_prominence import prominence_peaks

    rng = np.random.default_rng(3)
    cases = []
    for seed in range(12):
        h = [64, 128, 512][seed % 3]
        m = rng.uniform(0, 1, h)
        # adversarial structure: plateaus, exact ties, monotone runs, spikes
        m[h // 4 : h // 4 + 5] = 0.8
        m[h // 2] = 5.0
        m[h // 2 + 2] = 5.0
        m[3 * h // 4 :] = np.linspace(1.2, 0.0, h - 3 * h // 4)
        m[0] = 0.0
        cases.append(m)
    for i, m in enumerate(cases):
        mj = jnp.asarray(m, jnp.float32)
        a = prominence_peaks(mj, 500.0, 2 * len(m), scan_impl="sparse")
        b = prominence_peaks(mj, 500.0, 2 * len(m), scan_impl="masked")
        assert int(a.count) == int(b.count), i
        np.testing.assert_array_equal(np.asarray(a.idx), np.asarray(b.idx), err_msg=str(i))
        np.testing.assert_array_equal(np.asarray(a.prominence), np.asarray(b.prominence))
        np.testing.assert_array_equal(np.asarray(a.damping), np.asarray(b.damping))


def test_noisy_long_windows_exceed_static_budget():
    """Seeds that overflow a fixed 32-candidate budget (found on the device):
    the auto-scaled budget keeps decisions exact."""
    from apda_fft_tpu.models.pipeline import default_max_candidates

    assert default_max_candidates(4096) == 32
    assert default_max_candidates(8192) == 64
    assert default_max_candidates(65536) == 512
    for seed in (3, 7, 19):
        x = modal_signal(8192, 62.5, seed=300 + seed)
        ref = oracle_analyze(x, 62.5, mode="flexible")
        res = analyze_epoch(x[None, :], 62.5, mode="flexible")
        got = [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]
        assert got == [p["idx"] for p in ref], seed
        # the diagnostic exposes the pre-budget candidate count
        assert int(res.n_candidates[0]) > 32


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["xla"])
def test_alternate_backends_decision_parity(backend):
    """The non-default FFT backend must produce the same peak decisions as
    the float64 oracle on representative corpus cases (the parity gate runs
    the matmul default; spectra-level accuracy alone doesn't pin decisions)."""
    for n, fs, seed in [(1024, 500.0, 0), (4096, 500.0, 3), (2048, 62.5, 6)]:
        x = modal_signal(n, fs, seed=seed)
        for mode in ("flexible", "rigid"):
            ref = oracle_analyze(x, fs, mode=mode)
            res = analyze_epoch(x[None, :], fs, mode=mode, backend=backend)
            got = [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]
            assert got == [p["idx"] for p in ref], (backend, mode, n, seed)


def test_n_required_is_the_smallest_exact_budget():
    """The n_required contract that the dynamic budget relies on: (a) running
    at max_candidates == n_required reproduces the unbounded decisions
    exactly; (b) at any smaller budget the result self-reports n_required >
    budget (so the dynamic loop always detects the truncation and re-runs);
    (c) n_required <= n_candidates."""
    for seed, n, fs in [(7, 4096, 500.0), (11, 4096, 250.0), (3, 8192, 62.5)]:
        rng = np.random.default_rng(seed)
        x = (
            modal_signal(n, fs, seed=seed)
            + 0.3 * rng.standard_normal(n)
        ).astype(np.float32)
        full = analyze_epoch(x[None], fs, mode="flexible",
                             max_candidates=n // 2)
        nreq = int(full.n_required[0])
        ncand = int(full.n_candidates[0])
        assert 1 <= nreq <= ncand
        ref = oracle_analyze(x, fs, mode="flexible")
        want = [p["idx"] for p in ref]
        for budget in (nreq, nreq + 3):
            res = analyze_epoch(x[None], fs, mode="flexible",
                                max_candidates=budget)
            got = [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]
            assert got == want, (seed, budget)
            assert int(res.n_required[0]) == nreq
        if nreq > 1:
            trunc = analyze_epoch(x[None], fs, mode="flexible",
                                  max_candidates=nreq - 1)
            assert int(trunc.n_required[0]) > nreq - 1


def test_finalize_slot_equals_candidate_walk(monkeypatch):
    """The slot-wise greedy finalize (k rounds) is decision-identical to the
    per-candidate walk (M rounds) on adversarial spectra: rounding-tie-heavy
    magnitudes, near-zero magnitudes (the ratio-0 shoulder path), and
    non-dyadic rates.  Exactness argument in ``prominence_finalize``: the
    shoulder-rejection test depends only on the already-accepted set, which is
    identical for every candidate visited between two acceptances.
    """
    import jax

    from apda_fft_tpu.ops import peaks_prominence as pp

    rng = np.random.default_rng(7)
    b, h, m = 192, 256, 32
    mags = np.abs(rng.standard_normal((b, h))).astype(np.float32)
    mags[: b // 3] = np.round(mags[: b // 3], 3)  # many 4-dp rounding ties
    mags[b // 3 : 2 * b // 3] *= 1e-5  # magnitudes that round to 0 at 4 dp
    mags[:, 0] = 0.0
    fs = rng.choice([500.0, 100.0, 99.7, 256.0], size=(b,)).astype(np.float32)

    def run(m_arr, f_arr):
        return jax.jit(
            jax.vmap(
                lambda mm, ff: pp.prominence_peaks(mm, ff, 2 * h, max_candidates=m)
            )
        )(m_arr, f_arr)

    assert m > pp._UNROLL_MAX  # default path below is the slot form
    res_slot = run(jnp.asarray(mags), jnp.asarray(fs))
    monkeypatch.setattr(pp, "_UNROLL_MAX", 10**9)  # force the candidate walk
    res_walk = run(jnp.asarray(mags), jnp.asarray(fs))
    for name, a, c in zip(res_slot._fields, res_slot, res_walk):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(c), err_msg=f"field {name}"
        )


def test_adaptive_decisions_match_composed_oracle():
    """Adaptive mode (BASELINE config 2) vs the composed float64 oracle:
    prominence decisions where it accepts, resolution fallback where it
    rejects everything - per window, exact index agreement."""
    fs = 500.0
    n = 1024
    rng = np.random.default_rng(77)
    t = np.arange(n) / fs
    windows = [
        modal_signal(n, fs, seed=20),                       # flex succeeds
        np.sin(2 * np.pi * (3 * fs / n) * t) * 5.0,  # low-bin tone: damping
        # 1/(2*3) = 16.7% > 7% band -> prominence rejects, resolution keeps
        modal_signal(n, fs, seed=21),
        rng.standard_normal(n) * 0.5,                       # noise
    ]
    fell_back = 0
    for x in windows:
        x = np.asarray(x, np.float32)
        ref = oracle_analyze(x, fs, mode="adaptive")
        flex_ref = oracle_analyze(x, fs, mode="flexible")
        fell_back += 0 if flex_ref else 1
        res = analyze_epoch(x[None, :], fs, mode="adaptive")
        got = [int(i) for i in np.asarray(res.idx[0])[: int(res.count[0])]]
        assert got == [p["idx"] for p in ref]
    assert fell_back >= 1, "corpus no longer exercises the fallback branch"
