"""The XLA prominence detector at small candidate budgets vs a flat budget.

The dynamic budget runs the detector at a few candidate slots (2..128) and
relies on one contract: a window whose greedy walk completed within the
budget (``n_required <= budget``) has exactly the decisions of an unbounded
run, and every other window says so through ``n_required``.  These pin that
contract at the budgets and spectrum shapes the noisy and clean epochs
use, against a flat budget of 256 - for the flat budget, the two-tier
split, and the full finalize (damping, Q, frequency).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apda_fft_tpu.models.pipeline import _flex_detect, detect_from_mags
from apda_fft_tpu.ops.peaks_prominence import prominence_peaks

FLAT = 256
KINDS = ("modal", "noise", "flat", "ties")


def _spectra(b, h, seed, kind="modal"):
    """Half-spectrum magnitudes with a zeroed DC bin, float32."""
    rng = np.random.default_rng(seed)
    bins = np.arange(h, dtype=np.float64)
    if kind == "modal":
        x = np.zeros((b, h))
        for w in range(b):
            for _ in range(rng.integers(1, 5)):
                c = rng.uniform(4, h - 4)
                width = rng.uniform(0.8, 6.0)
                amp = rng.uniform(1.0, 40.0)
                x[w] += amp * np.exp(-0.5 * ((bins - c) / width) ** 2)
        x += rng.uniform(0.0, 0.3) * rng.random((b, h))
    elif kind == "noise":
        x = rng.random((b, h)) * 5.0
    elif kind == "flat":
        x = np.full((b, h), 2.5)
    else:  # ties: quantized so rounded-magnitude ties are everywhere
        x = np.round(rng.random((b, h)) * 30.0) / 10.0
    x[:, 0] = 0.0
    return jnp.asarray(x, jnp.float32)


def _detect(mags, budget, n_fft, k=4, fs=500.0):
    return jax.vmap(
        lambda m: prominence_peaks(m, jnp.float32(fs), n_fft, k=k,
                                   max_candidates=budget)
    )(mags)


def _assert_exact_rows(small, flat, budget):
    """Rows that completed within ``budget`` decide like the flat run;
    the others report it.  Returns the number of exact rows."""
    n_req = np.asarray(small.n_required)
    np.testing.assert_array_equal(np.asarray(small.n_candidates),
                                  np.asarray(flat.n_candidates))
    flat_exact = np.asarray(flat.n_required) <= FLAT
    exact = (n_req <= budget) & flat_exact
    for name in ("count", "idx"):
        np.testing.assert_array_equal(np.asarray(getattr(small, name))[exact],
                                      np.asarray(getattr(flat, name))[exact], name)
    for name in ("freq", "mag", "damping", "q_factor"):
        np.testing.assert_allclose(np.asarray(getattr(small, name))[exact],
                                   np.asarray(getattr(flat, name))[exact],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (n_req[~exact & flat_exact] > budget).all()
    return int(exact.sum())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h", [128, 512])
def test_budget16_matches_flat_budget(kind, h):
    mags = _spectra(24, h, seed=1000 * KINDS.index(kind) + h, kind=kind)
    small = _detect(mags, 16, 2 * h)
    flat = _detect(mags, FLAT, 2 * h)
    exact = _assert_exact_rows(small, flat, 16)
    if kind in ("modal", "flat"):
        assert exact == 24  # clean spectra never need more than 16 slots


@pytest.mark.parametrize("budget", [12, (8, 16, 3)])
def test_flex_detect_budget_forms_match_flat(budget):
    """The detect stage at a flat budget and at the two-tier split
    (small pass for all, big pass for the <= 3 stragglers) keeps the
    exactness contract."""
    h = 256
    mags = _spectra(12, h, seed=5, kind="modal")
    fs_flat = jnp.full((12,), 500.0, jnp.float32)
    got = _flex_detect(mags, fs_flat, n_fft=2 * h, k=4, max_candidates=budget)
    flat = _flex_detect(mags, fs_flat, n_fft=2 * h, k=4, max_candidates=FLAT)
    big = budget if isinstance(budget, int) else budget[1]
    assert _assert_exact_rows(got, flat, big) == 12


@pytest.mark.parametrize("kind", ["modal", "noise"])
def test_full_detector_at_budget12_matches_flat(kind):
    h, m = 256, 12
    mags = _spectra(17, h, seed=KINDS.index(kind), kind=kind)
    small = _detect(mags, m, 2 * h)
    flat = _detect(mags, FLAT, 2 * h)
    _assert_exact_rows(small, flat, m)


def test_budget_clamps_to_spectrum_length():
    # max_candidates > H clamps to H and still runs exactly.
    mags = _spectra(4, 128, seed=11, kind="noise")
    res = _detect(mags, 4096, 256)
    assert res.idx.shape == (4, 4)
    assert (np.asarray(res.n_required) <= 128).all()


def test_flat_spectrum_has_no_candidates():
    mags = _spectra(6, 128, seed=3, kind="flat")
    res = _detect(mags, 8, 256)
    np.testing.assert_array_equal(np.asarray(res.n_candidates), np.zeros(6))
    np.testing.assert_array_equal(np.asarray(res.count), np.zeros(6))


def test_unaligned_spectrum_length_is_supported():
    # H=96 (no power of two, no 128 multiple) runs the same detector.
    mags = _spectra(8, 96, seed=9, kind="modal")
    assert _assert_exact_rows(_detect(mags, 8, 192), _detect(mags, FLAT, 192), 8) > 0


def test_detect_from_mags_dynamic_matches_flat():
    mags = _spectra(64, 512, seed=21, kind="noise")
    dyn = detect_from_mags(mags, 500.0, n_fft=1024, mode="flexible", refine=False)
    flat = detect_from_mags(mags, 500.0, n_fft=1024, mode="flexible",
                            max_candidates=512, refine=False)
    np.testing.assert_array_equal(np.asarray(dyn.count), np.asarray(flat.count))
    np.testing.assert_array_equal(np.asarray(dyn.idx), np.asarray(flat.idx))
