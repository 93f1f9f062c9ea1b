"""Tests that need an NVIDIA GPU; they skip on the CPU.

Run on the card with ``python chip_smoke.py`` (its first phase runs
``pytest -m gpu tests/test_gpu.py`` alone on the card).  Whether a GPU is
present is decided in the ``gpu`` fixture at run time - never at import or
collection - so every pytest-xdist worker collects the same tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]


def _centered(rng, b, n):
    x = rng.standard_normal((b, n)) + np.sin(2 * np.pi * 0.0123 * np.arange(n))
    return (x - np.median(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.gpu
def test_highest_precision_matmul_is_full_f32(gpu):
    """Precision.HIGHEST keeps f32 products out of TF32 on the card."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST), np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["matmul", "xla"])
@pytest.mark.parametrize("n", [1024, 65536])
def test_spectrum_contract_on_gpu(gpu, backend, n):
    from apda_fft_tpu.ops.fft import halfspec_magnitudes

    x = _centered(np.random.default_rng(n), 4, n)
    want = np.abs(np.fft.fft(x.astype(np.float64), axis=-1))[:, : n // 2]
    want[:, 0] = 0
    got = np.asarray(halfspec_magnitudes(jnp.asarray(x), backend=backend), np.float64)
    err = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert err.max() <= 1e-6, err


@pytest.mark.gpu
def test_csd_matrix_is_full_precision_on_gpu(gpu):
    """The FDD cross-spectral contraction at HIGHEST agrees with the same
    computation in float64 (TF32 would be off by ~1e-3)."""
    from apda_fft_tpu.models.modal import csd_matrix

    x = np.random.default_rng(3).standard_normal((4, 16384))
    _, gr, gi = csd_matrix(x.astype(np.float32), 256.0, 1024)
    _, gr64, gi64 = csd_matrix(x, 256.0, 1024, dtype=jnp.float64)
    got = np.asarray(gr, np.float64) + 1j * np.asarray(gi, np.float64)
    want = np.asarray(gr64) + 1j * np.asarray(gi64)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["flexible", "rigid"])
def test_epoch_decisions_match_oracle_on_gpu(gpu, mode):
    from apda_fft_tpu.models.pipeline import analyze_epoch
    from tests.oracle import oracle_analyze
    from tests.signals import modal_signal

    fs = 500.0
    xs = np.stack([modal_signal(4096, fs, seed=s) for s in range(16)]).astype(np.float32)
    res = analyze_epoch(xs, fs, mode=mode)
    for r in range(xs.shape[0]):
        want = [p["idx"] for p in oracle_analyze(xs[r], fs, mode=mode)]
        got = [int(i) for i in np.asarray(res.idx[r])[: int(res.count[r])]]
        assert got == want, r
