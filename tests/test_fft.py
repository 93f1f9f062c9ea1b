"""FFT front-end: centering/padding semantics and backend accuracy."""

import numpy as np
import jax.numpy as jnp
import pytest

from apda_fft_tpu.ops import fft as fft_ops
from tests.oracle import oracle_spectrum
from tests.signals import modal_signal


def test_next_pow2():
    assert fft_ops.next_pow2(1) == 1
    assert fft_ops.next_pow2(2) == 2
    assert fft_ops.next_pow2(1000) == 1024
    assert fft_ops.next_pow2(1024) == 1024
    assert fft_ops.next_pow2(1025) == 2048


def test_center_and_pad_matches_oracle_centering():
    x = modal_signal(1000, 500.0, seed=1)
    out = fft_ops.center_and_pad(jnp.asarray(x[None, :], jnp.float64), 1024)
    import statistics

    med = statistics.median([float(v) for v in x])
    expect = np.concatenate([x - med, np.zeros(24)])
    np.testing.assert_allclose(np.asarray(out[0]), expect, rtol=0, atol=0)


def test_center_and_pad_ragged_lengths():
    x = modal_signal(1024, 500.0, seed=2)
    full = np.asarray(x, np.float64)
    # Row 0 uses only the first 700 samples; row 1 the full 1024.
    batch = jnp.asarray(np.stack([full, full]), jnp.float64)
    out = fft_ops.center_and_pad(batch, 1024, jnp.asarray([700, 1024]))
    import statistics

    med700 = statistics.median([float(v) for v in full[:700]])
    np.testing.assert_allclose(np.asarray(out[0, :700]), full[:700] - med700, atol=0)
    assert np.all(np.asarray(out[0, 700:]) == 0)


@pytest.mark.parametrize("n", [256, 1024, 4096, 8192, 65536])
@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_fullspec_accuracy_f32(n, backend):
    """BASELINE.md contract: spectra <=1e-6 relative error vs numpy.fft.

    Gated at the contract bound itself (normwise L2, the standard relative-
    error reading); f64-computed tables keep the error flat in log N.  The
    per-N table on the device is ``benchmarks/accuracy.py``, and
    ``chip_smoke.py`` gates it on the GPU.
    """
    x = modal_signal(n, 500.0, seed=n % 7)
    spec = fft_ops.full_spectrum(jnp.asarray(x[None, :], jnp.float32), backend=backend)
    ref = np.fft.fft(x.astype(np.float64))
    ref[0] = 0
    err = np.linalg.norm(np.asarray(spec[0]) - ref) / np.linalg.norm(ref)
    assert err < 1e-6, f"normwise relative error {err} at N={n} backend={backend}"
    # Secondary: normalized max-abs (peak-scale worst bin).  Wider than the
    # contract bound because single-bin error is accumulation-order dependent
    # (CPU einsum hits 4.3e-6 at N=65536).
    err_max = np.max(np.abs(np.asarray(spec[0]) - ref)) / np.max(np.abs(ref))
    assert err_max < 5e-6, f"peak-normalized max error {err_max} at N={n}"


@pytest.mark.parametrize("n", [1024, 4096])
def test_fullspec_exact_f64(n):
    x = modal_signal(n, 500.0, seed=3)
    ref = oracle_spectrum(x)
    centered = fft_ops.center_and_pad(jnp.asarray(x[None, :], jnp.float64), n)
    spec = fft_ops.full_spectrum(centered, backend="xla")
    err = np.max(np.abs(np.asarray(spec[0]) - ref)) / np.max(np.abs(ref))
    assert err < 1e-12


@pytest.mark.parametrize("n", [16, 1024, 4096, 65536])
def test_rfft_packed_accuracy(n):
    """Packed (N/2-complex) rfft matches numpy float64 to f32 roundoff.

    Kept as a tested cross-check: it measured slower than the plain
    half-output four-step on the earlier chip (not measured on the GPU), so
    the plain path stays the shipped backend.
    """
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = fft_ops.rfft_packed_matmul(jnp.asarray(x))
    got = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.rfft(x.astype(np.float64))[:, : n // 2]
    err = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert err.max() < 1e-6, f"normwise relative error {err.max()} at N={n}"


@pytest.mark.parametrize("n", [1024, 4096, 65536])
def test_halfspec_magnitudes_backends_agree(n):
    x = modal_signal(n, 250.0, seed=5)
    w = jnp.asarray(x[None, :], jnp.float32)
    m_xla = np.asarray(fft_ops.halfspec_magnitudes(w, backend="xla")[0])
    m_mm = np.asarray(fft_ops.halfspec_magnitudes(w, backend="matmul")[0])
    assert m_xla.shape == (n // 2,)
    assert m_xla[0] == 0 and m_mm[0] == 0
    scale = np.max(m_xla)
    atol = 2e-6 if n <= 4096 else 8e-6  # f32 FFT error grows ~sqrt(log N)
    np.testing.assert_allclose(m_xla / scale, m_mm / scale, atol=atol)
