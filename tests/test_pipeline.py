"""Epoch pipeline: batching, vmap shapes, ragged windows, refinement, metrics."""

import numpy as np
import jax.numpy as jnp

from apda_fft_tpu import PipelineConfig, SpectralPipeline, analyze_epoch
from tests.oracle import oracle_analyze
from tests.signals import modal_signal, two_mode_signal


def test_batch_shapes_channels_windows():
    """[channels, windows, N] epochs keep their leading shape."""
    xs = np.stack(
        [
            np.stack([modal_signal(1024, 500.0, seed=10 * c + w) for w in range(3)])
            for c in range(2)
        ]
    )
    res = analyze_epoch(xs, 500.0, mode="flexible")
    assert res.count.shape == (2, 3)
    assert res.freq.shape == (2, 3, 4)
    # Every window must individually match the oracle.
    for c in range(2):
        for w in range(3):
            ref = oracle_analyze(xs[c, w], 500.0, mode="flexible")
            got = [int(i) for i in np.asarray(res.idx[c, w])[: int(res.count[c, w])]]
            assert got == [p["idx"] for p in ref]


def test_per_window_fs():
    """fs can vary per window; frequencies scale accordingly."""
    x = two_mode_signal(4096, 500.0)
    res = analyze_epoch(np.stack([x, x]), np.array([500.0, 250.0]), mode="flexible")
    assert int(res.count[0]) >= 1 and int(res.count[1]) >= 1
    # Same samples at half the sampling rate -> half the reported frequency.
    f0, f1 = float(res.freq[0, 0]), float(res.freq[1, 0])
    assert abs(f0 - 2 * f1) < 1e-2


def test_two_mode_signal_recovers_known_modes():
    """BASELINE.md check: both injected modes recovered at N=4096, fs=500."""
    x = two_mode_signal(4096, 500.0)
    res = analyze_epoch(x[None], 500.0, mode="flexible")
    freqs = sorted(float(f) for f in np.asarray(res.freq[0])[: int(res.count[0])])
    assert any(abs(f - 12.3291) < 0.001 for f in freqs), freqs
    assert any(abs(f - 47.7295) < 0.001 for f in freqs), freqs


def test_refine_subbin_improves_frequency():
    """Parabolic interpolation lands closer to the true mode than the raw bin."""
    true_f = 12.34
    x = modal_signal(4096, 500.0, modes=[(true_f, 1.0, 0.01)], noise=0.01, seed=7)
    res = analyze_epoch(x[None], 500.0, mode="flexible", refine=True)
    assert int(res.count[0]) >= 1
    raw = float(res.freq[0, 0])
    refined = float(res.refined_freq[0, 0])
    assert abs(refined - true_f) <= abs(raw - true_f) + 1e-6
    assert abs(refined - true_f) < 0.06  # within half a bin


def test_rigid_mode_k5():
    x = modal_signal(4096, 500.0, seed=3)
    res = analyze_epoch(x[None], 500.0, mode="rigid")
    assert res.idx.shape == (1, 5)


def test_pipeline_class_and_metrics():
    pipe = SpectralPipeline(PipelineConfig(mode="flexible"))
    x = modal_signal(1024, 250.0, seed=9)
    res = pipe(x[None], 250.0)
    assert res.count.shape == (1,)
    # Reference-shaped self-profiling metrics (GT_FFT_v5.py:663-676 parity).
    for key in ("process_time", "wall_time", "percentage_cpu", "memrss"):
        assert key in pipe.last_metrics
    assert pipe.last_metrics["wall_time"] > 0


def test_gateway_flag_mapping():
    assert PipelineConfig.from_gateway_flag(True).mode == "flexible"
    assert PipelineConfig.from_gateway_flag(False).mode == "rigid"


def test_top_peak_helpers():
    x = np.zeros(1024)
    res = analyze_epoch(x[None], 500.0)
    assert float(res.top_peak_freq()[0]) == -1.0
    assert float(res.top_peak_mag()[0]) == -1.0


def test_adaptive_mode_falls_back_per_window():
    """Adaptive = prominence, with per-window resolution fallback when empty."""
    fs = 500.0
    # window A: clean modal signal -> prominence finds peaks
    a = modal_signal(1024, fs, modes=[(20.0, 1.0, 0.01)], seed=1)
    # window B: extremely sharp single tone exactly on a bin -> width 1 bin at
    # high frequency gives damping < 0.1% -> prominence rejects; resolution keeps.
    t = np.arange(1024) / fs
    b = np.sin(2 * np.pi * (200 * fs / 1024) * t) * 5.0
    batch = np.stack([a, b])

    flex = analyze_epoch(batch, fs, mode="flexible")
    rig = analyze_epoch(batch, fs, mode="rigid", k=4)
    adap = analyze_epoch(batch, fs, mode="adaptive")

    assert int(flex.count[0]) > 0
    if int(flex.count[1]) == 0:  # the intended fallback scenario
        assert int(adap.count[1]) == int(rig.count[1]) > 0
        np.testing.assert_array_equal(np.asarray(adap.idx[1]), np.asarray(rig.idx[1]))
    np.testing.assert_array_equal(np.asarray(adap.idx[0]), np.asarray(flex.idx[0]))
    assert int(adap.count[0]) == int(flex.count[0])


def test_batch_chunking_equivalence():
    """Chunked large epochs produce identical results to the unchunked path."""
    xs = np.stack([modal_signal(512, 250.0, seed=s) for s in range(10)])
    a = analyze_epoch(xs, 250.0, mode="flexible")  # batch_chunk default off (B<=1024)
    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl
    import jax.numpy as jnp

    b = _analyze_epoch_impl(
        jnp.asarray(xs, jnp.float32), jnp.float32(250.0), None,
        n_fft=512, mode="flexible", k=4, backend="xla", max_candidates=32,
        refine=False, has_lengths=False, batch_chunk=4,  # forces 3 chunks + pad
    )
    np.testing.assert_array_equal(np.asarray(a.count), np.asarray(b.count))
    np.testing.assert_array_equal(np.asarray(a.idx), np.asarray(b.idx))
    np.testing.assert_array_equal(np.asarray(a.freq), np.asarray(b.freq))


def test_analyze_records_buckets_and_order():
    """Ragged records bucket by pow2 length and come back in input order."""
    from apda_fft_tpu.models.batching import analyze_records

    recs = [
        (modal_signal(1000, 500.0, seed=1), 500.0),   # -> 1024 bucket
        (modal_signal(4096, 250.0, seed=2), 250.0),   # -> 4096 bucket
        (modal_signal(900, 500.0, seed=3), 500.0),    # -> 1024 bucket
    ]
    out = analyze_records(recs, mode="flexible")
    assert [rp.n_fft for rp in out] == [1024, 4096, 1024]
    # per-record results equal the direct ragged analyze_epoch call
    for (samples, fs), rp in zip(recs, out):
        n = rp.n_fft
        padded = np.zeros(n, np.float32)
        padded[: len(samples)] = samples
        direct = analyze_epoch(padded[None], fs, n_fft=n,
                               lengths=np.array([len(samples)]), mode="flexible")
        assert rp.count == int(direct.count[0])
        for s in range(rp.count):
            assert rp.peak(s)["idx"] == int(direct.idx[0, s])
            assert rp.exact_freq(s, "flexible") == round(
                int(direct.idx[0, s]) * fs / n, 4
            )
    import pytest as _pytest

    with _pytest.raises(ValueError, match="empty"):
        analyze_records([(np.zeros(0), 500.0)])


def test_dynamic_budget_overflow_matches_unbounded():
    """Noise-only spectra exceed the old static-32 budget at N=4096; the
    dynamic default must regrow until exact and match a huge static budget."""
    import jax

    from apda_fft_tpu.models import pipeline as P

    rng = np.random.default_rng(7)
    noise = (0.05 * rng.standard_normal((8, 4096))).astype(np.float32)
    P._dynamic_budget.clear()
    dyn = analyze_epoch(noise, 500.0, mode="flexible")
    big = analyze_epoch(noise, 500.0, mode="flexible", max_candidates=1024)
    assert int(np.max(np.asarray(dyn.n_candidates))) > 32
    for a, b in zip(dyn, big):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # Sticky: the remembered power-of-two budget covers n_required (the
    # smallest exact budget) - which on noise is usually far below the
    # pre-budget candidate count, so noisy epochs stay cheap.
    cached = P._dynamic_budget[(4096, "flexible")]
    assert cached >= int(np.max(np.asarray(dyn.n_required)))
    assert cached & (cached - 1) == 0

    # Under an outer trace the dynamic readback is impossible: None falls
    # back to the static default, an explicit "dynamic" raises.
    jitted = jax.jit(lambda s: analyze_epoch(s, 500.0, mode="flexible"))
    res = jitted(noise)
    assert res.count.shape == (8,)
    import pytest

    with pytest.raises(ValueError, match="outer jit"):
        jax.jit(
            lambda s: analyze_epoch(s, 500.0, mode="flexible", max_candidates="dynamic")
        )(noise)


def test_adaptive_host_fallback_matches_traced_path():
    """The two-pass adaptive default (flexible pass + on-demand rigid
    fallback) must be elementwise-identical to the single-program adaptive
    branch, with and without fallback windows in the batch."""
    import functools

    import jax

    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl

    rng = np.random.default_rng(3)
    t = np.arange(1024) / 500.0
    peaky = np.sin(2 * np.pi * 12.3 * t) + 0.05 * rng.standard_normal(1024)
    # An impulse: huge flat-ish spectrum, prominence mode finds nothing
    # (damping band rejects), forcing the per-window rigid fallback.
    impulse = np.zeros(1024)
    impulse[100] = 50.0
    # An over-damped resonance (zeta=10% > the 7% damping cap): the
    # prominence detector rejects everything, the resolution fallback finds
    # the modes.
    sharp = np.exp(-2 * np.pi * 30.0 * 0.10 * t) * np.sin(2 * np.pi * 30.0 * t)
    for batch in ([peaky, peaky], [peaky, impulse], [peaky, sharp]):
        xs = np.stack(batch).astype(np.float32)
        host = analyze_epoch(xs, 500.0, mode="adaptive", refine=True)
        traced = _analyze_epoch_impl(
            jnp.asarray(xs), jnp.full((2,), 500.0, jnp.float32), None,
            n_fft=1024, mode="adaptive", k=4, backend="matmul",
            max_candidates=512, refine=True, has_lengths=False,
        )
        for name, a, b in zip(host._fields, host, traced):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    # the sharp-line batch really exercised the differing-merge path:
    assert int(host.count[0]) > 0 and int(host.count[1]) > 0
    flex_only = analyze_epoch(np.stack([peaky, sharp]).astype(np.float32),
                              500.0, mode="flexible")
    assert int(flex_only.count[1]) == 0  # rejected by flexible, found by rigid


def test_max_candidates_input_validation():
    import pytest

    x = np.zeros((1, 256), np.float32)
    with pytest.raises(ValueError, match="max_candidates"):
        analyze_epoch(x, 100.0, max_candidates="bogus")


def test_empty_epoch_returns_empty_result():
    """Zero-window epochs must return shape-(0,) results, not crash the
    dynamic-budget readback (round-2 review finding)."""
    import jax
    import numpy as np

    empty = np.zeros((0, 64), np.float32)
    for mode in ("flexible", "rigid", "adaptive"):
        res = analyze_epoch(empty, 100.0, mode=mode)
        assert res.count.shape == (0,)

    # A lengths-only tracer must fall back to the static budget, not blow up
    # on an impossible readback.
    x = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
    res = jax.jit(
        lambda L: analyze_epoch(x, 100.0, lengths=L)
    )(np.array([200, 256]))
    assert res.count.shape == (2,)


def test_pipeline_metrics_include_dynamic_budget():
    from apda_fft_tpu import SpectralPipeline

    pipe = SpectralPipeline()
    x = np.stack([modal_signal(1024, 500.0, seed=1)]).astype(np.float32)
    pipe(x, 500.0)
    m = pipe.last_metrics
    assert m["n_candidates_max"] >= m["n_required_max"] >= 1
    assert m["candidate_budget"] >= m["n_required_max"]
    assert m["budget_passes"] >= 1

    # static-budget runs don't carry stale dynamic stats
    from apda_fft_tpu import PipelineConfig

    pipe2 = SpectralPipeline(PipelineConfig(max_candidates=16))
    pipe2(x, 500.0)
    assert "candidate_budget" not in pipe2.last_metrics


def test_exact_freq_adaptive_recovers_per_window_detector():
    """Adaptive mode: flexible-served windows get 4-dp rounded frequencies,
    rigid-fallback windows the unrounded value (review finding)."""
    from apda_fft_tpu.models.batching import analyze_records

    t = np.arange(1024) / 500.0
    rng = np.random.default_rng(3)
    peaky = np.sin(2 * np.pi * 12.3 * t) + 0.05 * rng.standard_normal(1024)
    sharp = np.exp(-2 * np.pi * 30.0 * 0.10 * t) * np.sin(2 * np.pi * 30.0 * t)
    recs = analyze_records(
        [(peaky.astype(np.float32), 500.0), (sharp.astype(np.float32), 500.0)],
        mode="adaptive",
    )
    f_flex = recs[0].exact_freq(0, "adaptive")
    assert f_flex == round(int(recs[0].result.idx[recs[0].row, 0]) * 500.0 / 1024, 4)
    idx_rigid = int(recs[1].result.idx[recs[1].row, 0])
    assert recs[1].count > 0 and float(recs[1].result.prominence[recs[1].row, 0]) == 0.0
    assert recs[1].exact_freq(0, "adaptive") == idx_rigid * (500.0 / 1024)


def test_analyze_records_preserves_float64_inputs():
    from apda_fft_tpu.models.batching import analyze_records

    seen = {}

    def probe(batch, fs, **kw):
        seen["dtype"] = batch.dtype
        return analyze_epoch(batch, fs, **kw)

    x = np.random.default_rng(0).standard_normal(1000)
    analyze_records([(x, 500.0)], analyze=probe, dtype=jnp.float64)
    assert seen["dtype"] == np.float64
    analyze_records([(x, 500.0)], analyze=probe)
    assert seen["dtype"] == np.float32


def test_center_auto_matches_always_under_large_dc_offset():
    """A gravity-scale raw offset must not perturb peak decisions on the
    centering-skip path (mean is now subtracted there)."""
    t = np.arange(4096) / 500.0
    rng = np.random.default_rng(5)
    x = (5000.0 + np.sin(2 * np.pi * 12.3 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t)
         + 0.05 * rng.standard_normal(4096)).astype(np.float32)[None, :]
    auto = analyze_epoch(x, 500.0, center="auto")
    always = analyze_epoch(x, 500.0, center="always")
    assert np.array_equal(np.asarray(auto.idx), np.asarray(always.idx))
    assert int(auto.count[0]) == 2

    import pytest

    with pytest.raises(ValueError, match="center"):
        analyze_epoch(x, 500.0, center="bogus")


def test_zero_rounded_magnitude_shoulder_rejected_not_inf():
    """A shoulder whose stored magnitude rounds to 0 at 4 decimals must be
    rejected, not accepted via an inf prominence ratio (the reference raised
    ZeroDivisionError and dropped the whole window; documented divergence)."""
    from apda_fft_tpu.ops.peaks_prominence import prominence_peaks

    h = 256
    m = np.full(h, 1e-6, np.float64)
    m[0] = 0.0
    m[100] = 4.9e-5  # dominant peak, rounds to 0.0 at 4 dp
    m[103] = 1.0e-5  # shoulder within 3% relative frequency
    res = prominence_peaks(jnp.asarray(m, jnp.float32), 500.0, 2 * h)
    got_idx = [int(i) for i in np.asarray(res.idx)[: int(res.count)]]
    assert 100 in got_idx and 103 not in got_idx


def test_fast_precision_knob():
    """Opt-in reduced-precision spectrum mode: plumbing + validation."""
    import numpy as np
    import pytest

    from apda_fft_tpu.models.pipeline import analyze_epoch
    from tests.signals import two_mode_signal

    x = two_mode_signal(1024, 500.0)[None, :]
    base = analyze_epoch(x, 500.0, mode="flexible")
    fast = analyze_epoch(x, 500.0, mode="flexible", precision="fast")
    # On CPU HIGH == HIGHEST, so decisions match exactly; on a GPU "fast"
    # runs TF32 matmuls (its measured spectrum error is in PERF.md) and
    # strong peaks still match.
    assert int(fast.count[0]) == int(base.count[0])
    assert int(fast.idx[0, 0]) == int(base.idx[0, 0])

    with pytest.raises(ValueError, match="precision"):
        analyze_epoch(x, 500.0, precision="turbo")
    with pytest.raises(ValueError, match="matmul backend only"):
        analyze_epoch(x, 500.0, backend="xla", precision="fast")

    from apda_fft_tpu.ops.fft import halfspec_magnitudes

    with pytest.raises(ValueError, match="matmul backend only"):
        halfspec_magnitudes(np.zeros((1, 64), np.float32), backend="xla",
                            precision="fast")


def test_pipeline_config_precision_reaches_both_branches(monkeypatch):
    """cfg.precision must reach the plain AND mesh branches (review fix)."""
    import numpy as np

    from apda_fft_tpu.models import pipeline as P
    from tests.signals import two_mode_signal

    seen = {}
    _real = P.analyze_epoch

    def grab_plain(samples, fs, **kw):
        seen["plain"] = kw.get("precision")
        return _real(samples, fs, **kw)

    monkeypatch.setattr(P, "analyze_epoch", grab_plain)
    x = two_mode_signal(256, 500.0)[None, :]
    pipe = P.SpectralPipeline(P.PipelineConfig(precision="fast"))
    pipe(x, np.asarray([500.0], np.float32), n_fft=256)
    assert seen["plain"] == "fast"

    def grab_mesh(samples, fs, **kw):
        seen["mesh"] = kw.get("precision")
        return _real(samples, fs, **{k: v for k, v in kw.items()
                                     if k not in ("mesh",)})

    import apda_fft_tpu.parallel.mesh as M

    monkeypatch.setattr(M, "analyze_epoch_sharded", grab_mesh)
    pipe2 = P.SpectralPipeline(P.PipelineConfig(precision="fast"), mesh=object())
    pipe2(x, np.asarray([500.0], np.float32), n_fft=256)
    assert seen["mesh"] == "fast"
