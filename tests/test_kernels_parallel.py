"""FFT backend and detector equivalence, and the sharded/distributed paths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from apda_fft_tpu.ops import fft as fft_ops
from apda_fft_tpu.parallel.distributed_fft import (
    distributed_halfspec_magnitudes,
    shard_windows_2d,
)
from apda_fft_tpu.parallel.mesh import analyze_epoch_sharded, make_mesh, shard_batch
from tests.signals import modal_signal


def _windows(b, n, fs=500.0, seed=0):
    xs = np.stack([modal_signal(n, fs, seed=seed + i) for i in range(b)])
    return jnp.asarray(xs, jnp.float32)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_matmul_backend_matches_xla(n):
    """The four-step matmul magnitudes (direct DFT at n=256) equal XLA's FFT."""
    w = fft_ops.center_and_pad(_windows(5, n), n)
    ref = np.asarray(fft_ops.halfspec_magnitudes(w, backend="xla"))
    got = np.asarray(fft_ops.halfspec_magnitudes(w, backend="matmul"))
    assert got.shape == ref.shape
    scale = ref.max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-6)
    assert np.all(got[:, 0] == 0)


def test_matmul_backend_rows_are_independent():
    """An odd batch yields the same rows as each window transformed alone."""
    w = fft_ops.center_and_pad(_windows(3, 1024), 1024)
    got = np.asarray(fft_ops.halfspec_magnitudes(w, backend="matmul"))
    for i in range(3):
        one = np.asarray(fft_ops.halfspec_magnitudes(w[i:i + 1], backend="matmul"))
        np.testing.assert_allclose(got[i], one[0], rtol=1e-6, atol=1e-6 * got.max())


def test_sharded_epoch_analysis_8dev():
    mesh = make_mesh(8, ("data",))
    xs = _windows(16, 1024)
    res = analyze_epoch_sharded(np.asarray(xs), 500.0, mesh=mesh, mode="flexible")
    ref = jax.jit(
        lambda s, f: __import__("apda_fft_tpu").analyze_epoch(s, f, mode="flexible")
    )(xs, jnp.float32(500.0))
    np.testing.assert_array_equal(np.asarray(res.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(np.asarray(res.count), np.asarray(ref.count))


def test_sharded_core_has_no_collectives():
    """The data-parallel epoch program must compile collective-free.

    Requires the matmul FFT backend: XLA's RFFT custom-call cannot be
    batch-partitioned and would force an all-gather of the whole epoch
    (which is why analyze_epoch_sharded defaults to backend="matmul").
    """
    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl

    mesh = make_mesh(8, ("data",))
    xs = shard_batch(_windows(16, 1024), mesh)
    fs = shard_batch(jnp.full((16,), 500.0, jnp.float32), mesh)
    # auto_spmd resolves to argmax at small budgets and sort at large ones;
    # both (and sort itself) must stay collective-free.
    for selection, budget in (("sort", 32), ("auto_spmd", 8), ("auto_spmd", 32)):
        lowered = jax.jit(
            lambda s, f: _analyze_epoch_impl(
                s, f, None, n_fft=1024, mode="flexible", k=4, backend="matmul",
                max_candidates=budget, refine=False, has_lengths=False,
                selection=selection,
            )
        ).lower(xs, fs)
        hlo = lowered.compile().as_text()
        for coll in ("all-reduce", "all-gather", "all-to-all", "collective-permute"):
            assert coll not in hlo, f"{selection}/{budget}: unexpected {coll}"


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_distributed_fft_matches_single_device(shape):
    mesh = make_mesh(8, ("data", "seq"), shape=shape)
    n = 4096
    xs = fft_ops.center_and_pad(_windows(8, n), n)
    ref = np.asarray(fft_ops.halfspec_magnitudes(xs, backend="matmul"))
    sharded = shard_windows_2d(xs, mesh)
    got = np.asarray(distributed_halfspec_magnitudes(sharded, mesh))
    scale = ref.max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-6)


def test_distributed_fft_rejects_bad_split():
    mesh = make_mesh(8, ("data", "seq"), shape=(1, 8))
    xs = fft_ops.center_and_pad(_windows(2, 64), 64)  # N1=N2=8 -> 8 divides, ok
    distributed_halfspec_magnitudes(shard_windows_2d(xs, mesh), mesh)
    xs2 = fft_ops.center_and_pad(_windows(2, 16), 16)  # N1=N2=4 < 8 -> reject
    with pytest.raises(ValueError, match="must divide"):
        distributed_halfspec_magnitudes(shard_windows_2d(xs2, mesh), mesh)


def test_detector_selection_paths_agree():
    """argmax, top_k and sort candidate selection decide identically on the
    signal corpus (the auto choice between them is a speed choice only)."""
    from apda_fft_tpu.ops.peaks_prominence import prominence_peaks

    for n, fs in ((1024, 500.0), (4096, 250.0)):
        xs = _windows(6, n, fs=fs, seed=50)
        mags = fft_ops.halfspec_magnitudes(fft_ops.center_and_pad(xs, n))
        fsv = jnp.full((6,), fs, jnp.float32)
        ref = jax.vmap(lambda m, f: prominence_peaks(m, f, n, selection="argmax"))(mags, fsv)
        for sel in ("topk", "sort"):
            got = jax.vmap(lambda m, f: prominence_peaks(m, f, n, selection=sel))(mags, fsv)
            np.testing.assert_array_equal(np.asarray(got.count), np.asarray(ref.count))
            np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
            np.testing.assert_array_equal(
                np.asarray(got.prominence), np.asarray(ref.prominence))
            np.testing.assert_array_equal(np.asarray(got.damping), np.asarray(ref.damping))


def test_distributed_fft_long_record():
    """Sequence-parallel FFT at N=65536 (the beyond-VMEM design point)."""
    mesh = make_mesh(8, ("data", "seq"), shape=(2, 4))
    n = 65536
    xs = fft_ops.center_and_pad(_windows(2, n), n)
    ref = np.asarray(fft_ops.halfspec_magnitudes(xs, backend="matmul"))
    got = np.asarray(distributed_halfspec_magnitudes(shard_windows_2d(xs, mesh), mesh))
    scale = ref.max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5)


def test_gateway_pipeline_on_mesh(tmp_path):
    """A mesh-backed SpectralPipeline drives the gateway end to end."""
    import json as _json
    import os

    from apda_fft_tpu.gateway.config import GatewayConfig
    from apda_fft_tpu.gateway.service import GatewayService
    from apda_fft_tpu.gateway.transport import LoopbackTransport, SensorSimulator
    from apda_fft_tpu.models.pipeline import PipelineConfig, SpectralPipeline
    from tests.signals import two_mode_signal

    data_dir = str(tmp_path / "d") + os.sep
    os.makedirs(data_dir)
    cfg_path = tmp_path / "gw.json"
    cfg_path.write_text(_json.dumps({
        "ftp": {}, "fastapi": {"url": ""},
        "gateway": {"logger_file": data_dir + "h.log",
                    "device_file": data_dir + "dev.txt",
                    "config_file": str(tmp_path / "c.txt"),
                    "data_dir": data_dir,
                    "is_flexibile_structure": True},
    }))
    (tmp_path / "c.txt").write_text("")

    mesh = make_mesh(8, ("data",))
    pipe = SpectralPipeline(PipelineConfig(mode="flexible"), mesh=mesh)
    transport = LoopbackTransport()
    svc = GatewayService(GatewayConfig.load(cfg_path), transport, pipeline=pipe)
    svc.start()
    sim = SensorSimulator("a" * 16, fs=500.0, axis="X", chunk=100)
    sim.stream_acquisition(transport, two_mode_signal(1024, 500.0))
    svc.drain()
    entry = svc.fft_results["a" * 16]["X"]
    assert entry["peak_freq"] == 12.207  # 25 * 500/1024 rounded


def test_sharded_large_epoch_stays_collective_free():
    """batch_chunk must be disabled on the sharded path (lax.map reshape of a
    sharded axis would force an all-gather of the whole epoch)."""
    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl

    mesh = make_mesh(8, ("data",))
    xs = shard_batch(jnp.zeros((2048, 256), jnp.float32), mesh)
    fs = shard_batch(jnp.full((2048,), 500.0, jnp.float32), mesh)
    hlo = jax.jit(
        lambda s, f: _analyze_epoch_impl(
            s, f, None, n_fft=256, mode="flexible", k=4, backend="matmul",
            max_candidates=32, refine=False, has_lengths=False,
            selection="sort", batch_chunk=0,
        )
    ).lower(xs, fs).compile().as_text()
    for coll in ("all-reduce", "all-gather", "all-to-all"):
        assert coll not in hlo


def test_sharded_multidim_batch_with_padding():
    """Leading batch shapes that don't divide the mesh get padded, not crash."""
    mesh = make_mesh(8, ("data",))
    xs = np.stack([[modal_signal(256, 100.0, seed=3 * c + w) for w in range(4)]
                   for c in range(6)])  # [6, 4, 256]: 6 % 8 != 0
    fs = np.full((6, 4), 100.0, np.float32)
    res = analyze_epoch_sharded(xs, fs, mesh=mesh, n_fft=256)
    assert res.count.shape == (6, 4)


def test_sharded_ragged_lengths_match_single_device():
    """Ragged records (lengths-bearing) on a mesh: uneven batch AND uneven
    per-record valid prefixes must pad, shard, and decide exactly like the
    single-device pipeline."""
    from apda_fft_tpu.models.pipeline import analyze_epoch

    mesh = make_mesh(8, ("data",))
    n_fft = 512
    b = 11  # 11 % 8 != 0: exercises batch padding alongside lengths sharding
    rng = np.random.default_rng(5)
    lengths = rng.integers(300, n_fft + 1, size=b)
    xs = np.zeros((b, n_fft), np.float32)
    for i, ln in enumerate(lengths):
        xs[i, :ln] = modal_signal(int(ln), 200.0, seed=100 + i)
    fs = np.full((b,), 200.0, np.float32)

    sharded = analyze_epoch_sharded(xs, fs, mesh=mesh, n_fft=n_fft, lengths=lengths)
    single = analyze_epoch(
        xs, fs, n_fft=n_fft, lengths=lengths, backend="matmul", selection="sort",
        batch_chunk=0,
    )
    assert sharded.count.shape == (b,)
    for name, a, c in zip(sharded._fields, sharded, single):
        assert np.array_equal(np.asarray(a), np.asarray(c)), name


def test_sharded_adaptive_uneven_batch_matches_single_device():
    """Edge-replication padding: adaptive mode on an uneven sharded batch
    must match single-device exactly and not be poisoned by zero pad rows
    (which would force the rigid fallback pass on every call)."""
    from apda_fft_tpu.models.pipeline import analyze_epoch

    mesh = make_mesh(8, ("data",))
    xs = np.stack([modal_signal(256, 100.0, seed=40 + i) for i in range(5)])
    fs = np.full((5,), 100.0, np.float32)
    sharded = analyze_epoch_sharded(xs, fs, mesh=mesh, n_fft=256, mode="adaptive")
    single = analyze_epoch(
        xs, fs, n_fft=256, mode="adaptive", backend="matmul", selection="sort",
        batch_chunk=0,
    )
    # Decisions must be exact; continuous outputs may differ by GEMM
    # reduction-order ulps (the padded batch runs a different matmul shape).
    for name in ("count", "idx", "n_candidates"):
        assert np.array_equal(
            np.asarray(getattr(sharded, name)), np.asarray(getattr(single, name))
        ), name
    for name in ("freq", "mag", "prominence", "damping", "q_factor", "refined_freq"):
        np.testing.assert_allclose(
            np.asarray(getattr(sharded, name)), np.asarray(getattr(single, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )


def _noisy_corpus(b, n, fs=500.0, seed=1234, noise=1.0):
    """Noisy decaying-mode corpus (the two-tier trigger shape)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = noise * rng.standard_normal((b, n)).astype(np.float64)
    for f, a, zeta in ((12.3, 0.9, 0.01), (47.7, 0.7, 0.008),
                       (88.4, 0.55, 0.015)):
        phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
        x += a * np.sin(2 * np.pi * f * t[None, :] + phase) * np.exp(
            -zeta * 2 * np.pi * f * t[None, :])
    return x.astype(np.float32)


def test_sharded_welch_matches_single_device():
    """Welch-averaged analysis on a mesh: channel axis sharded (uneven),
    decisions identical to the single-device run."""
    from apda_fft_tpu.models.streaming import analyze_welch
    from apda_fft_tpu.parallel.mesh import analyze_welch_sharded

    jax.clear_caches()  # headroom vs the jaxlib 0.9 accumulation abort (conftest)

    mesh = make_mesh(8, ("data",))
    c, t_len, window = 11, 8192, 1024  # 11 % 8 != 0: exercises padding
    records = _noisy_corpus(c, t_len, noise=0.8, seed=21)
    fs = np.full((c,), 500.0, np.float32)

    sharded = analyze_welch_sharded(records, fs, window, mesh=mesh)
    single = analyze_welch(records, fs, window, backend="matmul",
                           selection="sort")
    assert sharded.count.shape == (c,)
    for name in ("count", "idx", "freq", "mag"):
        assert np.array_equal(
            np.asarray(getattr(sharded, name)), np.asarray(getattr(single, name))
        ), name
    for name in ("prominence", "damping", "q_factor"):
        np.testing.assert_allclose(
            np.asarray(getattr(sharded, name)), np.asarray(getattr(single, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)


def test_fdd_on_mesh_matches_single_device():
    """FDD's per-bin power-iteration SVD under NamedSharding (frequency axis
    sharded): identical modes, shapes, and singular spectra."""
    from apda_fft_tpu.models.modal import fdd

    jax.clear_caches()  # headroom vs the jaxlib 0.9 accumulation abort (conftest)

    rng = np.random.default_rng(3)
    fs, t_len, s = 200.0, 16384, 4
    t = np.arange(t_len) / fs
    shape1 = np.array([1.0, 0.8, 0.5, 0.2])
    shape2 = np.array([1.0, -0.3, -0.9, 0.6])
    drive1 = np.sin(2 * np.pi * 12.5 * t + rng.uniform(0, 6.28))
    drive2 = np.sin(2 * np.pi * 33.8 * t + rng.uniform(0, 6.28))
    records = (shape1[:, None] * drive1[None, :]
               + 0.7 * shape2[:, None] * drive2[None, :]
               + 0.05 * rng.standard_normal((s, t_len))).astype(np.float32)

    mesh = make_mesh(8, ("data",))
    res_mesh = fdd(records, fs, window=1024, mesh=mesh)
    res_single = fdd(records, fs, window=1024, selection="sort")

    assert res_mesh.count == res_single.count and res_mesh.count >= 2
    np.testing.assert_array_equal(res_mesh.idx, res_single.idx)
    np.testing.assert_array_equal(res_mesh.freq, res_single.freq)
    np.testing.assert_allclose(res_mesh.sv1, res_single.sv1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res_mesh.shape_re, res_single.shape_re,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res_mesh.shape_im, res_single.shape_im,
                               rtol=1e-4, atol=1e-5)


def test_dynamic_two_tier_budget_on_mesh():
    """The dynamic candidate budget (scalar readback + learned two-tier
    split) composes with the sharded epoch path: decisions match a flat
    big-budget single-device run, and the tier actually engages."""
    from apda_fft_tpu.models import pipeline
    from apda_fft_tpu.models.pipeline import analyze_epoch, last_dynamic_stats

    jax.clear_caches()  # headroom vs the jaxlib 0.9 accumulation abort (conftest)

    pipeline._dynamic_budget.clear()
    pipeline._dynamic_budget_hwm.clear()
    pipeline._dynamic_tier.clear()
    mesh = make_mesh(8, ("data",))
    n = 4096
    fs = np.full((64,), 500.0, np.float32)
    x1 = _noisy_corpus(64, n, seed=11)

    res1 = analyze_epoch_sharded(x1, fs, mesh=mesh, n_fft=n, mode="flexible")
    ref1 = analyze_epoch(x1, fs, n_fft=n, mode="flexible", max_candidates=256,
                         backend="matmul", selection="sort", batch_chunk=0)
    for name in ("count", "idx", "freq", "mag"):
        assert np.array_equal(
            np.asarray(getattr(res1, name)), np.asarray(getattr(ref1, name))
        ), name

    # Second epoch rides whatever budget/tier the first one learned; the
    # sharded dynamic path must still be decision-exact.
    x2 = _noisy_corpus(64, n, seed=12)
    res2 = analyze_epoch_sharded(x2, fs, mesh=mesh, n_fft=n, mode="flexible")
    stats = dict(last_dynamic_stats())
    ref2 = analyze_epoch(x2, fs, n_fft=n, mode="flexible", max_candidates=256,
                         backend="matmul", selection="sort", batch_chunk=0)
    for name in ("count", "idx", "freq", "mag"):
        assert np.array_equal(
            np.asarray(getattr(res2, name)), np.asarray(getattr(ref2, name))
        ), name
    # The dynamic machinery ran on the mesh path (budget tracked, one or
    # two passes, learned state keyed like the single-device path).
    assert stats.get("candidate_budget", 0) >= 2
    assert (n, "flexible") in pipeline._dynamic_budget


def test_sharded_entry_points_pin_partitionable_selection():
    """Mesh paths must lower without lax.top_k, which has no SPMD
    partitioning rule: every sharded entry point pins `auto_spmd`, which
    resolves to argmax or the full sort, never top_k."""
    import inspect

    from apda_fft_tpu.models.pipeline import _analyze_epoch_impl
    from apda_fft_tpu.parallel import mesh as mesh_mod

    for fn in (mesh_mod.analyze_epoch_sharded, mesh_mod.analyze_welch_sharded):
        src = inspect.getsource(fn)
        assert 'setdefault("selection", "auto_spmd")' in src, fn.__name__
    xs = _windows(4, 1024)
    fs = jnp.full((4,), 500.0, jnp.float32)
    for selection, has_topk in (("auto_spmd", False), ("auto", True)):
        hlo = jax.jit(
            lambda s, f: _analyze_epoch_impl(
                s, f, None, n_fft=1024, mode="flexible", k=4, backend="matmul",
                max_candidates=32, refine=False, has_lengths=False,
                selection=selection,
            )
        ).lower(xs, fs).as_text()
        assert ("top_k" in hlo) == has_topk, selection


def test_flagship_refined_dynamic_on_dpxsp_mesh():
    """The sequence-parallel FFT feeding the REFINED,
    DYNAMIC-BUDGET detector (the program BASELINE cfg2/cfg5 describe) -
    full-decision parity + sub-bin refined frequencies vs the single-device
    flagship, on the 2D dp x sp mesh."""
    from apda_fft_tpu.models.pipeline import (
        analyze_epoch,
        detect_from_mags,
        last_dynamic_stats,
    )

    mesh = make_mesh(8, ("data", "seq"), shape=(4, 2))
    n, b, fs = 4096, 16, 500.0
    xs = fft_ops.center_and_pad(_windows(b, n, fs=fs), n)
    mags = distributed_halfspec_magnitudes(shard_windows_2d(xs, mesh), mesh)
    fs_b = np.full((b,), fs, np.float32)

    got = jax.block_until_ready(detect_from_mags(
        mags, fs_b, n_fft=n, mode="flexible", refine=True, selection="sort"))
    stats = dict(last_dynamic_stats())
    ref = jax.block_until_ready(analyze_epoch(
        _windows(b, n, fs=fs), fs_b, n_fft=n, mode="flexible",
        center="always", refine=True, backend="matmul", selection="sort",
        max_candidates=256))

    cnt, idx = np.asarray(got.count), np.asarray(got.idx)
    rcnt, ridx = np.asarray(ref.count), np.asarray(ref.idx)
    assert np.array_equal(cnt, rcnt)
    assert cnt.min() >= 1
    for row in range(b):
        c = int(rcnt[row])
        assert np.array_equal(idx[row, :c], ridx[row, :c]), row
        np.testing.assert_allclose(
            np.asarray(got.refined_freq)[row, :c],
            np.asarray(ref.refined_freq)[row, :c], rtol=1e-4, atol=1e-4)
    # The dynamic loop actually ran (budget learned, >= the floor).
    assert stats.get("candidate_budget", 0) >= 2
    assert stats.get("budget_passes", 0) >= 1


def test_detect_from_mags_static_and_validation():
    """Static-budget path + arg validation of the public mags surface."""
    from apda_fft_tpu.models.pipeline import analyze_epoch, detect_from_mags

    n, b, fs = 1024, 4, 500.0
    xs = fft_ops.center_and_pad(_windows(b, n), n)
    mags = fft_ops.halfspec_magnitudes(xs, backend="matmul")
    fs_b = np.full((b,), fs, np.float32)
    got = detect_from_mags(mags, fs_b, n_fft=n, mode="rigid",
                           max_candidates=32, refine=False)
    ref = analyze_epoch(_windows(b, n), fs_b, n_fft=n, mode="rigid",
                        center="always", max_candidates=32)
    assert np.array_equal(np.asarray(got.count), np.asarray(ref.count))
    assert np.array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    with pytest.raises(ValueError, match="mags must be"):
        detect_from_mags(mags[0], fs_b, n_fft=n)
    with pytest.raises(ValueError, match="unknown mode"):
        detect_from_mags(mags, fs_b, n_fft=n, mode="nope")
    with pytest.raises(ValueError, match="outer jit trace"):
        jax.jit(lambda m: detect_from_mags(
            m, fs_b, n_fft=n, max_candidates="dynamic"))(mags)


def test_sharded_severity_srs_ringdown_parity():
    """Severity / SRS / ring-down under NamedSharding on
    the dp mesh - kwargs + collective-free readback contracts, parity vs the
    unsharded op."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from apda_fft_tpu.ops.integrate import velocity_rms
    from apda_fft_tpu.ops.ringdown import ringdown_damping
    from apda_fft_tpu.ops.srs import shock_response_spectrum

    mesh = make_mesh(8, ("data",))
    sh = NamedSharding(mesh, P("data", None))
    b, fs = 16, 500.0
    rng = np.random.default_rng(5)
    x = np.asarray(_windows(b, 2048, fs=fs))

    sev_ref = np.asarray(velocity_rms(x, fs, band=(5.0, 100.0)))
    sev_sh = np.asarray(velocity_rms(jax.device_put(x, sh), fs,
                                     band=(5.0, 100.0)))
    np.testing.assert_allclose(sev_sh, sev_ref, rtol=1e-6)

    td = np.arange(512) / fs
    shocks = (np.exp(-2.0 * td)[None, :] * np.sin(2 * np.pi * 20.0 * td)
              * (1.0 + 0.1 * rng.standard_normal((b, 1)))).astype(np.float32)
    srs_ref = shock_response_spectrum(shocks, fs)
    srs_sh = shock_response_spectrum(jax.device_put(shocks, sh), fs)
    np.testing.assert_allclose(srs_sh.maximax, srs_ref.maximax, rtol=1e-5)
    np.testing.assert_allclose(srs_sh.pseudo_velocity,
                               srs_ref.pseudo_velocity, rtol=1e-5)

    rd_ref = np.asarray(ringdown_damping(shocks, fs, 20.0))
    rd_sh = np.asarray(ringdown_damping(jax.device_put(shocks, sh), fs, 20.0))
    assert np.isfinite(rd_ref).all()
    np.testing.assert_allclose(rd_sh, rd_ref, rtol=1e-5)
