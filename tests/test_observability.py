"""Observability: Influx line protocol, profiling helpers, benchmark suite smoke."""


import numpy as np
import pytest

from apda_fft_tpu.gateway.egress import InfluxSink, tilt_angles
from apda_fft_tpu.io import logfile
from apda_fft_tpu.utils.profiling import EpochMetrics, compiled_stats


class FakeResp:
    def __init__(self, status=204):
        self.status = status

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _write_log(tmp_path):
    name = "0013a20041e7f6b7_Xaxis_16_08_2026_10_20_30.log"
    path = tmp_path / name
    logfile.write_acquisition_header(
        path, "10:20:30", "2g", "500 Hz", "X axis", "Synced",
        means=["22.000000", "0.010000", "0.020000", "0.970000"],
        humidity=50.0, baselines=(0.0, 0.0, 0.0),
    )
    logfile.append_samples(path, ["0.100000", "0.200000", "0.300000"])
    return name


def test_influx_line_protocol(tmp_path):
    name = _write_log(tmp_path)
    posts = []

    def opener(req, timeout=None):
        posts.append(req.data.decode())
        return FakeResp(204)

    sink = InfluxSink("http://influx:8086/write", "tok", str(tmp_path), opener=opener)
    log_lines = []
    queue = [name]
    sink.upload(
        "0013a20041e7f6b7", queue,
        {"X": {"peak_freq": 12.3291, "max_mag": 100.5}},
        log_lines.append,
    )
    assert queue == []  # influx queue always drains (reference parity)
    assert len(posts) == 1
    lines = posts[0].splitlines()
    assert lines[0].startswith("WS_Summary,id=0013a20041e7f6b7,axis=X ")
    assert "pf=12.3291" in lines[0] and "mm=100.5" in lines[0]
    assert len(lines) == 4  # summary + 3 samples
    assert lines[1].startswith("WS_Samples,")
    # samples timestamped base + i/fs (2 ms apart at 500 Hz)
    t1, t2 = int(lines[1].rsplit(" ", 1)[1]), int(lines[2].rsplit(" ", 1)[1])
    assert t2 - t1 == 2
    assert "OK" in log_lines[0]


def test_influx_batching(tmp_path):
    name = _write_log(tmp_path)
    posts = []

    def opener(req, timeout=None):
        posts.append(req.data.decode())
        return FakeResp(204)

    sink = InfluxSink("http://x", "t", str(tmp_path), opener=opener, batch_size=2)
    sink.upload("0013a20041e7f6b7", [name], {}, lambda s: None)
    assert len(posts) == 2  # 4 lines in batches of 2


def test_tilt_angles_physics():
    accrms, phi, theta = tilt_angles(0.0, 0.0, 1.0)
    assert accrms == 1.0 and theta == 0.0
    _, phi, theta = tilt_angles(1.0, 1.0, 0.0)
    assert phi == pytest.approx(45.0)
    assert theta == pytest.approx(90.0)
    accrms, phi, theta = tilt_angles(0.0, 0.0, 0.0)
    assert theta == 0.0  # zero-norm guard


def test_epoch_metrics_capture():
    m = EpochMetrics()
    with m.measure():
        sum(range(10000))
    assert m.last["wall_time"] > 0
    assert m.last["memrss"] > 0
    assert len(m.history) == 1


def test_compiled_stats_reports_flops():
    import jax.numpy as jnp

    stats = compiled_stats(lambda x: x @ x, jnp.ones((64, 64), jnp.float32))
    assert stats["flops"] > 0


def test_benchmark_suite_configs_smoke(monkeypatch):
    """BASELINE configs 1-4 build and run one evaluation each (CPU)."""
    from benchmarks import run_all

    def _quick_seconds(fn, *args, **kw):
        import jax

        jax.block_until_ready(fn(*args))
        return 0.01

    # run_config imports the timer from benchtime at call time; stub it or
    # the smoke test runs real warm-up + repeated timing (minutes on CPU).
    monkeypatch.setattr("apda_fft_tpu.utils.benchtime.median_seconds", _quick_seconds)
    for cfg in (1, 2, 3, 4):
        out = run_all.run_config(cfg, "matmul")
        assert out["value"] > 0 and "metric" in out and out["vs_baseline"] > 0
        assert out["latency_ms"] > 0
        assert out["device"]["platform"] == "cpu" and out["device"]["count"] >= 1


def test_compilation_cache_opt_in(tmp_path, monkeypatch):
    """enable_compilation_cache populates the dir, is idempotent, and can be
    reverted.  The revert in the finally-block is load-bearing for the
    SUITE, not just hygiene: left enabled (with min_compile_time 0), every
    later compile of every later test writes a serialized executable into
    this test's tmp dir — hundreds of cache writes that once segfaulted the
    run inside jax's put_executable_and_time near the 90% mark."""
    import jax
    import jax.numpy as jnp

    from apda_fft_tpu.utils import compilecache

    # reset module state for the test (process-global otherwise); the test
    # suite runs with the cache switched off (conftest.py) - turn it on here.
    compilecache._enabled_dir = None
    monkeypatch.delenv(compilecache.ENV_VAR, raising=False)
    saved = (jax.config.jax_enable_compilation_cache,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        d = compilecache.enable_compilation_cache(str(tmp_path / "xla_cache"))
        assert compilecache.enable_compilation_cache("/elsewhere") == d
        # force a fresh compile so something can be persisted
        x = jnp.arange(1024, dtype=jnp.float32).reshape(32, 32)
        jax.block_until_ready(jax.jit(lambda a: (a @ a.T).sum() * 3.14159)(x))
        import os
        assert os.path.isdir(d)
        assert os.listdir(d)
    finally:
        compilecache.disable_compilation_cache()
        jax.config.update("jax_enable_compilation_cache", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    assert compilecache._enabled_dir is None
    # Re-enabling after a disable works (fresh deployment cycle).
    d2 = compilecache.enable_compilation_cache(str(tmp_path / "xla_cache2"))
    compilecache.disable_compilation_cache()
    assert d2.endswith("xla_cache2")


def test_bench_headline_schema_smoke(monkeypatch, capsys):
    """bench.py's one JSON line (the driver's contract) incl. the noisy leg."""
    import json
    import sys

    sys.modules.pop("bench", None)
    import bench

    def _quick_seconds(fn, *args, **kw):
        import jax

        jax.block_until_ready(fn(*args))
        return 1e-3

    monkeypatch.setattr("apda_fft_tpu.utils.benchtime.median_seconds", _quick_seconds)
    monkeypatch.setenv("APDA_BENCH_BATCH", "64")
    bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["unit"] == "windows/s" and out["value"] > 0
    assert out["vs_baseline"] > 0 and out["candidate_budget"] >= 2
    assert out["metric"].startswith("fft_peak_windows_per_sec_n4096_flexible")
    # The noisy leg rides the same line with its own budget attribution.
    assert out["noisy"]["value"] > 0 and out["noisy"]["candidate_budget"] >= 2
    # Every printed number names the device it ran on.
    assert out["device"]["platform"] == "cpu" and "kind" in out["device"]
