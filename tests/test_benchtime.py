"""Wall-clock timing helper, device identity, and the parity harness (CPU)."""

import jax
import jax.numpy as jnp
import pytest

from apda_fft_tpu.utils import benchtime


def test_wall_seconds_warms_up_then_times_each_call():
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    x = jnp.ones((64, 64), jnp.float32)
    times = benchtime.wall_seconds(fn, x, warmup=2, reps=3)
    assert len(times) == 3 and all(t > 0 for t in times)
    assert len(calls) == 5  # warm-up calls are made but not timed


def test_median_seconds_is_the_median_of_the_timed_calls(monkeypatch):
    monkeypatch.setattr(benchtime, "wall_seconds", lambda *a, **k: [3.0, 1.0, 2.0])
    assert benchtime.median_seconds(lambda: None) == 2.0


def test_device_info_names_the_platform(monkeypatch):
    monkeypatch.setattr(benchtime, "nvidia_smi", lambda: None)
    info = benchtime.device_info()
    assert info["platform"] == jax.devices()[0].platform
    assert info["kind"] == jax.devices()[0].device_kind
    assert info["count"] == len(jax.devices())
    assert info["nvidia_smi"] is None


@pytest.mark.parametrize("outcome", ["missing", "fails", "answers"])
def test_nvidia_smi_reads_name_and_power_limit(monkeypatch, outcome):
    import subprocess

    def fake_run(cmd, **kw):
        assert cmd[1] == "--query-gpu=name,power.limit"
        if outcome == "missing":
            raise FileNotFoundError(cmd[0])
        return subprocess.CompletedProcess(
            cmd, 0 if outcome == "answers" else 9,
            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    got = benchtime.nvidia_smi()
    if outcome == "answers":
        assert got == "NVIDIA H100 80GB HBM3, 700.00 W"
    else:
        assert got is None


def test_parity_corpus_runner_smoke(monkeypatch):
    """The on-device parity gate's runner, on a 1-case corpus subset."""
    import benchmarks.parity as pt
    import tests.test_peaks_match as tpm

    monkeypatch.setattr(tpm, "CORPUS", tpm.CORPUS[:1])
    report = pt.run_corpus()
    assert report["total"] == 2  # 1 case x 2 modes
    assert report["ok"] and report["fail"] == 0
