"""chip_smoke.py on the CPU: its phases at tiny sizes, its runner and its
contract (exact last line, non-zero exit without a GPU, --multichip)."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dataclasses.replace(
    chip_smoke.FULL, gw_sensors=4, gw_n=1024, gw_epochs=1, epoch_b=64,
    epoch_n=1024, epoch_subset=8, reps=2,
    configs=(("cfg1", "rigid", 1, 1, 256, False, None),
             ("cfg2", "flexible", 1, 1, 1024, True, None),
             ("cfg3", "flexible", 4, 1, 1024, False, None),
             ("cfg4", "flexible", 4, 2, 1024, False, 4),
             ("cfg5", "flexible", 2, 1, 4096, True, 2)),
    spectrum_ns=(256, 1024), modal_channels=4, modal_len=8192, modal_fs=64.0,
    modal_window=512, ssi_rows=16, mc_batch=32, mc_fdd_len=4096, mc_ssi_len=4096)

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_card(monkeypatch):
    """nvidia-smi answers, JAX reports GPUs, and every phase is a recorder."""
    calls = []
    monkeypatch.setattr(chip_smoke.benchtime, "nvidia_smi", lambda: CARD)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()] * 4)
    monkeypatch.setattr(chip_smoke, "PHASES", {
        name: (lambda sizes, card, name=name: calls.append(name))
        for name in chip_smoke.PHASES})
    return calls


@pytest.mark.parametrize("phase", ["gateway", "epoch", "configs", "modal", "multichip"])
def test_phase_passes_at_tiny_size_on_cpu(phase, capsys):
    assert chip_smoke.run_phases([phase], TINY, "cpu rehearsal") == []
    out = capsys.readouterr().out
    assert f"== {phase} ok" in out


def test_last_line_is_exactly_the_result(fake_card, capsys):
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    assert lines[0] == f"nvidia-smi name, power.limit: {CARD}"
    assert fake_card == list(chip_smoke.SINGLE_CARD)  # gpu tests first


def test_multichip_runs_only_its_phase(fake_card, capsys):
    assert chip_smoke.main(["--multichip"]) == 0
    assert fake_card == ["multichip"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == chip_smoke.MULTICHIP_DEVICES


def test_failed_phase_exits_nonzero_without_result(fake_card, monkeypatch, capsys):
    def broken(sizes, card):
        raise chip_smoke.PhaseFailure("decisions differ")

    monkeypatch.setitem(chip_smoke.PHASES, "epoch", broken)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out and "FAILED phases: epoch" in out
    assert "modal" in fake_card  # later phases still ran and reported


def test_cpu_backend_exits_nonzero(monkeypatch, capsys):
    """nvidia-smi present but JAX on the CPU: refuse, print no result."""
    monkeypatch.setattr(chip_smoke.benchtime, "nvidia_smi", lambda: CARD)
    monkeypatch.setitem(chip_smoke.PHASES, "gpu_tests", lambda sizes, card: None)
    assert chip_smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_script_without_gpu_exits_nonzero():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PATH="/nonexistent"))
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    """Copied out of the repository, the script cannot run and says nothing."""
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
