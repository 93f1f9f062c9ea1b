"""SSI-COV stochastic subspace identification (`models/ssi.py`).

Validation strategy: (1) device correlation blocks against a numpy float64
direct computation, (2) end-to-end mode recovery (frequency, damping, MAC
vs true shapes) on the same synthetic white-noise-driven modal model the
FDD tests use — SSI must recover *damping* well, which is its reason to
exist, (3) a white-noise null corpus where no physical mode may survive
the stabilization + MPC filters, (4) frequency agreement with `fdd` on
shared records, (5) input validation.
"""

import os

import numpy as np
import pytest

from apda_fft_tpu.models.modal import fdd, modal_assurance
from apda_fft_tpu.models.ssi import (
    SSIMode,
    SSIResult,
    correlation_blocks,
    modal_phase_collinearity,
    ssi,
)
from apda_fft_tpu.utils.synthetic import modal_records as _modal_records

FS = 50.0
SHAPES = np.array([
    [1.0, 0.8, 0.5, 0.2],
    [0.9, 0.1, -0.6, -1.0],
])
FREQS = (3.1, 7.6)
ZETAS = (0.01, 0.02)


# ---------------------------------------------------------------- blocks


def test_correlation_blocks_match_numpy_f64():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    n_lags = 12
    r = correlation_blocks(x, n_lags)
    assert r.shape == (n_lags, 3, 3) and r.dtype == np.float64

    xm = x.astype(np.float64)
    xm -= xm.mean(-1, keepdims=True)
    t0 = 5000 - n_lags + 1
    for lag in range(n_lags):
        ref = xm[:, lag : lag + t0] @ xm[:, :t0].T / t0
        err = np.abs(r[lag] - ref).max() / np.abs(ref).max()
        assert err < 2e-6, f"lag {lag}: rel err {err}"


def test_correlation_blocks_lag0_symmetric_psd():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 4000)).astype(np.float32)
    r = correlation_blocks(x, 8)
    np.testing.assert_allclose(r[0], r[0].T, atol=1e-9)
    assert np.all(np.linalg.eigvalsh(r[0]) > 0)


def test_correlation_blocks_detrend_none():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3000)) + 5.0).astype(np.float32)
    r_mean = correlation_blocks(x, 4)
    r_none = correlation_blocks(x, 4, detrend="none")
    # Without mean removal the DC offset (5^2 = 25) dominates every block.
    assert np.abs(r_none[1]).max() > 10 * np.abs(r_mean[1]).max()


def test_correlation_blocks_validation():
    x = np.zeros((2, 100), np.float32)
    with pytest.raises(ValueError, match="n_lags"):
        correlation_blocks(x, 1)
    with pytest.raises(ValueError, match="too short"):
        correlation_blocks(x, 30)
    with pytest.raises(ValueError, match="S, T"):
        correlation_blocks(np.zeros(100, np.float32), 4)
    with pytest.raises(ValueError, match="detrend"):
        correlation_blocks(x, 4, detrend="median")


def test_correlation_blocks_sharded_matches_single_device():
    """Time-axis-sharded correlation (ppermute halo + one psum) vs single
    device, on the virtual 8-device mesh - the beyond-one-chip path for
    hours-long records - and end-to-end through ssi(blocks=...)."""
    import jax

    from apda_fft_tpu.parallel.mesh import correlation_blocks_sharded, make_mesh

    mesh = make_mesh(8, ("seq",))
    x = _modal_records(SHAPES, FREQS, ZETAS, FS, 240.0, seed=9)  # T=12000
    n_lags = 60
    ref = correlation_blocks(x, n_lags)
    got = correlation_blocks_sharded(x, n_lags, mesh)
    assert got.shape == ref.shape == (n_lags, 4, 4)
    # f32 partial sums accumulate in a different order across shards:
    # allclose, not equal - and both within the same distance of float64.
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    xm = x.astype(np.float64)
    xm -= xm.mean(-1, keepdims=True)
    t0 = x.shape[1] - n_lags + 1
    for lag in (0, 31, n_lags - 1):
        oracle = xm[:, lag : lag + t0] @ xm[:, :t0].T / t0
        err = np.abs(got[lag] - oracle).max() / np.abs(oracle).max()
        assert err < 2e-6, f"lag {lag}: rel err {err} vs float64"

    # The identification consumes either path equivalently.  Marginal
    # noise poles sit ON the stabilization threshold, so the different
    # f32 accumulation order may flip one in or out; the contract is that
    # both paths recover every PHYSICAL mode at matching frequencies.
    res = ssi(x, FS, i=30, blocks=got)
    ref_res = ssi(x, FS, i=30)
    for f_true in FREQS:
        a = min(res.modes, key=lambda m: abs(m.freq - f_true))
        b = min(ref_res.modes, key=lambda m: abs(m.freq - f_true))
        assert abs(a.freq - f_true) / f_true < 5e-3
        assert abs(b.freq - f_true) / f_true < 5e-3
        assert abs(a.freq - b.freq) / b.freq < 1e-3
        assert modal_assurance(a.shape, b.shape)[0, 0] > 0.999

    # Contract guards.
    with pytest.raises(ValueError, match="divisible"):
        correlation_blocks_sharded(x[:, :11995], n_lags, mesh)
    with pytest.raises(ValueError, match="chunk"):
        correlation_blocks_sharded(x[:, : 8 * 32], 60, mesh)


def test_ssi_blocks_injection_validation():
    x = np.random.default_rng(0).standard_normal((3, 4000)).astype(np.float32)
    with pytest.raises(ValueError, match="blocks must be"):
        ssi(x, FS, i=10, blocks=np.zeros((5, 3, 3)))


# ------------------------------------------------------------- recovery


def test_ssi_recovers_frequency_damping_and_shapes():
    x = _modal_records(SHAPES, FREQS, ZETAS, FS, 240.0, seed=3)
    res = ssi(x, FS, i=30)
    assert isinstance(res, SSIResult)
    assert res.count == 2

    for mode, f_true, z_true, shape_true in zip(
        res.modes, FREQS, ZETAS, SHAPES
    ):
        # Frequency off-grid (not bin-quantized): within 0.5%.
        assert abs(mode.freq - f_true) / f_true < 5e-3
        # Damping — SSI's reason to exist — within 25% relative (an
        # output-only damping estimate from 4 minutes of data; the FDD
        # half-power estimate errs by >100% on the same records).
        assert abs(mode.damping - 100 * z_true) / (100 * z_true) < 0.25
        mac = modal_assurance(shape_true, mode.shape)[0, 0]
        assert mac > 0.95
        assert mode.mpc > 0.99
        assert mode.n_orders >= 10  # physical poles stabilize broadly
        assert mode.freq_std < 0.05 * mode.freq

    # Result convenience views.
    assert res.freqs().shape == (2,) and res.dampings().shape == (2,)
    assert res.shapes().shape == (2, 4)
    # Hankel singular values: descending, with the 4-dim physical
    # subspace (2 modes x 2 states) separated from the noise floor.
    sv = res.hankel_sv
    assert np.all(np.diff(sv) <= 1e-9)
    assert sv[3] > 10 * sv[4]


def test_ssi_white_noise_null():
    """Pure white noise must identify no physical modes.

    Finite-sample correlations DO stabilize spurious poles across orders
    (they are deterministic given the data), so this is the test that the
    min_orders + MPC physicality filters actually work.
    """
    for seed in (100, 101, 102, 103, 104, 105):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((4, 12000)).astype(np.float32)
        res = ssi(x, FS, i=30)
        assert res.count == 0, (
            f"seed {seed}: spurious modes "
            f"{[(m.freq, m.n_orders, m.mpc) for m in res.modes]}"
        )
        # Empty results keep the sensor dimension (a [0, S] MAC against a
        # truth set is a valid no-op, not a crash).
        assert res.shapes().shape == (0, 4)
        assert modal_assurance(res.shapes(), SHAPES).shape == (0, 2)


def test_ssi_single_channel():
    """S=1 still identifies frequency + damping (shape is trivial).

    With one channel the MPC physicality filter is degenerate (a
    1-component shape is always phase-collinear), so heavily damped
    spurious poles CAN stabilize alongside the physical mode — the test
    asserts the physical mode is recovered accurately and is the most
    broadly stabilized one, not that it is alone.
    """
    shapes = np.array([[1.0]])
    x = _modal_records(shapes, [3.1], [0.01], FS, 240.0, seed=4)
    res = ssi(x, FS, i=30, orders=range(2, 29, 2))
    assert res.count >= 1
    m = min(res.modes, key=lambda m: abs(m.freq - 3.1))
    assert abs(m.freq - 3.1) / 3.1 < 5e-3
    assert abs(m.damping - 1.0) < 0.4
    # The physical pole stabilizes across more orders than any artifact.
    assert m.n_orders == max(mm.n_orders for mm in res.modes)


def test_ssi_agrees_with_fdd():
    # Same configuration test_modal.py::test_fdd_recovers_modes_and_shapes
    # validates for FDD, so disagreement here indicts SSI, not FDD.
    shapes = np.array([
        [0.38, 0.71, 0.92, 1.0],
        [0.87, 1.0, 0.28, -0.75],
    ])
    fs = 128.0
    x = _modal_records(shapes, [9.3, 23.8], [0.012, 0.01], fs, 240.0, seed=3)
    res_ssi = ssi(x, fs, i=25)
    res_fdd = fdd(x, fs, window=1024)
    assert res_ssi.count == 2
    n_fdd = int(res_fdd.count)
    assert n_fdd >= 2
    bin_hz = fs / 1024
    fdd_freqs = res_fdd.freq[:n_fdd]
    for mode in res_ssi.modes:
        # Each SSI mode matches an FDD peak within two FFT bins, and the
        # shapes agree.
        j = int(np.argmin(np.abs(fdd_freqs - mode.freq)))
        assert abs(fdd_freqs[j] - mode.freq) <= 2 * bin_hz
        phi_fdd = res_fdd.shape_re[j] + 1j * res_fdd.shape_im[j]
        assert modal_assurance(phi_fdd, mode.shape)[0, 0] > 0.95


def test_ssi_stabilization_diagram_structure():
    x = _modal_records(SHAPES, FREQS, ZETAS, FS, 120.0, seed=6)
    res = ssi(x, FS, i=20, orders=range(2, 41, 2))
    assert list(res.orders) == list(range(2, 41, 2))
    assert len(res.diagram) == len(res.orders)
    for d, n in zip(res.diagram, res.orders):
        assert d["order"] == n
        p = d["freq"].shape[0]
        assert d["damping"].shape == (p,) and d["stable"].shape == (p,)
        assert d["stable"].dtype == bool
        assert np.all(np.diff(d["freq"]) >= 0)  # sorted by frequency
        assert np.all((d["damping"] > 0) & (d["damping"] < 20.0))
        assert np.all((d["freq"] > 0) & (d["freq"] < FS / 2))
    # The lowest order has no previous order: nothing can be stable.
    assert not res.diagram[0]["stable"].any()
    # Physical modes are stable at the highest order.
    top = res.diagram[-1]
    for f_true in FREQS:
        j = int(np.argmin(np.abs(top["freq"] - f_true)))
        assert top["stable"][j]


def test_merge_close_modes():
    from apda_fft_tpu.models.ssi import _merge_close_modes

    def mk(freq, n_orders, shape):
        return SSIMode(freq=freq, damping=1.0, shape=np.asarray(shape, complex),
                       order=40, n_orders=n_orders, freq_std=0.01,
                       damping_std=0.1, mpc=1.0)

    a = [1.0, 0.5, -0.3]
    b = [0.2, -1.0, 0.7]
    # The hardware-observed split: same shape, 1.1% apart, 5 vs 27 orders.
    split = [mk(7.513, 5, a), mk(7.596, 27, a)]
    out = _merge_close_modes(split, tol_freq=0.01, mac_min=0.95)
    assert len(out) == 1 and out[0].freq == 7.596 and out[0].n_orders == 27
    # Close in frequency but different shape: NOT merged (genuinely two
    # modes, e.g. a repeated-frequency pair).
    out = _merge_close_modes([mk(7.513, 5, a), mk(7.596, 27, b)],
                             tol_freq=0.01, mac_min=0.95)
    assert len(out) == 2
    # Well-separated: untouched.
    out = _merge_close_modes([mk(3.1, 20, a), mk(7.6, 20, a)],
                             tol_freq=0.01, mac_min=0.95)
    assert len(out) == 2


def test_modal_phase_collinearity_bounds():
    assert modal_phase_collinearity(np.array([1.0, -2.0, 0.5])) == pytest.approx(1.0)
    # Global phase rotation leaves MPC at 1.
    phi = np.array([1.0, -2.0, 0.5]) * np.exp(1j * 0.7)
    assert modal_phase_collinearity(phi) == pytest.approx(1.0)
    # Maximally phase-scattered: re/im balanced and orthogonal.
    phi = np.array([1.0 + 0j, 0.0 + 1.0j])
    assert modal_phase_collinearity(phi) == pytest.approx(0.0)
    assert modal_phase_collinearity(np.zeros(3)) == 0.0


def _write_acq_files(tmp_path, x, fs):
    from apda_fft_tpu.io import logfile

    paths = []
    for s in range(x.shape[0]):
        path = tmp_path / f"0013a20041e7f6c{s}_Xaxis_16_08_2026_11_00_00.log"
        logfile.write_acquisition_header(
            path, "11:00:00", "2g", f"{int(fs)} Hz", "X axis", "Synced",
            means=["22.0", "0.01", "0.01", "0.98"], humidity=50.0,
            baselines=(0.0, 0.0, 0.0),
        )
        logfile.append_samples(path, [f"{v:8.6f}" for v in x[s]])
        paths.append(str(path))
    return paths


def test_cli_ssi_json(tmp_path, capsys):
    import json

    from apda_fft_tpu.__main__ import main

    shapes = np.array([[0.5, 1.0, -0.8]])
    fs = 128.0
    x = _modal_records(shapes, [14.0], [0.015], fs, t_sec=120.0, seed=6)
    paths = _write_acq_files(tmp_path, x, fs)

    rc = main(["ssi", *paths, "--block-rows", "30", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fs"] == fs and len(out["files"]) == 3
    assert out["modes"], "expected at least one identified mode"
    m = min(out["modes"], key=lambda d: abs(d["freq"] - 14.0))
    assert abs(m["freq"] - 14.0) < 0.14  # off-grid: within 1%
    assert abs(m["damping_pct"] - 1.5) < 0.6
    assert m["mpc"] > 0.9 and m["n_orders"] >= 5
    got = np.array([c["re"] + 1j * c["im"] for c in m["shape"]])
    assert modal_assurance(got, shapes[0])[0, 0] > 0.9

    # Text mode on the same files.
    assert main(["ssi", *paths, "--block-rows", "30"]) == 0
    assert "stable over" in capsys.readouterr().out


def test_cli_ssi_out_npz(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs = 128.0
    shapes = np.array([[0.5, 1.0, -0.8]])
    x = _modal_records(shapes, [14.0], [0.015], fs, t_sec=120.0, seed=6)
    paths = _write_acq_files(tmp_path, x, fs)
    out = tmp_path / "diagram.npz"
    assert main(["ssi", *paths, "--block-rows", "30", "--out", str(out)]) == 0
    capsys.readouterr()
    d = np.load(out)
    n_poles = d["pole_freq"].shape[0]
    assert n_poles > 0
    assert d["pole_order"].shape == d["pole_damping"].shape == (n_poles,)
    assert d["pole_stable"].dtype == bool
    # The identified mode appears among the stable poles of its orders.
    assert d["mode_freq"].size >= 1
    f0 = d["mode_freq"][0]
    stable_f = d["pole_freq"][d["pole_stable"]]
    assert np.min(np.abs(stable_f - f0)) / f0 < 0.01
    assert d["hankel_sv"].ndim == 1 and np.all(np.diff(d["hankel_sv"]) <= 1e-9)
    assert d["mode_shapes"].shape == (d["mode_freq"].size, 3)


def test_cli_ssi_guards(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs = 128.0
    x = _modal_records(np.array([[1.0, 0.5]]), [10.0], [0.01], fs, 2.0, seed=7)
    paths = _write_acq_files(tmp_path, x, fs)
    # 2 s of data is too short for 40 block rows.
    assert main(["ssi", *paths, "--block-rows", "40"]) == 1
    assert "too short" in capsys.readouterr().err


def test_gateway_ssi_report_end_to_end(tmp_path):
    """3 simulated sensors, ssi_report only: [SSI] report at the sync boundary."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    shapes = np.array([[0.38, 0.92, 1.0]])
    x = _modal_records(shapes, [9.3], [0.012], fs, t_sec=40.0, seed=4)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"ssi_report": True, "ssi_block_rows": 20,
                       "fdd_min_sensors": 3},
    )
    assert svc.config.ssi_report and svc.config.ssi_block_rows == 20
    assert not svc.config.fdd_report
    macs = [f"0013a20041e7f6e{i}" for i in range(3)]
    for mac, rec in zip(macs, x):
        SensorSimulator(mac, fs=fs, axis="X", chunk=100).stream_acquisition(
            transport, rec
        )
    svc.drain()
    # Accumulation happens without fdd_report; flush waits for the sync.
    assert svc._fdd_pending
    assert "[SSI]" not in open(svc.config.logger_file).read()
    SensorSimulator(macs[0]).heartbeat(transport)
    svc.drain()

    history = open(svc.config.logger_file).read()
    assert "[SSI] X: 3 sensors" in history
    assert "[FDD]" not in history  # fdd_report stayed off
    import re as _re

    freqs = [float(m) for m in _re.findall(r"\[SSI\]   f=([0-9.]+) Hz", history)]
    # Poles are off-grid: within 1% of the planted 9.3 Hz.
    assert freqs and min(abs(f - 9.3) for f in freqs) < 0.093
    line = next(ln for ln in history.splitlines() if "[SSI]   f=" in ln)
    assert line.count("j") == 3 and "mpc=" in line and "orders=" in line


def test_gateway_ssi_and_fdd_share_groups(tmp_path):
    """Both reports on: one accumulation feeds [FDD] and [SSI] lines."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    shapes = np.array([[0.38, 0.92, 1.0]])
    x = _modal_records(shapes, [9.3], [0.012], fs, t_sec=40.0, seed=5)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 512,
                       "ssi_report": True, "fdd_min_sensors": 3},
    )
    macs = [f"0013a20041e7f6f{i}" for i in range(3)]
    for mac, rec in zip(macs, x):
        SensorSimulator(mac, fs=fs, axis="X", chunk=100).stream_acquisition(
            transport, rec
        )
    SensorSimulator(macs[0]).heartbeat(transport)
    svc.drain()
    history = open(svc.config.logger_file).read()
    assert "[FDD] X: 3 sensors" in history
    assert "[SSI] X: 3 sensors" in history
    assert not svc._fdd_pending  # group consumed once, by both reports


def test_gateway_ssi_short_records_skip(tmp_path):
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    rng = np.random.default_rng(0)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"ssi_report": True, "ssi_block_rows": 40,
                       "fdd_min_sensors": 2},
    )
    for i in range(2):
        SensorSimulator(f"0013a20041e7f70{i}", fs=fs, axis="X",
                        chunk=100).stream_acquisition(
            transport, rng.standard_normal(300).astype(np.float32)
        )
    SensorSimulator("0013a20041e7f700").heartbeat(transport)
    svc.drain()
    history = open(svc.config.logger_file).read()
    assert "[SSI]" in history and "skipping" in history


def test_modal_tracker_accepts_ssi_results_and_damping_alerts():
    from apda_fft_tpu.models.modal import ModalTracker
    from apda_fft_tpu.models.ssi import SSIMode, SSIResult

    def mk_res(freq, damping):
        shape = np.asarray([1.0, 0.5, -0.3], complex)
        m = SSIMode(freq=freq, damping=damping, shape=shape, order=20,
                    n_orders=10, freq_std=0.01, damping_std=0.05, mpc=1.0)
        return SSIResult(modes=[m], diagram=[], orders=np.asarray([20]),
                         hankel_sv=np.ones(9), n_sensors=3)

    tr = ModalTracker()
    # Healthy epochs at 1.0%, then a sustained rise to 1.8% (+80%).
    for d in (1.0, 1.02, 0.98, 1.8, 1.85, 1.78):
        tr.update(mk_res(9.3, d))
    assert not tr.damping_alerts(rel_increase=1.0)  # +100% not reached
    alerts = tr.damping_alerts(rel_increase=0.5)
    assert len(alerts) == 1
    a = alerts[0]
    assert a.birth_damping == pytest.approx(1.0)
    assert a.sustained_damping() == pytest.approx(1.8, abs=0.1)
    # The epoch floor is respected.
    assert not tr.damping_alerts(rel_increase=0.5, min_epochs=99)
    # The same track carries freq/MAC history like an FDD-fed one.
    assert len(tr.tracks()) == 1 and tr.tracks()[0].observed == 6
    assert min(tr.tracks()[0].macs) > 0.999

    # Zero birth damping (FDD's rejected-width convention) never alerts.
    tr2 = ModalTracker()
    for d in (0.0, 5.0, 5.0, 5.0, 5.0):
        tr2.update(mk_res(9.3, d))
    assert not tr2.damping_alerts(rel_increase=0.5)


def test_gateway_ssi_damping_alert(tmp_path):
    """Rising modal damping across epochs raises one [ALERT] line."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    shapes = np.array([[0.7, 1.0]])
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"ssi_report": True, "ssi_block_rows": 20,
                       "ssi_damping_alert": 0.5, "fdd_min_sensors": 2},
    )
    assert svc.config.ssi_damping_alert == 0.5
    macs = [f"0013a20041e7f71{i}" for i in range(2)]
    # 3 healthy epochs at 1%, then 3 degraded at 2.5% (+150%).
    for epoch, zeta in enumerate((0.01, 0.01, 0.01, 0.025, 0.025, 0.025)):
        x = _modal_records(shapes, [9.3], [zeta], fs, t_sec=40.0,
                           seed=20 + epoch)
        for mac, rec in zip(macs, x):
            SensorSimulator(mac, fs=fs, axis="X",
                            chunk=100).stream_acquisition(transport, rec)
        SensorSimulator(macs[0]).heartbeat(transport)
        svc.drain()
    history = open(svc.config.logger_file).read()
    assert "[SSI] X: 2 sensors" in history
    alerts = [ln for ln in history.splitlines()
              if "[ALERT] SSI damping increase" in ln]
    assert len(alerts) == 1, history
    assert "f=9.3" in alerts[0]


def test_modal_tracker_serialization_roundtrip():
    from apda_fft_tpu.models.modal import ModalTracker
    from apda_fft_tpu.models.ssi import SSIMode, SSIResult

    def mk_res(freq, damping, shape):
        m = SSIMode(freq=freq, damping=damping,
                    shape=np.asarray(shape, complex), order=20, n_orders=10,
                    freq_std=0.01, damping_std=0.05, mpc=1.0)
        return SSIResult(modes=[m], diagram=[], orders=np.asarray([20]),
                         hankel_sv=np.ones(9), n_sensors=len(shape))

    import json as _json

    tr = ModalTracker(rel_tol=0.07, mac_alert=0.93)
    for k, d in enumerate((1.0, 1.05, 1.7, 1.75)):
        tr.update(mk_res(9.3, d, [1.0, 0.4 - 0.01 * k, -0.3]), t=100.0 + k)
    tr.damping_alerts(rel_increase=0.5, min_epochs=3)[0].damping_alerted = True

    d = tr.to_dict()
    _json.loads(_json.dumps(d))  # JSON-serializable end to end
    mt2 = ModalTracker.from_dict(d)
    assert mt2.rel_tol == 0.07 and mt2.mac_alert == 0.93
    t1, t2 = tr.tracks()[0], mt2.tracks()[0]
    assert t1.freqs == t2.freqs and t1.dampings == t2.dampings
    assert t1.macs == t2.macs and t1.times == t2.times
    assert t2.damping_alerted and not t2.alerted
    np.testing.assert_array_equal(t1.ref_shape, t2.ref_shape)
    np.testing.assert_array_equal(t1.last_shape, t2.last_shape)
    # The restored tracker keeps matching and alerting identically.
    mt2.update(mk_res(9.31, 1.72, [1.0, 0.36, -0.3]), t=104.0)
    assert len(mt2.tracks()) == 1  # matched, not re-birthed
    assert mt2.damping_alerts(rel_increase=0.5, min_epochs=3)


def test_gateway_modal_baselines_survive_restart(tmp_path):
    """The damping baseline is the damage reference: a restart between the
    healthy and degraded epochs must NOT re-baseline — the alert still
    compares against the original birth damping."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    shapes = np.array([[0.7, 1.0]])
    extra = {"ssi_report": True, "ssi_block_rows": 20,
             "ssi_damping_alert": 0.5, "fdd_min_sensors": 2}
    macs = [f"0013a20041e7f72{i}" for i in range(2)]

    def run_epochs(svc, transport, zetas, seed0):
        for epoch, zeta in enumerate(zetas):
            x = _modal_records(shapes, [9.3], [zeta], fs, t_sec=40.0,
                               seed=seed0 + epoch)
            for mac, rec in zip(macs, x):
                SensorSimulator(mac, fs=fs, axis="X",
                                chunk=100).stream_acquisition(transport, rec)
            SensorSimulator(macs[0]).heartbeat(transport)
            svc.drain()

    svc1, transport1, _, _ = make_service(tmp_path, gateway_extra=extra)
    run_epochs(svc1, transport1, (0.01, 0.01, 0.01), seed0=40)
    assert os.path.exists(os.path.join(svc1.config.data_dir,
                                       "modal_tracks.json"))

    # Restart: a fresh service on the same data_dir restores the tracker.
    svc2, transport2, _, _ = make_service(tmp_path, gateway_extra=extra)
    assert svc2._ssi_trackers, "restored SSI trackers"
    (mt,) = svc2._ssi_trackers.values()
    assert mt.tracks()[0].birth_damping == pytest.approx(1.0, abs=0.4)
    run_epochs(svc2, transport2, (0.025, 0.025, 0.025), seed0=50)
    history = open(svc2.config.logger_file).read()
    alerts = [ln for ln in history.splitlines()
              if "[ALERT] SSI damping increase" in ln]
    assert len(alerts) == 1, history


def test_gateway_config_validates_ssi_block_rows(tmp_path):
    import json

    from apda_fft_tpu.gateway.config import GatewayConfig, GatewayConfigError

    cfg = {
        "gateway": {
            "logger_file": str(tmp_path / "history.log"),
            "device_file": str(tmp_path / "devices.txt"),
            "config_file": str(tmp_path / "config.txt"),
            "ssi_report": True,
            "ssi_block_rows": 1,
        }
    }
    p = tmp_path / "gw_config.json"
    p.write_text(json.dumps(cfg))
    with pytest.raises(GatewayConfigError, match="ssi_block_rows"):
        GatewayConfig.load(p)


def test_ssi_validation_errors():
    x = np.zeros((2, 4000), np.float32)
    with pytest.raises(ValueError, match="i >= 2"):
        ssi(x, FS, i=1)
    with pytest.raises(ValueError, match="fs"):
        ssi(x, 0.0)
    with pytest.raises(ValueError, match="underdetermined"):
        ssi(x, FS, i=4, orders=[2, 10])
    # The highest DETERMINED order is (i-1)*S, not i*S: O_up loses a block
    # row, so an i*S-order fit would be rank-deficient minimum-norm noise.
    with pytest.raises(ValueError, match="underdetermined"):
        ssi(np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32),
            FS, i=4, orders=[2, 8])  # i*S = 8 > (i-1)*S = 6
    res = ssi(np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32),
              FS, i=4, orders=[2, 6])  # exactly (i-1)*S: allowed
    assert list(res.orders) == [2, 6]
    with pytest.raises(ValueError, match="orders is empty"):
        ssi(x, FS, orders=[])
    with pytest.raises(ValueError, match=">= 2"):
        ssi(x, FS, orders=[1, 4])
    with pytest.raises(ValueError, match="min_orders"):
        ssi(x, FS, min_orders=0)
    with pytest.raises(ValueError, match="mpc_min"):
        ssi(x, FS, mpc_min=1.5)
    with pytest.raises(ValueError, match="S, T"):
        ssi(np.zeros(4000, np.float32), FS)


def test_cli_ssi_harmonics(tmp_path, capsys):
    import json

    from apda_fft_tpu.__main__ import main

    fs = 128.0
    shapes = np.array([[0.5, 1.0, -0.8]])
    x = _modal_records(shapes, [14.0], [0.015], fs, t_sec=240.0, seed=6,
                       sensor_noise=0.0)
    # Machinery harmonic with slight frequency wander (a mathematically
    # pure sine has a zero-damping pole that fails SSI's damping
    # stabilization - real rotating machinery always wanders a little).
    rng = np.random.default_rng(7)
    n = x.shape[-1]
    t = np.arange(n) / fs
    phase = 2 * np.pi * 31.83 * t + 0.02 * np.cumsum(rng.standard_normal(n))
    x = (x / x.std()
         + 0.8 * np.array([1.0, 0.9, 1.1])[:, None]
         * np.sin(phase)[None, :]).astype(np.float32)
    paths = _write_acq_files(tmp_path, x, fs)
    assert main(["ssi", *paths, "--block-rows", "30", "--harmonics",
                 "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    by_f = {round(m["freq"]): m for m in out["modes"]}
    assert 14 in by_f and 32 in by_f, sorted(by_f)
    assert by_f[14]["harmonic"] is False and by_f[14]["kurtosis"] > 2.5
    assert by_f[32]["harmonic"] is True and by_f[32]["kurtosis"] < 2.0
    assert main(["ssi", *paths, "--block-rows", "30", "--harmonics"]) == 0
    assert "HARMONIC" in capsys.readouterr().out


def test_damping_alert_requires_statistical_resolution():
    """A nominal +rel damping rise that does NOT clear
    sem_z=2 combined standard errors stays silent (single-epoch SSI damping
    is variance-bound at ~15% CoV - docs/DESIGN.md); the same means with
    tight windows alert."""
    from apda_fft_tpu.models.modal import ModalTracker
    from apda_fft_tpu.models.ssi import SSIMode, SSIResult

    def mk_res(freq, damping):
        shape = np.asarray([1.0, 0.5, -0.3], complex)
        m = SSIMode(freq=freq, damping=damping, shape=shape, order=20,
                    n_orders=10, freq_std=0.01, damping_std=0.05, mpc=1.0)
        return SSIResult(modes=[m], diagram=[], orders=np.asarray([20]),
                         hankel_sv=np.ones(9), n_sensors=3)

    # Noisy windows: base mean 1.0 (sem .29), recent mean 1.6 (sem .58):
    # +60% nominal but 0.6 < 2*sqrt(.29^2+.58^2) - unresolved, no alert.
    tr = ModalTracker()
    for d in (0.5, 1.5, 1.0, 0.6, 2.6, 1.6):
        tr.update(mk_res(9.3, d))
    assert not tr.damping_alerts(rel_increase=0.5)
    # sem_z=0 disables the resolution test: the relative rule alone fires.
    assert len(tr.damping_alerts(rel_increase=0.5, sem_z=0.0)) == 1

    # Same means, tight spread: resolved -> alerts.
    tr2 = ModalTracker()
    for d in (0.99, 1.0, 1.01, 1.59, 1.6, 1.61):
        tr2.update(mk_res(9.3, d))
    assert len(tr2.damping_alerts(rel_increase=0.5)) == 1
    w = tr2.tracks()[0].damping_windows()
    (mb, sb, nb), (mr, sr, nr) = w
    assert nb == 3 and nr == 3
    assert mb == pytest.approx(1.0, abs=1e-6)
    assert mr == pytest.approx(1.6, abs=1e-6)
    assert 0 < sb < 0.01 and 0 < sr < 0.01
