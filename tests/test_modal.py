"""FDD operational modal analysis (`models/modal.py`).

Validation strategy: (1) the CSD matrix against the already-scipy-checked
pairwise `cross_psd` / `welch_psd`, (2) the all-real batched power
iteration against `numpy.linalg.eigh` on the host-assembled complex
matrices, (3) end-to-end mode recovery on a synthetic multi-sensor modal
model with known shapes (white-noise-driven SDOF resonators mixed through
a mode-shape matrix - the textbook output-only identification setup).
"""

import numpy as np
import pytest

from apda_fft_tpu.models.modal import (
    FDDResult,
    csd_matrix,
    fdd,
    modal_assurance,
    sv_spectra,
)
from apda_fft_tpu.models.streaming import cross_psd, welch_psd
from apda_fft_tpu.utils.synthetic import modal_records as _modal_records


def test_csd_matrix_matches_pairwise_cross_psd():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    fs, window = 256.0, 512
    freqs, gr, gi = csd_matrix(x, fs, window)
    gr, gi = np.asarray(gr), np.asarray(gi)
    h = window // 2
    assert gr.shape == (h, 3, 3) and gi.shape == (h, 3, 3)

    for a in range(3):
        for b in range(3):
            fp, pxy = cross_psd(x[a], x[b], fs, window)
            np.testing.assert_allclose(freqs, fp, rtol=1e-6)
            got = gr[:, a, b] + 1j * gi[:, a, b]
            np.testing.assert_allclose(got, pxy, rtol=2e-4, atol=1e-7)
    # Diagonal is the auto-PSD.
    _, pxx = welch_psd(x[1], fs, window)
    np.testing.assert_allclose(gr[:, 1, 1], pxx, rtol=2e-4, atol=1e-7)


def test_csd_matrix_hermitian_dc_zero():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 2048)).astype(np.float32)
    _, gr, gi = csd_matrix(x, 100.0, 256)
    gr, gi = np.asarray(gr), np.asarray(gi)
    np.testing.assert_allclose(gr, np.swapaxes(gr, -1, -2), atol=1e-7)
    np.testing.assert_allclose(gi, -np.swapaxes(gi, -1, -2), atol=1e-7)
    assert np.all(gr[0] == 0) and np.all(gi[0] == 0)


def test_sv_spectra_match_numpy_eigh():
    rng = np.random.default_rng(9)
    h, s = 64, 5
    a = rng.standard_normal((h, s, 3)) + 1j * rng.standard_normal((h, s, 3))
    g = a @ a.conj().swapaxes(-1, -2)  # Hermitian PSD, rank 3
    s1, s2, vr, vi = (
        np.asarray(t)
        for t in sv_spectra(
            np.real(g).astype(np.float32), np.imag(g).astype(np.float32)
        )
    )
    w, v = np.linalg.eigh(g)  # ascending
    np.testing.assert_allclose(s1, w[:, -1], rtol=5e-4)
    np.testing.assert_allclose(s2, w[:, -2], rtol=5e-3, atol=1e-3 * w[:, -1].max())
    # Dominant eigenvector aligned (MAC ~ 1 per frequency line).
    got = vr + 1j * vi
    want = v[:, :, -1]
    mac = np.abs(np.sum(got.conj() * want, axis=-1)) ** 2 / (
        np.sum(np.abs(got) ** 2, axis=-1) * np.sum(np.abs(want) ** 2, axis=-1)
    )
    assert mac.min() > 0.999
    # Phase fix: largest component real positive.
    j = np.argmax(np.abs(got) ** 2, axis=-1)
    picked = got[np.arange(h), j]
    assert np.abs(np.imag(picked)).max() < 1e-4
    assert np.real(picked).min() > 0


def test_sv_spectra_rank1_exact():
    rng = np.random.default_rng(10)
    v = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    lam = 3.7
    g = lam * np.outer(v, v.conj()) / np.vdot(v, v).real
    s1, s2, _, _ = (
        np.asarray(t)
        for t in sv_spectra(
            np.real(g)[None].astype(np.float32), np.imag(g)[None].astype(np.float32)
        )
    )
    np.testing.assert_allclose(s1[0], lam, rtol=1e-5)
    assert 0.0 <= s2[0] < 1e-5 * lam


def test_fdd_recovers_modes_and_shapes():
    # 4-sensor line structure, first two bending-like modes.
    shapes = np.array(
        [
            [0.38, 0.71, 0.92, 1.0],  # mode 1: all in phase
            [0.87, 1.0, 0.28, -0.75],  # mode 2: sign change along the line
        ]
    )
    fs = 128.0
    x = _modal_records(shapes, [9.3, 23.8], [0.012, 0.01], fs, t_sec=240.0, seed=3)
    res = fdd(x, fs, window=1024)
    assert isinstance(res, FDDResult)
    assert int(res.count) >= 2

    found = res.freq[: int(res.count)]
    df = fs / 1024.0
    err1 = np.min(np.abs(found - 9.3))
    err2 = np.min(np.abs(found - 23.8))
    assert err1 <= 2 * df and err2 <= 2 * df, (found, df)

    # Mode shapes: MAC > 0.95 against the truth for both modes.
    i1 = int(np.argmin(np.abs(found - 9.3)))
    i2 = int(np.argmin(np.abs(found - 23.8)))
    est = res.shapes()[[i1, i2]]
    mac = modal_assurance(est, shapes)
    assert mac[0, 0] > 0.95 and mac[1, 1] > 0.95, mac
    assert mac[0, 1] < 0.3 and mac[1, 0] < 0.3, mac
    # Well-separated modes: the s2/s1 separation ratio stays low.
    assert res.sv_ratio[i1] < 0.6 and res.sv_ratio[i2] < 0.6
    # Spectra exposed for plotting, finite and ordered.
    assert res.sv1.shape == res.sv2.shape == res.freqs.shape
    assert np.all(res.sv1 >= res.sv2) and np.all(res.sv2 >= 0)


def test_fdd_damping_ballpark():
    shapes = np.array([[0.6, 1.0, 0.8]])
    fs = 128.0
    zeta = 0.02
    x = _modal_records(shapes, [12.0], [zeta], fs, t_sec=480.0, seed=5)
    res = fdd(x, fs, window=1024)
    assert int(res.count) >= 1
    i = int(np.argmin(np.abs(res.freq[: int(res.count)] - 12.0)))
    # Half-power estimate on a Welch-averaged bell: right order of magnitude
    # (taper broadening biases it up; this pins the scale, not the digit).
    assert 0.5 * 100 * zeta <= res.damping[i] <= 6 * 100 * zeta, res.damping[i]


def test_efdd_damping_beats_half_power():
    shapes = np.array([[0.6, 1.0, 0.8]])
    fs = 128.0
    zeta = 0.015
    x = _modal_records(shapes, [12.0], [zeta], fs, t_sec=600.0, seed=7,
                       sensor_noise=0.01)
    res = fdd(x, fs, window=2048, efdd=True)
    assert int(res.count) >= 1
    i = int(np.argmin(np.abs(res.freq[: int(res.count)] - 12.0)))
    got = res.damping_efdd[i]
    assert np.isfinite(got)
    true_pct = 100 * zeta
    # EFDD should land within +-40% of truth AND be at least as close as the
    # resolution-limited half-power number.
    assert 0.6 * true_pct <= got <= 1.4 * true_pct, (got, true_pct)
    assert abs(got - true_pct) <= abs(res.damping[i] - true_pct) + 1e-9
    # Modes not requested / invalid slots stay NaN.
    res_off = fdd(x, fs, window=2048)
    assert np.all(np.isnan(res_off.damping_efdd))


def test_efdd_guards_return_nan():
    from apda_fft_tpu.models.modal import _efdd_zeta

    h, s = 64, 3
    sv1 = np.zeros(h)
    sv1[10] = 1.0  # single-bin bell -> too narrow
    vr = np.tile(np.array([1.0, 0.0, 0.0]), (h, 1))
    vi = np.zeros((h, s))
    assert np.isnan(_efdd_zeta(sv1, vr, vi, 10, 128.0, 128))


def test_fdd_single_sensor_reduces_to_psd_peaks():
    from tests.signals import two_mode_signal

    fs = 500.0
    x = two_mode_signal(16384, fs, seed=11)[None, :].astype(np.float32)
    res = fdd(x, fs, window=2048)
    _, pxx = welch_psd(x[0], fs, 2048)
    # 1x1 CSD: s1 IS the auto-PSD, s2 = 0, shape = [1.0].
    np.testing.assert_allclose(res.sv1, np.asarray(pxx), rtol=5e-4, atol=1e-9)
    assert np.all(res.sv2 <= 1e-6 * res.sv1.max())
    n = int(res.count)
    assert n >= 2
    assert np.allclose(res.shape_re[:n], 1.0) and np.allclose(res.shape_im[:n], 0.0)
    found = res.freq[:n]
    assert np.min(np.abs(found - 12.3)) < 0.3
    assert np.min(np.abs(found - 47.7)) < 0.3


def test_fdd_fuzz_vs_eigh_oracle():
    """Randomized realistic CSDs: power-iteration triplets == float64 eigh.

    A 6-case version of the on-device FDD fuzz (S in 2..6, 1-3 modes); the
    only expected non-oracle deviations are weak modes below the
    detector's reference mean+2*std threshold, which the eigh oracle's
    detection misses identically.
    """
    from apda_fft_tpu.models.modal import csd_matrix, fdd, sv_spectra

    rng = np.random.default_rng(20260817)
    for case in range(6):
        s = int(rng.integers(2, 7))
        n_modes = int(rng.integers(1, min(s, 3) + 1))
        fs = float(rng.choice([100.0, 125.0, 250.0]))
        window = 512
        freqs = np.sort(rng.uniform(0.08, 0.4, n_modes)) * fs / 2
        while n_modes > 1 and np.min(np.diff(freqs)) < 6 * fs / window:
            freqs = np.sort(rng.uniform(0.08, 0.4, n_modes)) * fs / 2
        zetas = rng.uniform(0.006, 0.03, n_modes)
        shapes = rng.standard_normal((n_modes, s))
        shapes /= np.linalg.norm(shapes, axis=1, keepdims=True)
        x = _modal_records(shapes, freqs, zetas, fs, t_sec=120.0,
                           seed=case, sensor_noise=0.03)

        res = fdd(x, fs, window)
        _, gr, gi = csd_matrix(x, fs, window)
        g = np.asarray(gr, np.float64) + 1j * np.asarray(gi, np.float64)
        w_e, v_e = np.linalg.eigh(g)
        rel = np.max(np.abs(res.sv1.astype(np.float64) - w_e[:, -1])) / max(
            w_e[:, -1].max(), 1e-30
        )
        assert rel < 2e-3, (case, rel)
        for i in range(int(res.count)):
            b = int(res.idx[i])
            ve, vp = v_e[b, :, -1], res.shapes()[i]
            mac = abs(np.vdot(vp, ve)) ** 2 / (
                np.vdot(vp, vp).real * np.vdot(ve, ve).real
            )
            assert mac > 0.995, (case, i, mac)


def test_sv_spectra_shards_collective_free_on_mesh():
    """The per-frequency SVD partitions over the frequency axis with zero
    collectives (the all-real power iteration is batched einsum matvecs -
    no eigh/SVD custom call to block SPMD), and sharded results match the
    single-device ones exactly."""
    import jax

    from apda_fft_tpu.models.modal import sv_spectra
    from apda_fft_tpu.parallel.mesh import make_mesh, shard_batch

    rng = np.random.default_rng(5)
    h, s = 64, 4
    a = rng.standard_normal((h, s, 3)) + 1j * rng.standard_normal((h, s, 3))
    g = a @ a.conj().swapaxes(-1, -2)
    gr = np.real(g).astype(np.float32)
    gi = np.imag(g).astype(np.float32)

    ref = sv_spectra(gr, gi)
    mesh = make_mesh(8, ("data",))
    gr_s = shard_batch(gr, mesh)
    gi_s = shard_batch(gi, mesh)
    lowered = jax.jit(sv_spectra, static_argnames=("iters",)).lower(gr_s, gi_s)
    hlo = lowered.compile().as_text()
    for coll in ("all-reduce", "all-gather", "all-to-all", "collective-permute"):
        assert coll not in hlo, f"unexpected {coll}"
    got = jax.jit(sv_spectra, static_argnames=("iters",))(gr_s, gi_s)
    for r, g2 in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g2))


def test_modal_assurance_properties():
    rng = np.random.default_rng(12)
    a = rng.standard_normal((3, 6)) + 1j * rng.standard_normal((3, 6))
    mac = modal_assurance(a, a)
    np.testing.assert_allclose(np.diag(mac), 1.0, atol=1e-12)
    # Invariant to complex scaling.
    mac2 = modal_assurance(a * (2.0 - 1.5j), a)
    np.testing.assert_allclose(mac2, mac, atol=1e-12)
    assert mac.min() >= 0 and mac.max() <= 1 + 1e-12
    # 1-D input convenience.
    one = modal_assurance(a[0], a[0])
    assert one.shape == (1, 1) and abs(one[0, 0] - 1) < 1e-12
    with pytest.raises(ValueError):
        modal_assurance(a, rng.standard_normal((2, 5)))


def test_cli_fdd_json(tmp_path, capsys):
    import json

    from apda_fft_tpu.__main__ import main
    from apda_fft_tpu.io import logfile

    shapes = np.array([[0.5, 1.0, -0.8]])
    fs = 128.0
    x = _modal_records(shapes, [14.0], [0.015], fs, t_sec=120.0, seed=6)
    paths = []
    for s in range(x.shape[0]):
        path = tmp_path / f"0013a20041e7f6b{s}_Xaxis_16_08_2026_10_20_30.log"
        logfile.write_acquisition_header(
            path, "10:20:30", "2g", "128 Hz", "X axis", "Synced",
            means=["22.0", "0.01", "0.01", "0.98"], humidity=50.0,
            baselines=(0.0, 0.0, 0.0),
        )
        logfile.append_samples(path, [f"{v:8.6f}" for v in x[s]])
        paths.append(str(path))

    rc = main(["fdd", *paths, "--window", "512", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fs"] == fs and len(out["files"]) == 3
    assert out["modes"], "expected at least one identified mode"
    m = min(out["modes"], key=lambda m: abs(m["freq"] - 14.0))
    assert abs(m["freq"] - 14.0) <= 2 * fs / 512
    got = np.array([c["re"] + 1j * c["im"] for c in m["shape"]])
    mac = modal_assurance(got, shapes[0])
    assert mac[0, 0] > 0.9, (got, mac)

    # Text mode and the mismatched-rate guard.
    assert main(["fdd", *paths, "--window", "512"]) == 0
    assert "shape=" in capsys.readouterr().out


def test_cli_fdd_rejects_mixed_rates(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main
    from apda_fft_tpu.io import logfile

    rng = np.random.default_rng(0)
    paths = []
    for s, fs_s in enumerate(("128 Hz", "256 Hz")):
        path = tmp_path / f"0013a20041e7f6c{s}_Xaxis_16_08_2026_10_20_30.log"
        logfile.write_acquisition_header(
            path, "10:20:30", "2g", fs_s, "X axis", "Synced",
            means=["22.0", "0.01", "0.01", "0.98"], humidity=50.0,
            baselines=(0.0, 0.0, 0.0),
        )
        logfile.append_samples(
            path, [f"{v:8.6f}" for v in rng.standard_normal(2048)]
        )
        paths.append(str(path))
    assert main(["fdd", *paths]) == 1
    assert "sampling rates differ" in capsys.readouterr().err


def _mk_fdd_result(freqs, shapes, dampings=None):
    """Hand-built FDDResult for tracker tests (no FFT involved)."""
    from apda_fft_tpu.models.modal import FDDResult

    k = len(freqs)
    shapes = np.asarray(shapes, np.complex128)
    norm = np.linalg.norm(shapes, axis=-1, keepdims=True)
    shapes = shapes / np.where(norm > 0, norm, 1.0)
    damp = np.asarray(dampings if dampings is not None else [1.0] * k, np.float32)
    h = 8
    return FDDResult(
        count=np.int32(k),
        idx=np.arange(1, k + 1, dtype=np.int32),
        freq=np.asarray(freqs, np.float32),
        damping=damp,
        sv_ratio=np.zeros(k, np.float32),
        shape_re=np.real(shapes).astype(np.float32),
        shape_im=np.imag(shapes).astype(np.float32),
        freqs=np.arange(h, dtype=np.float32),
        sv1=np.ones(h, np.float32),
        sv2=np.zeros(h, np.float32),
        damping_efdd=np.full(k, np.nan, np.float32),
    )


def test_modal_tracker_follows_modes_through_crossing():
    from apda_fft_tpu.models.modal import ModalTracker

    a = [1.0, 1.0, 1.0, 1.0]
    b = [1.0, 0.4, -0.5, -1.0]
    tr = ModalTracker(rel_tol=0.06)
    t1 = tr.update(_mk_fdd_result([10.0, 10.8], [a, b]))
    id_a = next(t.track_id for t in t1 if abs(t.last_freq - 10.0) < 1e-6)
    id_b = next(t.track_id for t in t1 if abs(t.last_freq - 10.8) < 1e-6)
    # The modes cross: the A-shaped mode is now ABOVE the B-shaped one, and
    # each new frequency is closer to the OTHER track's last frequency.
    # Frequency-nearest matching would swap the identities; MAC keeps them.
    tr.update(_mk_fdd_result([10.5, 10.4], [a, b]))
    tracks = {t.track_id: t for t in tr.tracks()}
    assert [round(f, 4) for f in tracks[id_a].freqs] == [10.0, 10.5]
    assert [round(f, 4) for f in tracks[id_b].freqs] == [10.8, 10.4]
    assert min(tracks[id_a].macs) > 0.99 and min(tracks[id_b].macs) > 0.99


def test_modal_tracker_shape_alert_fires():
    from apda_fft_tpu.models.modal import ModalTracker

    base = np.array([1.0, 0.8, 0.5, 0.2])
    tr = ModalTracker(mac_alert=0.95, mac_min=0.5)
    for step in range(5):
        # Progressive local stiffness change: one component drifts off.
        shape = base.copy()
        shape[2] = 0.5 - 0.22 * step
        tr.update(_mk_fdd_result([12.0], [shape]))
    assert not tr.shape_alerts(min_epochs=99)  # epoch floor respected
    alerts = tr.shape_alerts(min_epochs=3)
    assert len(alerts) == 1
    assert alerts[0].sustained_mac() < 0.95
    assert alerts[0].macs[0] == 1.0 and alerts[0].macs[-1] < 0.9
    # Stable shape never alerts.
    tr2 = ModalTracker(mac_alert=0.95)
    for _ in range(5):
        tr2.update(_mk_fdd_result([12.0], [base]))
    assert not tr2.shape_alerts()


def test_modal_tracker_retirement_and_serialization():
    import json as _json

    from apda_fft_tpu.models.modal import ModalTracker

    shape = [1.0, 0.5]
    tr = ModalTracker(max_missed=2)
    tr.update(_mk_fdd_result([8.0], [shape]))
    for _ in range(4):
        tr.update(_mk_fdd_result([], np.zeros((0, 2))))
    # Retired to archive; a re-appearance births a NEW track.
    t2 = tr.update(_mk_fdd_result([8.0], [shape]))
    assert len(tr.tracks()) == 2
    assert t2[0].track_id != tr.tracks()[-1].track_id or len(tr._archive) == 1
    d = tr.tracks()[0].to_dict()
    _json.dumps(d)  # JSON-serializable
    assert d["epochs"] >= 1 and len(d["ref_shape"][0]) == 2


def test_gateway_fdd_report_end_to_end(tmp_path):
    """3 simulated sensors, same axis: [FDD] modal report in history.log."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    shapes = np.array([[0.38, 0.92, 1.0]])
    x = _modal_records(shapes, [9.3], [0.012], fs, t_sec=40.0, seed=4)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 512,
                       "fdd_min_sensors": 3},
    )
    assert svc.config.fdd_report and svc.config.fdd_window == 512
    macs = [f"0013a20041e7f6b{i}" for i in range(3)]
    for mac, rec in zip(macs, x):
        SensorSimulator(mac, fs=fs, axis="X", chunk=100).stream_acquisition(
            transport, rec
        )
    svc.drain()
    # The array report flushes at the sync boundary (like uploads).
    assert "[FDD]" not in open(svc.config.logger_file).read()
    # Per-sensor results were stored as usual alongside the accumulation.
    assert all(mac in svc.fft_results for mac in macs)
    SensorSimulator(macs[0]).heartbeat(transport)
    svc.drain()

    history = open(svc.config.logger_file).read()
    assert "[FDD] X: 3 sensors" in history
    # The 9.3 Hz mode lands within a bin of the segment grid.
    df = fs / 512
    import re as _re

    freqs = [float(m) for m in _re.findall(r"\[FDD\]   f=([0-9.]+) Hz", history)]
    assert freqs and min(abs(f - 9.3) for f in freqs) <= 2 * df
    # Shape has one component per sensor.
    line = next(ln for ln in history.splitlines() if "[FDD]   f=" in ln)
    assert line.count("j") == 3


def test_gateway_fdd_report_skips_below_min_sensors(tmp_path):
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    shapes = np.array([[1.0, 0.5]])
    x = _modal_records(shapes, [9.3], [0.012], fs, t_sec=40.0, seed=4)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 512,
                       "fdd_min_sensors": 3},
    )
    for i, rec in enumerate(x):
        SensorSimulator(f"0013a20041e7f6c{i}", fs=fs, axis="X",
                        chunk=100).stream_acquisition(transport, rec)
    SensorSimulator("0013a20041e7f6c0").heartbeat(transport)
    svc.drain()
    assert "[FDD]" not in open(svc.config.logger_file).read()
    # The under-min group retires after a few syncs instead of accumulating.
    for _ in range(svc._FDD_PENDING_MAX_AGE + 1):
        SensorSimulator("0013a20041e7f6c0").heartbeat(transport)
        svc.drain()
    assert not svc._fdd_pending


def test_gateway_fdd_report_short_records_warn(tmp_path):
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    rng = np.random.default_rng(0)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 512,
                       "fdd_min_sensors": 2},
    )
    for i in range(2):
        SensorSimulator(f"0013a20041e7f6d{i}", fs=fs, axis="X",
                        chunk=100).stream_acquisition(
            transport, rng.standard_normal(600).astype(np.float32)
        )
    SensorSimulator("0013a20041e7f6d0").heartbeat(transport)
    svc.drain()
    history = open(svc.config.logger_file).read()
    assert "skipping" in history and "[FDD]" in history


def test_gateway_fdd_shape_alert(tmp_path):
    """A progressive mode-shape change across epochs raises one [ALERT]."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 512,
                       "fdd_min_sensors": 3, "fdd_mac_alert": 0.95},
    )
    macs = [f"0013a20041e7f6e{i}" for i in range(3)]
    for epoch in range(6):
        # Sensor 2's component degrades epoch over epoch (local stiffness
        # change at that sensor's position): gradual enough to keep matching
        # the track (MAC >= mac_min) while the sustained MAC crosses the
        # alert threshold (measured MACs ~[1, .996, .982, .954, .909, .844]).
        shapes = np.array([[0.38, 0.92, 1.0 - 0.12 * epoch]])
        x = _modal_records(shapes, [9.3], [0.012], fs, t_sec=40.0,
                           seed=10 + epoch)
        for mac, rec in zip(macs, x):
            SensorSimulator(mac, fs=fs, axis="X", chunk=100).stream_acquisition(
                transport, rec
            )
        SensorSimulator(macs[0]).heartbeat(transport)
        svc.drain()
    history = open(svc.config.logger_file).read()
    assert "[ALERT] FDD mode-shape change: X" in history
    # Dedup: exactly one alert line for the track.
    assert history.count("[ALERT] FDD mode-shape change") == 1


def test_gateway_fdd_roster_change_does_not_crash_sync(tmp_path):
    """A sensor joining between epochs starts a fresh tracker, no exception."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 512,
                       "fdd_min_sensors": 2},
    )
    for epoch, n_sensors in ((0, 2), (1, 3)):
        shapes = np.array([[0.38, 0.92, 1.0][:n_sensors]])
        x = _modal_records(shapes, [9.3], [0.012], fs, t_sec=30.0, seed=epoch)
        for i in range(n_sensors):
            SensorSimulator(f"0013a20041e7f6f{i}", fs=fs, axis="X",
                            chunk=100).stream_acquisition(transport, x[i])
        SensorSimulator("0013a20041e7f6f0").heartbeat(transport)
        svc.drain()
    history = open(svc.config.logger_file).read()
    assert "[FDD] X: 2 sensors" in history and "[FDD] X: 3 sensors" in history
    assert "FDD tracking failed" not in history
    assert "Error in main loop" not in history
    # Two tracker keys: one per roster.
    assert len(svc._modal_trackers) == 2


def test_gateway_fdd_drops_stale_pending_records(tmp_path):
    """A record left pending from an old epoch is not mixed into a new CSD."""
    from datetime import datetime, timedelta

    from tests.test_gateway import make_service

    svc, _, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 256,
                       "fdd_min_sensors": 2},
    )
    rng = np.random.default_rng(0)
    t0 = datetime(2026, 8, 16, 10, 0, 0)
    fresh = t0 + timedelta(seconds=400)
    svc._fdd_pending[("X", 125.0)] = {
        "aaaa": (rng.standard_normal(2048).astype(np.float32), t0),
        "bbbb": (rng.standard_normal(2048).astype(np.float32), fresh),
        "cccc": (rng.standard_normal(2048).astype(np.float32),
                 fresh + timedelta(seconds=5)),
    }
    svc._fdd_flush()
    history = open(svc.config.logger_file).read()
    assert "dropping stale X record from aaaa" in history
    # The two aligned records still ran.
    assert "[FDD] X: 2 sensors (bbbb, cccc)" in history


def test_modal_tracker_history_and_archive_bounds():
    from apda_fft_tpu.models.modal import ModalTracker

    shape = [1.0, 0.5]
    tr = ModalTracker(history_cap=32, max_missed=1)
    for _ in range(64):
        tr.update(_mk_fdd_result([8.0], [shape]))
    t0 = tr.tracks()[0]
    assert len(t0.freqs) == 32 and t0.observed == 64
    assert len(t0.times) == len(t0.dampings) == len(t0.macs) == 32
    # Archive is bounded too: churn many short-lived tracks through one
    # tracker (each birth misses out two epochs later and retires).
    tr3 = ModalTracker(max_missed=1, rel_tol=1e-6)
    for i in range(ModalTracker.ARCHIVE_KEEP + 40):
        tr3.update(_mk_fdd_result([100.0 + i], [shape]))
        tr3.update(_mk_fdd_result([], np.zeros((0, 2))))
        tr3.update(_mk_fdd_result([], np.zeros((0, 2))))
    assert len(tr3._archive) <= ModalTracker.ARCHIVE_KEEP


def test_cli_fdd_hop_validation(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main
    from apda_fft_tpu.io import logfile

    rng = np.random.default_rng(0)
    paths = []
    for s in range(2):
        path = tmp_path / f"0013a20041e7f6a{s}_Xaxis_16_08_2026_10_20_30.log"
        logfile.write_acquisition_header(
            path, "10:20:30", "2g", "128 Hz", "X axis", "Synced",
            means=["22.0", "0.01", "0.01", "0.98"], humidity=50.0,
            baselines=(0.0, 0.0, 0.0),
        )
        logfile.append_samples(
            path, [f"{v:8.6f}" for v in rng.standard_normal(2048)]
        )
        paths.append(str(path))
    # hop 0: clean error, not a ZeroDivisionError traceback.
    assert main(["fdd", *paths, "--window", "1024", "--hop", "0"]) == 1
    assert "--hop must be >= 1" in capsys.readouterr().err
    # Huge hop: one segment only -> clean error with the real arithmetic.
    assert main(["fdd", *paths, "--window", "1024", "--hop", "2000"]) == 1
    assert ">= 2 segments" in capsys.readouterr().err
    # Small hop on a length the old 2*window pre-check would have rejected:
    # 1.6 segments-wise fine (hop 256 -> 5 segments over 2048).
    assert main(["fdd", *paths, "--window", "1024", "--hop", "256"]) == 0


def test_gateway_config_fdd_validation(tmp_path):
    import json as _json

    from apda_fft_tpu.gateway.config import GatewayConfig, GatewayConfigError

    def cfg(extra):
        path = tmp_path / "gw.json"
        base = {
            "gateway": {
                "logger_file": str(tmp_path / "history.log"),
                "device_file": str(tmp_path / "devices.txt"),
                "config_file": str(tmp_path / "config.txt"),
                **extra,
            }
        }
        path.write_text(_json.dumps(base))
        return GatewayConfig.load(path)

    c = cfg({"fdd_report": True, "fdd_window": 2048, "fdd_min_sensors": 4})
    assert c.fdd_report and c.fdd_window == 2048 and c.fdd_min_sensors == 4
    assert not cfg({}).fdd_report  # default off = reference parity
    with pytest.raises(GatewayConfigError, match="fdd_window"):
        cfg({"fdd_window": 2})
    with pytest.raises(GatewayConfigError, match="fdd_min_sensors"):
        cfg({"fdd_min_sensors": 0})


def test_fdd_validation_errors():
    x = np.zeros((2, 600), np.float32)
    with pytest.raises(ValueError, match=">= 2 segments"):
        fdd(x, 100.0, window=512)
    with pytest.raises(ValueError, match=r"\[S, T\]"):
        fdd(np.zeros((2, 2, 512), np.float32), 100.0, window=128)
    with pytest.raises(ValueError, match="taper"):
        csd_matrix(x, 100.0, 128, taper="boxcar")


def test_lru_tracker_never_evicts_active_roster():
    """Regression: at the roster cap, updating the insertion-OLDEST key must
    not evict the tracker being updated (setdefault + pop-oldest did)."""
    from apda_fft_tpu.gateway.service import GatewayService
    from apda_fft_tpu.models.modal import ModalTracker

    class _Svc:  # the method only touches the eviction counter
        tracker_evictions = 0

    svc = _Svc()
    lru = lambda *a, **k: GatewayService._lru_tracker(svc, *a, **k)  # noqa: E731
    trackers: dict = {}
    active = ("X", 125.0, ("aaaa", "bbbb"))
    born = lru(trackers, active, ModalTracker, cap=64)
    for i in range(63):
        lru(trackers, ("X", 125.0, (f"s{i}",)), ModalTracker, cap=64)
    assert len(trackers) == 64 and next(iter(trackers)) == active
    # Touching the oldest (= active) key keeps the SAME tracker object and
    # moves it to most-recent; nothing is evicted at exactly cap.
    again = lru(trackers, active, ModalTracker, cap=64)
    assert again is born and len(trackers) == 64
    assert list(trackers)[-1] == active
    assert svc.tracker_evictions == 0
    # A genuinely new 65th key evicts the least-recently-used ("s0"),
    # never the active roster - and the eviction is counted.
    lru(trackers, ("Y", 125.0, ("new",)), ModalTracker, cap=64)
    assert active in trackers and ("X", 125.0, ("s0",)) not in trackers
    assert len(trackers) == 64
    assert svc.tracker_evictions == 1


# ------------------------------------------------------ harmonic indicator


def _mode_plus_harmonic(fs=200.0, t_sec=300.0, f_mode=9.3, f_harm=25.37,
                        seed=0, harm_shape=(1.0, 0.9), mode_shape=(1.0, 0.6)):
    rng = np.random.default_rng(seed)
    x = _modal_records(np.array([mode_shape]), [f_mode], [0.02], fs, t_sec,
                       seed=seed, sensor_noise=0.0)
    t = np.arange(x.shape[-1]) / fs
    harm = np.sin(2 * np.pi * f_harm * t + 0.3)
    x = x / x.std() + 0.8 * np.asarray(harm_shape)[:, None] * harm[None, :]
    x += 0.05 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def test_harmonic_indicator_separates_sine_from_mode():
    from apda_fft_tpu.models.modal import harmonic_indicator

    fs = 200.0
    x = _mode_plus_harmonic(fs=fs)
    kap = harmonic_indicator(x, fs, [9.3, 25.37, 60.0], window=1024)
    assert kap[0] > 2.5, f"structural mode read {kap[0]} (expected ~3)"
    assert kap[1] < 2.0, f"harmonic read {kap[1]} (expected ~1.5)"
    # Noise-only band is Gaussian too - near 3, never harmonic-like.
    assert kap[2] > 2.5
    # Out-of-band / DC / non-finite frequencies return NaN, never crash.
    # DC, Nyquist-and-above, and non-finite queries return NaN; an in-band
    # noise-only frequency stays finite.
    kap2 = harmonic_indicator(x, fs, [0.0, fs / 2, fs, np.nan, 80.0],
                              window=1024)
    assert np.isnan(kap2[:4]).all() and np.isfinite(kap2[4])
    # Single-channel [T] input works.
    k1 = harmonic_indicator(x[0], fs, [25.37], window=1024)
    assert k1[0] < 2.0


def test_harmonic_indicator_energy_weights_node_sensor():
    """A sensor at a node of the harmonic carries only noise (kurtosis ~3);
    energy weighting keeps the array answer harmonic-like."""
    from apda_fft_tpu.models.modal import harmonic_indicator

    fs = 200.0
    x = _mode_plus_harmonic(fs=fs, harm_shape=(1.0, 0.0))
    kap = harmonic_indicator(x, fs, [25.37], window=1024)
    assert kap[0] < 2.0, kap


def test_harmonic_indicator_validation():
    from apda_fft_tpu.models.modal import harmonic_indicator

    x = np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32)
    with pytest.raises(ValueError, match=r"\[S, T\]"):
        harmonic_indicator(np.zeros((2, 2, 64), np.float32), 100.0, [5.0])
    with pytest.raises(ValueError, match="too short"):
        harmonic_indicator(x[:, :100], 100.0, [5.0], window=1024)
    with pytest.raises(ValueError, match="rel_bandwidth"):
        harmonic_indicator(x, 100.0, [5.0], rel_bandwidth=0.7)
    with pytest.raises(ValueError, match="window"):
        harmonic_indicator(x, 100.0, [5.0], window=4)


def test_fdd_harmonics_flags_machinery_line():
    fs = 200.0
    x = _mode_plus_harmonic(fs=fs)
    res = fdd(x, fs, window=1024, harmonics=True)
    n = int(res.count)
    assert n >= 2
    freqs = res.freq[:n]
    mask = res.harmonic_mask()
    i_mode = int(np.argmin(np.abs(freqs - 9.3)))
    i_harm = int(np.argmin(np.abs(freqs - 25.37)))
    assert not mask[i_mode] and mask[i_harm], (freqs, res.kurtosis, mask)
    assert np.isfinite(res.kurtosis[:n]).all()
    assert np.isnan(res.kurtosis[n:]).all()
    # harmonics=False keeps the field NaN and the mask empty.
    res0 = fdd(x, fs, window=1024)
    assert np.isnan(res0.kurtosis).all() and not res0.harmonic_mask().any()


def test_fddresult_harmonic_mask_backward_compat():
    """Old-style FDDResult construction (no kurtosis field) never flags."""
    from apda_fft_tpu.models.modal import FDDResult

    r = FDDResult(
        count=np.int32(1), idx=np.array([3]), freq=np.array([1.0]),
        damping=np.array([0.5]), sv_ratio=np.array([0.1]),
        shape_re=np.zeros((1, 2)), shape_im=np.zeros((1, 2)),
        freqs=np.zeros(8), sv1=np.zeros(8), sv2=np.zeros(8),
        damping_efdd=np.array([np.nan]),
    )
    assert r.kurtosis is None
    assert not r.harmonic_mask().any()


def test_cli_fdd_harmonics(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs = 200.0
    x = _mode_plus_harmonic(fs=fs, t_sec=120.0)
    from tests.test_ssi import _write_acq_files

    paths = _write_acq_files(tmp_path, x, fs)
    import json

    assert main(["fdd", *paths, "--window", "1024", "--harmonics",
                 "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    by_f = {round(m["freq"]): m for m in out["modes"]}
    assert by_f[9]["harmonic"] is False and by_f[9]["kurtosis"] > 2.5
    assert by_f[25]["harmonic"] is True and by_f[25]["kurtosis"] < 2.0
    # Text mode tags the harmonic.
    assert main(["fdd", *paths, "--window", "1024", "--harmonics"]) == 0
    txt = capsys.readouterr().out
    assert "HARMONIC" in txt and "kurt=" in txt


def test_gateway_harmonic_check_tags_report(tmp_path):
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service

    fs = 125.0
    x = _mode_plus_harmonic(fs=fs, t_sec=60.0, f_mode=9.3, f_harm=22.17)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 1024,
                       "fdd_min_sensors": 2, "harmonic_check": True},
    )
    macs = ["0013a20041e7f901", "0013a20041e7f902"]
    for mac, rec in zip(macs, x):
        SensorSimulator(mac, fs=fs, axis="X",
                        chunk=100).stream_acquisition(transport, rec)
    SensorSimulator(macs[0]).heartbeat(transport)
    svc.drain()
    history = open(svc.config.logger_file).read()
    fdd_lines = [ln for ln in history.splitlines() if "[FDD]   f=" in ln]
    assert fdd_lines, history
    harm = [ln for ln in fdd_lines if "HARMONIC" in ln]
    clean = [ln for ln in fdd_lines if "HARMONIC" not in ln]
    assert any("f=22." in ln for ln in harm), fdd_lines
    assert any("f=9." in ln and "kurt=" in ln for ln in clean), fdd_lines


def test_mode_track_damping_estimate_aggregates():
    """damping_estimate: mean/sem over valid observations (the 1/sqrt(n)
    aggregation that reaches 2-3% damping precision - DESIGN.md
    "Damping fidelity study"); NaN/zero draws excluded."""
    from apda_fft_tpu.models.modal import ModeTrack

    tr = ModeTrack(0, 0, 3.1, np.ones(4), damping=1.0)
    rng = np.random.default_rng(0)
    draws = 1.0 + 0.15 * rng.standard_normal(24)
    for t, d in enumerate(draws, start=1):
        tr.observe(t, 3.1, np.ones(4), float(d))
    tr.observe(99, 3.1, np.ones(4), float("nan"))
    tr.observe(100, 3.1, np.ones(4), 0.0)

    mean, sem, n = tr.damping_estimate()
    assert n == 25  # birth + 24 draws; nan and 0 excluded
    expect = np.concatenate([[1.0], draws])
    assert mean == pytest.approx(expect.mean(), rel=1e-12)
    assert sem == pytest.approx(expect.std(ddof=1) / np.sqrt(25), rel=1e-12)
    # windowed form
    mean5, sem5, n5 = tr.damping_estimate(k=5)
    assert n5 == 5 and mean5 == pytest.approx(draws[-5:].mean(), rel=1e-12)
    # degenerate cases
    empty = ModeTrack(1, 0, 3.1, np.ones(4), damping=float("nan"))
    m, s, n0 = empty.damping_estimate()
    assert n0 == 0 and np.isnan(m)
    one = ModeTrack(2, 0, 3.1, np.ones(4), damping=2.0)
    m1, s1, n1 = one.damping_estimate()
    assert (m1, s1, n1) == (2.0, 0.0, 1)


def test_fdd_drops_short_record_instead_of_whole_group(tmp_path):
    """Per-consumer group alignment: ONE short (faulted/decimated) record
    must not drag the common length below 2*window and kill the whole
    array's FDD report - it is dropped from the decomposition roster and
    the remaining sensors decompose (at 256-sensor scale the old behavior
    produced ZERO decompositions)."""
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from tests.test_gateway import make_service
    from tests.signals import modal_signal

    fs = 125.0
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"fdd_report": True, "fdd_window": 256,
                       "fdd_min_sensors": 2},
    )
    macs = [f"0013a20041e7f6e{i}" for i in range(3)]
    lengths = (1024, 1024, 300)  # the 300-sample record is FDD-incapable
    for mac, n in zip(macs, lengths):
        SensorSimulator(mac, fs=fs, axis="X", chunk=100).stream_acquisition(
            transport, modal_signal(n, fs, seed=3).astype(np.float32))
    SensorSimulator(macs[0]).heartbeat(transport)
    svc.drain()
    history = open(svc.config.logger_file).read()
    assert "dropped from the decomposition roster" in history
    # The decomposition ran with the two capable sensors.
    assert "[FDD] X: 2 sensors" in history
    assert "skipping" not in history
