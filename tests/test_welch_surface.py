"""Gateway + CLI wiring of the Welch/streaming surface.

The library-level Welch tools (``models/streaming.py``) are covered by
``test_streaming.py``; these tests cover their *reachability*: the gateway's
``analysis: "welch"`` config path (replacing the reference's per-file-only
``work_flow_fft``, ``GT_FFT_v5.py:620-679``) and the ``welch`` /
``spectrogram`` / ``coherence`` CLI subcommands.
"""

import json
import os

import numpy as np
import pytest

from apda_fft_tpu.gateway.transport import SensorSimulator
from apda_fft_tpu.io import logfile
from tests.test_gateway import MAC, make_service


def noisy_tone_signal(n, fs, tones, noise=1.0, seed=7):
    """Broadband noise + weak stationary tones (Welch's home turf)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = noise * rng.standard_normal(n)
    for f, a in tones:
        x += a * np.sin(2 * np.pi * f * t)
    return x


def write_log(path, x, fs=500.0, axis="X"):
    logfile.write_acquisition_header(
        path, "10:20:30", "2g", f"{int(fs)} Hz", f"{axis} axis", "Synced",
        means=["22.0", "0.01", "0.01", "0.98"], humidity=50.0,
        baselines=(0.0, 0.0, 0.0),
    )
    logfile.append_samples(path, [f"{v:8.6f}" for v in x])
    return str(path)


# -- gateway ---------------------------------------------------------------


def test_gateway_welch_analysis_end_to_end(tmp_path):
    """A long noisy acquisition yields Welch-averaged peaks in history.log."""
    fs = 500.0
    # Tone on an exact window-1024 bin (125 * 500/1024), weak against
    # unit-variance noise: invisible to a single 8192-point spectrum's
    # noise floor, clean after averaging 15 overlapping segments.
    tone = 125 * fs / 1024
    x = noisy_tone_signal(8192, fs, [(tone, 0.4)], noise=1.0, seed=7)

    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"analysis": "welch", "welch_window": 1024},
    )
    assert svc.config.analysis == "welch"
    SensorSimulator(MAC, fs=fs, axis="X", chunk=100).stream_acquisition(transport, x)
    svc.drain()

    entry = svc.fft_results[MAC]["X"]
    assert entry["peak_freq"] == pytest.approx(tone, abs=0.3)
    # Peak frequency is reported on the Welch segment grid (n_fft=1024).
    assert entry["peak_freq"] == round(round(entry["peak_freq"] * 1024 / fs) * fs / 1024, 4)

    SensorSimulator(MAC).heartbeat(transport)
    svc.drain()
    history = open(svc.config.logger_file).read()
    assert f"X f1: {entry['peak_freq']:.4f}Hz" in history


def test_gateway_welch_matches_library_decisions(tmp_path):
    """The gateway's Welch path is the library's analyze_welch, decision-exact."""
    from apda_fft_tpu.io.logfile import load_sensor_log
    from apda_fft_tpu.models.streaming import analyze_welch

    fs = 500.0
    x = noisy_tone_signal(4096, fs, [(61.0352, 0.5), (150.1465, 0.45)], seed=3)
    svc, transport, _, _ = make_service(
        tmp_path,
        gateway_extra={"analysis": "welch", "welch_window": 1024,
                       "welch_hop": 512, "welch_taper": "hann"},
    )
    SensorSimulator(MAC, fs=fs, axis="Y", chunk=100).stream_acquisition(transport, x)
    svc.drain()

    files = [f for f in os.listdir(svc.config.data_dir)
             if f.endswith(".log") and f.startswith(MAC)]
    rec = load_sensor_log(os.path.join(svc.config.data_dir, files[0]))
    res = analyze_welch(
        np.asarray(rec.samples, np.float32), fs, window=1024, hop=512,
        taper="hann", mode="flexible",
    )
    entry = svc.fft_results[MAC]["Y"]
    count = int(res.count)
    assert count > 0
    for slot in range(count):
        want = round(int(res.idx[slot]) * fs / 1024, 4)
        assert entry[f"peak_freq_{slot + 1}"] == want


def test_gateway_welch_shock_stays_on_epoch_path(tmp_path):
    """Shock transients bypass Welch averaging (it smears the ring-down)."""
    svc, transport, *_ = make_service(
        tmp_path,
        gateway_extra={"analysis": "welch", "welch_window": 256,
                       "analyze_shock": True},
    )
    t = np.arange(256) / 100.0
    ring_down = (np.exp(-1.5 * t) * np.sin(2 * np.pi * 20.0 * t)).astype(np.float32)
    SensorSimulator(MAC).shock_event(transport, ring_down)
    svc.drain()
    entry = svc.fft_results[MAC]["Unknown_axis"]
    assert entry["peak_freq"] == pytest.approx(20.0, abs=0.5)
    # Epoch path evidence: the free-decay ring-down estimator ran (it is
    # only invoked from the epoch/shock branch).
    assert "ringdown_damping_pct" in entry


def test_gateway_config_welch_validation(tmp_path):
    from apda_fft_tpu.gateway.config import GatewayConfig, GatewayConfigError

    def cfg(extra):
        p = tmp_path / "gw.json"
        p.write_text(json.dumps({
            "gateway": {
                "logger_file": str(tmp_path / "h.log"),
                "device_file": str(tmp_path / "d.txt"),
                "config_file": str(tmp_path / "c.txt"),
                "data_dir": str(tmp_path) + os.sep,
                **extra,
            }
        }))
        return GatewayConfig.load(p)

    c = cfg({"analysis": "welch", "welch_window": 2048, "welch_taper": "none"})
    assert c.analysis == "welch" and c.welch_window == 2048
    assert c.welch_taper == "none" and c.welch_hop == 0
    with pytest.raises(GatewayConfigError, match="analysis"):
        cfg({"analysis": "psd"})
    with pytest.raises(GatewayConfigError, match="welch_window"):
        cfg({"welch_window": 1})
    with pytest.raises(GatewayConfigError, match="welch_hop"):
        cfg({"welch_hop": -4})
    with pytest.raises(GatewayConfigError, match="welch_taper"):
        cfg({"welch_taper": "kaiser"})


# -- batching --------------------------------------------------------------


def test_analyze_records_welch_buckets_by_exact_length():
    from apda_fft_tpu.models.batching import analyze_records_welch

    fs = 500.0
    tone = 125 * fs / 1024
    long = noisy_tone_signal(8192, fs, [(tone, 0.5)], seed=1)
    longer = noisy_tone_signal(12288, fs, [(tone, 0.5)], seed=2)
    calls = []
    out = analyze_records_welch(
        [(long, fs), (longer, fs), (long[:8192], fs)],
        window=1024,
        on_bucket=lambda n, idxs: calls.append((n, tuple(idxs))),
    )
    # Two exact-length buckets (8192 x2, 12288 x1), both padded to n_fft=1024.
    assert calls == [(1024, (0, 2)), (1024, (1,))]
    for rp in out:
        assert rp.n_fft == 1024
        assert rp.count > 0
        assert rp.exact_freq(0, "flexible") == pytest.approx(tone, abs=0.3)


def test_analyze_records_welch_short_record_clamps_window():
    from apda_fft_tpu.models.batching import analyze_records_welch

    fs = 500.0
    short = noisy_tone_signal(512, fs, [(62.5, 2.0)], noise=0.1, seed=4)
    (rp,) = analyze_records_welch([(short, fs)], window=1024)
    # window clamps to the record length: single 512-sample segment.
    assert rp.n_fft == 512
    assert rp.exact_freq(0, "flexible") == pytest.approx(62.5, abs=0.5)


def test_analyze_records_welch_validation():
    from apda_fft_tpu.models.batching import analyze_records_welch

    with pytest.raises(ValueError, match="window"):
        analyze_records_welch([(np.zeros(64), 100.0)], window=1)
    with pytest.raises(ValueError, match="hop"):
        analyze_records_welch([(np.zeros(64), 100.0)], window=32, hop=0)
    with pytest.raises(ValueError, match="fewer than 2"):
        analyze_records_welch([(np.zeros(1), 100.0)], window=32)


# -- CLI -------------------------------------------------------------------


def test_cli_welch_finds_weak_tone(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs = 500.0
    tone = 125 * fs / 1024
    x = noisy_tone_signal(8192, fs, [(tone, 0.4)], noise=1.0, seed=7)
    path = write_log(tmp_path / f"{MAC}_Xaxis_16_08_2026_10_20_30.log", x)

    rc = main(["welch", path, "--window", "1024", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_fft"] == 1024 and out["window"] == 1024
    freqs = [p["freq"] for p in out["peaks"]]
    assert any(abs(f - tone) < 0.3 for f in freqs)

    # Text mode too.
    assert main(["welch", path, "--window", "1024", "--refine"]) == 0
    text = capsys.readouterr().out
    assert "welch window=1024" in text and "refined=" in text


def test_cli_spectrogram(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs = 500.0
    x = noisy_tone_signal(4096, fs, [(62.5, 3.0)], noise=0.05, seed=5)
    path = write_log(tmp_path / f"{MAC}_Xaxis_16_08_2026_10_20_30.log", x)
    npz = str(tmp_path / "sg.npz")

    rc = main(["spectrogram", path, "--window", "512", "--json", "--out", npz])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 8 and out["bins"] == 256
    assert all(abs(f - 62.5) < 1.0 for f in out["dominant_freq"])
    saved = np.load(npz)
    key = [k for k in saved.files if k.endswith("__mags")][0]
    assert saved[key].shape == (8, 256)


def test_cli_coherence_two_sensor_report(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs, n = 500.0, 8192
    t = np.arange(n) / fs
    shared = np.sin(2 * np.pi * 25.024 * t)  # bin 410 at window 1024... shared mode
    rng = np.random.default_rng(11)
    x = shared + 0.8 * rng.standard_normal(n)
    y = 0.7 * shared + 0.8 * rng.standard_normal(n)
    px = write_log(tmp_path / f"{MAC}_Xaxis_16_08_2026_10_20_30.log", x)
    py = write_log(tmp_path / "0013a20041e7f6b8_Xaxis_16_08_2026_10_20_31.log", y)

    rc = main(["coherence", px, py, "--window", "1024", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    hits = [p for p in out["coherent_peaks"] if abs(p["freq"] - 25.024) < 0.5]
    assert hits and hits[0]["coherence"] >= 0.8
    # In-phase shared mode: cross-spectral phase near 0 degrees.
    assert abs(hits[0]["phase_deg"]) < 15.0

    # Text mode.
    assert main(["coherence", px, py, "--window", "1024"]) == 0
    assert "coherence=" in capsys.readouterr().out


def test_cli_coherence_rejects_mismatched_fs(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    x = noisy_tone_signal(2048, 500.0, [(50.0, 1.0)])
    px = write_log(tmp_path / f"{MAC}_Xaxis_16_08_2026_10_20_30.log", x, fs=500.0)
    py = write_log(tmp_path / "0013a20041e7f6b8_Xaxis_16_08_2026_10_20_31.log", x, fs=250.0)
    assert main(["coherence", px, py]) == 1
    assert "sampling rates differ" in capsys.readouterr().err


def test_cli_coherence_rejects_single_segment(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    x = noisy_tone_signal(1500, 500.0, [(50.0, 1.0)])
    px = write_log(tmp_path / f"{MAC}_Xaxis_16_08_2026_10_20_30.log", x)
    py = write_log(tmp_path / "0013a20041e7f6b8_Xaxis_16_08_2026_10_20_31.log", x)
    assert main(["coherence", px, py, "--window", "1024"]) == 1
    assert "2 overlapping segments" in capsys.readouterr().err


def test_welch_records_respect_float64_dtype():
    """A float64 request must not be truncated to f32 on the host (review fix)."""
    from apda_fft_tpu.models.batching import analyze_records_welch

    seen = {}

    def probe(batch, fs, **kwargs):
        seen["dtype"] = batch.dtype
        from apda_fft_tpu.models.streaming import analyze_welch

        return analyze_welch(batch, fs, **kwargs)

    x = noisy_tone_signal(2048, 500.0, [(61.0352, 1.0)])
    analyze_records_welch([(x, 500.0)], window=1024, analyze=probe,
                          dtype=np.float64)
    assert seen["dtype"] == np.float64
    analyze_records_welch([(x, 500.0)], window=1024, analyze=probe)
    assert seen["dtype"] == np.float32


@pytest.mark.parametrize("analysis", ["welch", "epoch"])
def test_gateway_survives_one_sample_record(tmp_path, analysis):
    """A truncated 1-sample file must not abort the analysis batch (review fix).

    A single sample has NO spectrum (next_pow2(1) = 1 -> zero half-spectrum
    bins), so such records are skipped with a [WARN] like corrupt files -
    on BOTH analysis paths (the epoch path crashed on them too, latently).
    """
    svc, transport, _, _ = make_service(
        tmp_path, gateway_extra={"analysis": analysis, "welch_window": 1024},
    )
    tiny = os.path.join(svc.config.data_dir, f"{MAC}_Xaxis_16_08_2026_10_20_30.log")
    write_log(tiny, np.asarray([0.5]), fs=500.0, axis="X")
    good = os.path.join(svc.config.data_dir, f"{MAC}_Yaxis_16_08_2026_10_20_31.log")
    write_log(good, noisy_tone_signal(4096, 500.0, [(61.0352, 0.8)]), fs=500.0, axis="Y")

    svc._analyze_files([(MAC, tiny), (MAC, good)])
    # The healthy record's analysis completed despite the 1-sample neighbor.
    assert "Y" in svc.fft_results[MAC]
    if analysis == "welch":
        assert svc.fft_results[MAC]["Y"]["peak_freq"] == pytest.approx(61.0352, abs=0.3)
    assert "X" not in svc.fft_results.get(MAC, {})
    assert "too short" in open(svc.config.logger_file).read()


def test_cli_psd(tmp_path, capsys):
    from apda_fft_tpu.__main__ import main

    fs = 500.0
    x = noisy_tone_signal(8192, fs, [(61.0352, 1.5)], noise=0.3, seed=9)
    path = write_log(tmp_path / f"{MAC}_Xaxis_16_08_2026_10_20_30.log", x)
    npz = str(tmp_path / "psd.npz")

    rc = main(["psd", path, "--window", "1024", "--json", "--out", npz])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bins"] == 512
    top = {round(b["freq"], 4): b["psd"] for b in out["top_bins"]}
    assert any(abs(f - 61.0352) < 0.5 for f in top)
    saved = np.load(npz)
    key = [k for k in saved.files if k.endswith("__psd")][0]
    psd = saved[key]
    assert psd.shape == (512,)
    # Engineering-units sanity: integrating the PSD recovers ~ the signal
    # variance (tone a^2/2 + noise sigma^2), within taper/leakage tolerance.
    var = np.sum(psd) * (fs / 1024)
    expect = 1.5**2 / 2 + 0.3**2
    assert var == pytest.approx(expect, rel=0.2)

    # Text mode.
    assert main(["psd", path, "--window", "1024"]) == 0
    assert "psd=" in capsys.readouterr().out


def test_cli_track_welch_mode(tmp_path, capsys):
    """Drift tracking over Welch-averaged noisy acquisitions."""
    from apda_fft_tpu.__main__ import main

    fs, n = 500.0, 8192
    t = np.arange(n) / fs
    rng = np.random.default_rng(13)
    paths = []
    for e in range(6):
        f1 = 61.0352 * (1 - 0.012 * e)  # 1.2%/acquisition drift
        x = 0.5 * np.sin(2 * np.pi * f1 * t) + 1.0 * rng.standard_normal(n)
        p = tmp_path / f"{MAC}_Xaxis_1{e}_08_2026_10_20_30.log"
        write_log(p, x)
        paths.append(str(p))
    rc = main(["track", *paths, "--welch", "--window", "1024",
               "--rel-drift", "0.02"])
    out = capsys.readouterr().out
    assert rc == 2 and "ALERT" in out


def test_batch_pad_pow2_bounds_programs_and_is_invisible():
    """Bucket batches pad to pow2 (bounded compile count) without changing
    any returned decision (review of the soak's per-epoch compile storms)."""
    from apda_fft_tpu.models.batching import analyze_records

    fs = 500.0
    recs = [(noisy_tone_signal(1024, fs, [(61.0352, 2.0)], noise=0.2, seed=s), fs)
            for s in range(5)]  # B=5 -> padded to 8
    shapes = []

    def probe(batch, f, **kw):
        shapes.append(batch.shape)
        from apda_fft_tpu.models.pipeline import analyze_epoch

        return analyze_epoch(batch, f, **kw)

    padded = analyze_records(recs, analyze=probe)
    exact = analyze_records(recs, batch_pad=None)
    assert shapes == [(8, 1024)]
    for rp_p, rp_e in zip(padded, exact):
        assert rp_p.count == rp_e.count
        for slot in range(rp_p.count):
            assert rp_p.peak(slot) == rp_e.peak(slot)
