"""Smoke run of the main path on an NVIDIA GPU, checked against the plain reference.

Usage, from the repository root:

    python chip_smoke.py              # every phase below, on one GPU
    python chip_smoke.py --multichip  # only the sharded paths, on 4 GPUs

Phases (each prints its own lines; the last line of a passing run is the
JSON result ``{"ok": true, "device": {"platform", "kind", "count"}}``).
"Decisions" are the peak count and every peak index, which must be
bit-identical to ``tests/oracle.py`` (the float64 clean-room restatement of
the reference detectors).  Spectra are checked at ``precision="highest"``
against float64 ``numpy.fft`` (normwise error <= 1e-6 per window).

  gpu_tests  ``pytest -m gpu tests/test_gpu.py`` in a child process, run
             before this process touches JAX (one JAX process per card)
  gateway    GatewayService + LoopbackTransport + SensorSimulator as
             ``python -m apda_fft_tpu.gateway --simulate`` builds them:
             64 sensors, N=4096 at 500 Hz, a warm-up and 3 timed sync
             epochs, memory feed, flexible and rigid; every stored
             decision vs the oracle
  epoch      analyze_epoch at B=2048/N=4096 on the clean and the noisy
             batch of bench.py, both modes: decisions on a 256-window
             subset, spectrum error; windows/s for backend matmul and xla
  configs    the five BASELINE shapes (benchmarks/run_all.py) through
             analyze_epoch: decisions on every window of cfg1-3 and 64 of
             cfg4/cfg5, spectrum error at N=1024/4096/8192/65536 on both
             backends, B=1 latency of cfg1 and cfg2
  modal      fdd on an 8-channel 65,536-sample synthetic modal record vs
             host numpy.linalg.eigh of the CSD; ssi on the same record vs
             ssi on float64 host correlation blocks
  multichip  (--multichip only) data mesh at B=2048/N=4096, data x seq
             mesh with the distributed FFT, sharded Welch, the FDD mesh
             and seq-sharded SSI correlations at T=65536, each vs the
             single-device result

Times are medians of ``block_until_ready`` wall times after warm-up and
are printed with the card's name and power limit.  They are findings, not
claims.  The script exits non-zero, printing no result, when no GPU is
found (it never falls back to the CPU), when the native codec did not
load, or when any phase fails.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

_ROOT = os.path.dirname(os.path.abspath(__file__))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

from apda_fft_tpu.utils import benchtime  # noqa: E402

#: Spectrum contract: normwise relative error vs float64 numpy.fft.
SPECTRUM_TOL = 1e-6
MULTICHIP_DEVICES = 4


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size a phase uses; FULL is what runs on the card."""

    gw_sensors: int = 64
    gw_n: int = 4096
    gw_epochs: int = 3
    epoch_b: int = 2048
    epoch_n: int = 4096
    epoch_subset: int = 256
    reps: int = 10
    # (name, mode, channels, windows per channel, n, refine, oracle windows)
    configs: tuple = (
        ("cfg1", "rigid", 1, 1, 1024, False, None),
        ("cfg2", "flexible", 1, 1, 4096, True, None),
        ("cfg3", "flexible", 8, 1, 4096, False, None),
        ("cfg4", "flexible", 64, 16, 8192, False, 64),
        ("cfg5", "flexible", 64, 1, 65536, True, 64),
    )
    spectrum_ns: tuple = (1024, 4096, 8192, 65536)
    modal_channels: int = 8
    modal_len: int = 65536
    modal_fs: float = 128.0
    modal_window: int = 2048
    ssi_rows: int = 48
    mc_batch: int = 2048
    mc_fdd_len: int = 65536
    mc_ssi_len: int = 65536


FULL = Sizes()


class PhaseFailure(AssertionError):
    """A phase's output disagreed with its reference."""


def check(cond: bool, message: str) -> None:
    if not cond:
        raise PhaseFailure(message)


# ---------------------------------------------------------------------------
# Shared checks
# ---------------------------------------------------------------------------


def oracle_decisions(x, fs: float, mode: str) -> list[int]:
    from tests.oracle import oracle_analyze

    return [p["idx"] for p in oracle_analyze(np.asarray(x), float(fs), mode=mode)]


def oracle_rows(windows, fs: float, mode: str, rows) -> dict[int, list[int]]:
    flat = np.asarray(windows).reshape(-1, np.shape(windows)[-1])
    return {int(r): oracle_decisions(flat[r], fs, mode) for r in rows}


def check_rows(tag: str, res, want: dict[int, list[int]]) -> int:
    """Decisions of the ``res`` rows in ``want`` vs the oracle's."""
    count = np.asarray(res.count).reshape(-1)
    idx = np.asarray(res.idx).reshape(count.shape[0], -1)
    for r, w in want.items():
        got = [int(i) for i in idx[r, : int(count[r])]]
        check(got == w, f"{tag} row {r}: decisions {got} != oracle {w}")
    return len(want)


def spectrum_error(x: np.ndarray, backend: str, precision: str = "highest") -> float:
    """Worst per-window normwise error of the device half-spectrum
    magnitudes vs float64 numpy.fft on host-centered windows."""
    import jax.numpy as jnp

    from apda_fft_tpu.ops.fft import halfspec_magnitudes

    c32 = (x - np.median(x, axis=-1, keepdims=True)).astype(np.float32)
    n = x.shape[-1]
    want = np.abs(np.fft.fft(c32.astype(np.float64), axis=-1))[:, : n // 2]
    want[:, 0] = 0.0
    got = np.asarray(
        halfspec_magnitudes(jnp.asarray(c32), backend=backend, precision=precision),
        np.float64,
    )
    err = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    return float(err.max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_gateway(sizes: Sizes, card: str) -> None:
    """Packets in -> decisions stored, through the gateway's own objects."""
    from apda_fft_tpu.gateway.__main__ import simulation_service
    from apda_fft_tpu.gateway.transport import SensorSimulator
    from apda_fft_tpu.io import native
    from apda_fft_tpu.io.logfile import load_sensor_log
    from apda_fft_tpu.ops.fft import next_pow2

    check(native.available(), "native codec did not load (NumPy fallback would hide it)")
    fs, n = 500.0, sizes.gw_n
    t = np.arange(n) / fs
    for flexible in (True, False):
        mode = "flexible" if flexible else "rigid"
        with tempfile.TemporaryDirectory(prefix="apda_smoke_gw_") as work:
            svc, transport = simulation_service(work, flexible=flexible)
            sims = [
                SensorSimulator(f"0013a20041e7{i:04x}", fs=fs, axis="X",
                                chunk=120, seed=i)
                for i in range(sizes.gw_sensors)
            ]
            # Closes each epoch batch: a sync from an address that streams
            # nothing, so every sensor's stored decisions survive to the
            # snapshot (a sensor's own sync pops its entry).
            closer = SensorSimulator("0013a20041e7ffff")
            walls = []
            for epoch in range(1 + sizes.gw_epochs):
                rng = np.random.default_rng(1000 + epoch)
                for i, sim in enumerate(sims):
                    f1 = 6.0 + (200.0 * i) / sizes.gw_sensors + 0.37 * epoch
                    x = (np.sin(2 * np.pi * f1 * t)
                         + 0.6 * np.sin(2 * np.pi * (0.8 * f1 + 30.0) * t)
                         + 0.05 * rng.standard_normal(n))
                    sim.stream_acquisition(transport, x)
                t0 = time.perf_counter()
                svc.drain()
                t1 = time.perf_counter()
                # Untimed: what the gateway is about to analyze, re-parsed
                # from its log files (bit-identical to the memory feed).
                records = {addr: load_sensor_log(path)
                           for addr, path in svc.pending_analysis}
                t2 = time.perf_counter()
                closer.heartbeat(transport)
                svc.drain()
                walls.append((t1 - t0) + (time.perf_counter() - t2))
                stored = copy.deepcopy(svc.fft_results)
                for sim in sims:
                    sim.heartbeat(transport)
                svc.drain()
                check(len(stored) == sizes.gw_sensors,
                      f"{mode} epoch {epoch}: {len(stored)} records stored, "
                      f"want {sizes.gw_sensors}")
                check(sorted(records) == sorted(stored),
                      f"{mode} epoch {epoch}: analyzed and stored sensors differ")
                for mac, by_axis in stored.items():
                    entry, rec = by_axis["X"], records[mac]
                    n_fft = next_pow2(len(rec.samples))
                    want = [round(i * rec.fs / n_fft, 4) if flexible
                            else i * (rec.fs / n_fft)
                            for i in oracle_decisions(rec.samples, rec.fs, mode)]
                    got = [entry[k] for k in sorted(
                        (k for k in entry if k.startswith("peak_freq_")),
                        key=lambda k: int(k.rsplit("_", 1)[1]))]
                    check(got == want, f"{mode} epoch {epoch} {mac}: stored peaks "
                                       f"{got} != oracle {want}")
            svc.stop()
        steady = walls[1:]
        print(f"gateway[{mode}]: {sizes.gw_sensors} sensors x N={n}, "
              f"{sizes.gw_epochs} epochs: every stored decision == oracle; "
              f"packets in -> decisions stored {1e3 * float(np.median(steady)):.1f} ms "
              f"per epoch (median; warm-up epoch {1e3 * walls[0]:.1f} ms) [{card}]")


def phase_epoch(sizes: Sizes, card: str) -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from apda_fft_tpu.models.pipeline import analyze_epoch
    from apda_fft_tpu.ops.fft import halfspec_magnitudes
    from apda_fft_tpu.utils.benchtime import median_seconds

    b, n, fs = sizes.epoch_b, sizes.epoch_n, bench.FS
    rows = range(min(sizes.epoch_subset, b))
    batches = {
        "clean": bench._make_batch(b)[:, :n],
        "noisy": bench._make_noisy_batch(b)[:, :n],
    }
    for name, x in batches.items():
        xd = jnp.asarray(x)
        for mode in ("flexible", "rigid"):
            want = oracle_rows(x, fs, mode, rows)
            for backend in ("matmul", "xla"):
                res = analyze_epoch(xd, fs, n_fft=n, mode=mode, backend=backend,
                                    precision="highest")
                check_rows(f"epoch {name}/{mode}/{backend}", res, want)
        for backend in ("matmul", "xla"):
            err = spectrum_error(x[: len(rows)], backend)
            check(err <= SPECTRUM_TOL,
                  f"epoch {name}/{backend}: spectrum error {err:.3e} > {SPECTRUM_TOL}")
            print(f"epoch {name}: {len(rows)} windows x 2 modes == oracle on "
                  f"{backend}; spectrum error {err:.3e} at precision=highest")
    fast = spectrum_error(batches["noisy"][: len(rows)], "matmul", "fast")
    print(f"epoch: precision='fast' (TF32 matmuls) spectrum error {fast:.3e} "
          f"at N={n} (finding; outside the 1e-6 contract) [{card}]")

    for name, x in batches.items():
        xd = jnp.asarray(x)
        for backend in ("matmul", "xla"):
            sec = median_seconds(
                lambda: analyze_epoch(xd, fs, n_fft=n, mode="flexible",
                                      backend=backend),
                reps=sizes.reps)
            print(f"epoch {name} flexible B={b} N={n} [{backend}]: "
                  f"{b / sec:,.0f} windows/s ({1e3 * sec:.3f} ms/epoch, median "
                  f"of {sizes.reps}) [{card}]")
        if name == "noisy":
            for backend in ("matmul", "xla"):
                # The epoch's own front end for full windows: mean removal
                # (center="auto") and |FFT|, as one program.
                front_end = jax.jit(lambda v, backend=backend: halfspec_magnitudes(
                    v - jnp.mean(v, axis=-1, keepdims=True), backend=backend))
                front = median_seconds(front_end, xd, reps=sizes.reps)
                print(f"epoch noisy front end only (mean removal + |FFT|) "
                      f"[{backend}]: {1e3 * front:.3f} ms; the rest of the epoch is "
                      f"the detector and its budget readback [{card}]")


def phase_configs(sizes: Sizes, card: str) -> None:
    import jax.numpy as jnp

    from apda_fft_tpu.models.pipeline import analyze_epoch
    from apda_fft_tpu.models.streaming import frame_records
    from apda_fft_tpu.utils.benchtime import median_seconds
    from tests.signals import modal_signal

    fs = 500.0
    for name, mode, ch, wn, n, refine, n_check in sizes.configs:
        windows = np.stack([modal_signal(n, fs, seed=1000 * ch + w)
                            for w in range(ch * wn)]).astype(np.float32)
        x = windows.reshape(ch, wn * n)  # each channel's record, framed below
        xd = jnp.asarray(x)

        def call(xd=xd, n=n, mode=mode, refine=refine, wn=wn):
            s = frame_records(xd, n, n) if wn > 1 else xd
            return analyze_epoch(s, fs, n_fft=n, mode=mode, refine=refine)

        res = call()
        total = ch * wn
        rows = range(total) if n_check is None else np.linspace(
            0, total - 1, n_check).astype(int)
        checked = check_rows(name, res, oracle_rows(windows, fs, mode, rows))
        line = (f"{name} {mode} {ch}x{wn} N={n}: {checked}/{total} windows "
                f"== oracle")
        if total == 1:
            sec = median_seconds(call, reps=sizes.reps)
            line += (f"; B=1 latency {1e3 * sec:.3f} ms (median of {sizes.reps}, "
                     f"dynamic-budget readback included) [{card}]")
        print(line)
    rng = np.random.default_rng(7)
    for n in sizes.spectrum_ns:
        x = np.stack([modal_signal(n, fs, seed=int(s)) for s in rng.integers(0, 999, 4)]
                     + [rng.standard_normal(n) for _ in range(4)])
        for backend in ("matmul", "xla"):
            err = spectrum_error(x, backend)
            check(err <= SPECTRUM_TOL,
                  f"spectrum N={n} [{backend}]: error {err:.3e} > {SPECTRUM_TOL}")
            print(f"spectrum N={n} [{backend}]: normwise error {err:.3e} "
                  f"at precision=highest")


def phase_modal(sizes: Sizes, card: str) -> None:
    from apda_fft_tpu.models.modal import csd_matrix, fdd
    from apda_fft_tpu.models.ssi import ssi
    from apda_fft_tpu.utils.benchtime import median_seconds
    from apda_fft_tpu.utils.synthetic import modal_records

    s, fs, window = sizes.modal_channels, sizes.modal_fs, sizes.modal_window
    rng = np.random.default_rng(11)
    freqs = np.array([0.09, 0.21, 0.34]) * fs / 2
    shapes = rng.standard_normal((3, s))
    # Unit shapes scaled by (f/f0)^1.5: a white-noise-driven SDOF's response
    # falls as f^-1.5, so this keeps all three modes above the detector's
    # mean + 2 std threshold.
    shapes *= ((freqs / freqs[0]) ** 1.5 / np.linalg.norm(shapes, axis=1))[:, None]
    x = modal_records(shapes, freqs, [0.01, 0.015, 0.02], fs,
                      t_sec=sizes.modal_len / fs, seed=3, sensor_noise=0.03)

    res = fdd(x, fs, window)
    _, gr, gi = csd_matrix(x, fs, window)
    g = np.asarray(gr, np.float64) + 1j * np.asarray(gi, np.float64)
    w_e, v_e = np.linalg.eigh(g)
    rel = float(np.max(np.abs(res.sv1.astype(np.float64) - w_e[:, -1]))
                / max(w_e[:, -1].max(), 1e-30))
    check(rel < 2e-3, f"fdd: first singular value off eigh by {rel:.3e}")
    check(int(res.count) >= 3, f"fdd found {int(res.count)} modes, want >= 3")
    macs = []
    for i in range(int(res.count)):
        ve, vp = v_e[int(res.idx[i]), :, -1], res.shapes()[i]
        macs.append(abs(np.vdot(vp, ve)) ** 2
                    / (np.vdot(vp, vp).real * np.vdot(ve, ve).real))
    check(min(macs) > 0.995, f"fdd shapes vs eigh: MAC {min(macs):.6f} <= 0.995")
    sec = median_seconds(lambda: fdd(x, fs, window).sv1, reps=sizes.reps)
    print(f"modal fdd {s}x{x.shape[1]}: {int(res.count)} modes at "
          f"{np.round(res.freq[: int(res.count)], 3).tolist()} Hz; sv1 vs eigh "
          f"{rel:.2e}, min MAC {min(macs):.6f}; {1e3 * sec:.2f} ms per fdd [{card}]")

    i = sizes.ssi_rows
    got = ssi(x, fs, i=i)
    xc = x.astype(np.float64) - x.astype(np.float64).mean(axis=-1, keepdims=True)
    t0 = xc.shape[1] - 2 * i + 1
    host = np.stack([xc[:, lag:lag + t0] @ xc[:, :t0].T / t0 for lag in range(2 * i)])
    ref = ssi(x, fs, i=i, blocks=host)
    check(got.count == ref.count and got.count >= 3,
          f"ssi: {got.count} modes on the device vs {ref.count} on host blocks")
    df = np.max(np.abs(got.freqs() - ref.freqs()) / ref.freqs())
    dz = np.max(np.abs(got.dampings() - ref.dampings()) / ref.dampings())
    # float32 correlation estimates vs float64 ones: poles move by ~1e-7
    # (frequency) and ~1e-5 (damping) relative on the CPU; the bounds leave
    # two orders of margin, far below the method's own scatter.
    check(df < 5e-4 and dz < 5e-2,
          f"ssi vs host blocks: freq rel {df:.2e}, damping rel {dz:.2e}")
    sec = median_seconds(lambda: ssi(x, fs, i=i).hankel_sv, reps=3)
    print(f"modal ssi i={i}: {got.count} modes at "
          f"{np.round(got.freqs(), 3).tolist()} Hz; vs float64 host blocks "
          f"freq {df:.1e}, damping {dz:.1e} (relative); {1e3 * sec:.1f} ms per ssi "
          f"[{card}]")


def phase_multichip(sizes: Sizes, card: str) -> None:
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__._dryrun_multichip_impl(
        MULTICHIP_DEVICES, batch=sizes.mc_batch, fdd_channels=8,
        fdd_len=sizes.mc_fdd_len, ssi_len=sizes.mc_ssi_len)
    print(f"multichip: all sharded paths == single device on {MULTICHIP_DEVICES} "
          f"devices ({time.perf_counter() - t0:.1f} s incl. compiles) [{card}]")


def phase_gpu_tests(sizes: Sizes, card: str) -> None:
    """The ``gpu``-marked tests, in a child process that is the only JAX
    process holding the card while it runs."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
         "-rs", os.path.join("tests", "test_gpu.py")],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr.strip()[-300:]]
    print(f"gpu tests: {tail[0]} [{card}]")
    check(r.returncode == 0 and "passed" in tail[0] and "skipped" not in tail[0],
          f"gpu tests failed or skipped:\n{r.stdout[-3000:]}\n{r.stderr[-2000:]}")


PHASES = {
    "gpu_tests": phase_gpu_tests,
    "gateway": phase_gateway,
    "epoch": phase_epoch,
    "configs": phase_configs,
    "modal": phase_modal,
    "multichip": phase_multichip,
}
SINGLE_CARD = ("gpu_tests", "gateway", "epoch", "configs", "modal")


def run_phases(names, sizes: Sizes, card: str) -> list[str]:
    """Run each phase, report each; return the names of those that failed."""
    failed = []
    for name in names:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            PHASES[name](sizes, card)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            print(f"== {name} FAILED", flush=True)
        else:
            print(f"== {name} ok ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    return failed


def main(argv=None, sizes: Sizes = FULL) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help=f"run only the sharded paths, on {MULTICHIP_DEVICES} GPUs")
    args = ap.parse_args(argv)

    card = benchtime.nvidia_smi()
    print(f"nvidia-smi name, power.limit: {card}", flush=True)
    if not card:
        print("no NVIDIA GPU found (nvidia-smi); refusing to run on the CPU")
        return 2
    card = " | ".join(card.splitlines())
    names = ["multichip"] if args.multichip else list(SINGLE_CARD)
    want = MULTICHIP_DEVICES if args.multichip else 1

    failed = []
    if "gpu_tests" in names:
        # Before this process initializes JAX: the child holds the card alone.
        failed += run_phases(["gpu_tests"], sizes, card)
        names.remove("gpu_tests")

    import jax

    from apda_fft_tpu.utils.compilecache import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}")
    devices = jax.devices()
    platform = devices[0].platform
    print(f"jax {jax.__version__}: {len(devices)} x {platform} "
          f"({devices[0].device_kind})", flush=True)
    if platform != "gpu" or len(devices) < want:
        print(f"need {want} gpu device(s), found {len(devices)} x {platform}")
        return 2
    failed += run_phases(names, sizes, card)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": want}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
