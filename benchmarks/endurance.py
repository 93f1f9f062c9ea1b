"""Endurance soak: hundreds of faulted epochs + a mid-soak hard restart.

Short fault soaks (<= 12 epochs) cannot show that the gateway holds its
resource ceilings over a long deployment, or that a crash mid-deployment resumes without duplicate uploads or
re-baselining the damage trackers.  This harness runs the full-features
gateway (drift + temperature compensation, FDD + SSI + harmonic check,
mixed-ODR decimation, shock SRS, vibration severity) through >= 200
faulted epochs and asserts:

* bounded RSS (no monotone leak after the compile warm-up),
* zero fd growth,
* bounded compiled-program count (the ``jax.clear_caches`` lesson:
  executables must not accumulate per-epoch),
* the modal/SSI tracker rosters honor the 64-key LRU cap while roster
  churn from faulted traffic creates far more distinct keys,
* a HARD mid-soak restart (the service object is abandoned without
  ``stop()``, a new one starts on the same workdir) resumes: stranded
  files requeue via orphan recovery, drift/modal tracker state reloads
  (same track, same birth frequency - no re-baselining), the alert-dedup
  set survives, and no file is ever uploaded twice.

Reference recovery contract this extends: ``GT_FFT_v5.py:706-739`` and
``:312-355`` (queue retry + cleanup), whose in-memory queues a restart
destroys - files-as-checkpoint is the durability model here.

Usage:
    python benchmarks/endurance.py [--epochs 200] [--sensors 16] \
        [--out result.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def _compiled_count() -> int:
    """GLOBAL pjit CACHE-ENTRY count (every jitted call signature).

    One entry per (function, shape, static-args, weak-type/sharding
    variant) - an OVERCOUNT of actual XLA executables (measured ~7x at 16
    sensors: 1470 entries over ~205 distinct compiles), kept as a
    secondary observable.  The primary, RSS-relevant quantity is the
    distinct-compile count from :class:`_CompileCounter`.
    """
    try:
        import jax._src.pjit as pj

        return int(pj._get_cpp_global_cache(True).size()
                   + pj._get_cpp_global_cache(False).size())
    except Exception:  # noqa: BLE001 - API drift must not kill the soak
        return -1


class _CompileCounter(logging.Handler):
    """Counts DISTINCT XLA compiles via the public ``jax_log_compiles``
    flag: every backend compile logs one "Compiling <name> with global
    shapes and types (...)" line on the pxla logger; the set of those
    signatures IS the executable population whose native compile arenas
    dominate long-run RSS.  No private API - if jax moves
    the logger/message, the counter stays empty and the gate reports probe
    drift instead of misdiagnosing a leak."""

    #: family extraction: the leading jitted-callable name
    _NAME = re.compile(r"^Compiling jit\(([A-Za-z_0-9]+)\)")

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.signatures: set[str] = set()

    def emit(self, record: logging.LogRecord) -> None:  # noqa: D102
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 - never break the soak from a handler
            return
        if msg.startswith("Compiling "):
            self.signatures.add(msg.split(". Argument mapping", 1)[0])

    def by_family(self) -> dict[str, int]:
        fams: dict[str, int] = {}
        for sig in self.signatures:
            m = self._NAME.match(sig)
            fams[_family_of(m.group(1) if m else "?")] = (
                fams.get(_family_of(m.group(1) if m else "?"), 0) + 1)
        return fams


#: jitted-callable name -> closed-form family (everything else: micro_ops)
_FAMILY_MAP = {
    "_analyze_epoch_impl": "epoch_detector",
    "_severity_impl": "severity",
    "_csd_impl": "fdd_csd",
    "sv_spectra": "fdd_svd",
    "_correlation_impl": "ssi_correlation",
    "_band_kurtosis_impl": "harmonic_kurtosis",
    "_srs_impl": "shock_misc",
    "_ringdown_impl": "shock_misc",
    "_integrate_impl": "shock_misc",
    "_decimate_impl": "shock_misc",
}


def _family_of(name: str) -> str:
    return _FAMILY_MAP.get(name, "micro_ops")


def compiled_bound(n_sensors: int, max_record: int = 2048) -> dict:
    """Closed-form ceiling on the distinct-compiled-program space, computed
    from the ACTUAL quantization grids in the code:

    * record lengths pad to pow2 ``n_fft`` <= next_pow2(max_record)
      (``models/batching.py``), batch rows pad to pow2 <= next_pow2(S)
      (``batch_pad="pow2"``), and the dynamic candidate budget walks the
      pow2 grid [2, n_fft/2] (``models/pipeline.py:_run_dynamic``; the
      two-tier split needs >= 128 windows, unreachable at gateway batch
      sizes, so it contributes nothing);
    * severity groups by (EXACT group size <= S) x (256-grid length)
      (``service.py:_vibration_severity``);
    * modal groups by (roster SIZE 2..S) x (256-grid common length)
      (``service.py:_fdd_flush``), one program each for the CSD, the
      per-bin SVD, the SSI correlation stage, and (x2 pow2 windows) the
      narrowband-kurtosis harmonic check;
    * shock SRS / ring-down / integration / decimation: small fixed sets;
    * eager jnp micro-ops (convert/compare/reduce/...): <= ~64 distinct
      ops, each keyed by a handful of shapes drawn from the same finite
      grids (measured 130 signatures over 25 ops at S=16).

    The per-family terms are deliberately LOOSE upper products (every grid
    point, though traffic discovers only a fraction); what matters is that
    each is finite and computed from code constants, so a gate breach
    means a NEW signature source (a true leak), not grid exhaustion.
    """
    s = max(int(n_sensors), 1)
    p2 = 1
    while p2 < s:
        p2 *= 2
    rows = p2.bit_length()          # pow2 batch rows {1, 2, ..., next_pow2(S)}
    np2 = 1
    while np2 < max_record:
        np2 *= 2
    n_ffts = [2 ** i for i in range(2, np2.bit_length())]  # {4, ..., np2}
    t_grid = max(max_record // 256, 1)  # 256-grid lengths
    fams = {
        "epoch_detector": sum(
            rows * max(n.bit_length() - 2, 1) for n in n_ffts),
        # severity rows pad to pow2 (service.py:_vibration_severity)
        "severity": rows * t_grid,
        "fdd_csd": max(s - 1, 1) * t_grid,
        "fdd_svd": max(s - 1, 1) * t_grid,
        "ssi_correlation": max(s - 1, 1) * t_grid,
        "harmonic_kurtosis": max(s - 1, 1) * t_grid * 2,
        "shock_misc": 32,
        "micro_ops": 64 * 6,
    }
    fams["total"] = sum(fams.values())
    return fams


class _TickingClock:
    """Deterministic 1 s-per-reading clock (shared across restarts).

    Wall-clock file naming is second-granular; a fast simulated epoch can
    land two acquisitions from one sensor in the same real second, colliding
    their filenames (observed as flaky duplicate-upload counts).  Real
    deployments send minutes apart; the harness pins determinism instead.
    """

    def __init__(self):
        import datetime

        self._t = datetime.datetime(2026, 8, 19, 8, 0, 0)

    def __call__(self):
        import datetime

        self._t += datetime.timedelta(seconds=1)
        return self._t


def _make_service(cfg_path, data_dir, uploads, clock, async_uploads=False):
    from apda_fft_tpu.gateway.config import GatewayConfig
    from apda_fft_tpu.gateway.egress import FtpSink, HttpSink
    from apda_fft_tpu.gateway.service import GatewayService
    from apda_fft_tpu.gateway.transport import LoopbackTransport

    class RecordingFtp(FtpSink):
        def upload(self, addr, files, log):
            uploads.extend(files)  # GIL-atomic append; worker-thread safe
            return list(files)

    class RecordingHttp(HttpSink):
        def upload(self, addr, files, local_dir, fft_result, log):
            return list(files)

    config = GatewayConfig.load(cfg_path)
    transport = LoopbackTransport()
    svc = GatewayService(
        config, transport, flush_mode="on_sync", clock=clock,
        ftp_sink=RecordingFtp(config.ftp, data_dir),
        http_sink=RecordingHttp(""),
        async_uploads=async_uploads,
    )
    svc.start()
    return svc, transport


def run_endurance(
    n_sensors: int = 16,
    epochs: int = 200,
    seed: int = 0,
    workdir: str | None = None,
    restart_epoch: int | None = None,
    sample_every: int = 10,
    async_uploads: bool = False,
) -> dict:
    from apda_fft_tpu.gateway.transport import SensorSimulator

    # Exact compile counting (public flag + log hook, see _CompileCounter).
    import jax

    counter = _CompileCounter()
    logging.getLogger("jax._src.interpreters.pxla").addHandler(counter)
    prev_log_compiles = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", True)

    rng = np.random.default_rng(seed)
    workdir = workdir or tempfile.mkdtemp(prefix="apda_endurance_")
    data_dir = os.path.join(workdir, "SHM_Data") + os.sep
    os.makedirs(data_dir, exist_ok=True)
    cfg_path = os.path.join(workdir, "gw.json")
    with open(cfg_path, "w") as fh:
        json.dump({"gateway": {
            "logger_file": data_dir + "history.log",
            "device_file": data_dir + "devices.txt",
            "config_file": os.path.join(workdir, "config.txt"),
            "data_dir": data_dir,
            "is_flexibile_structure": True,
            "analysis": "epoch",
            "analyze_shock": True,
            "drift_alert_rel": 0.02,
            "drift_temp_compensate": True,
            "fdd_report": True,
            "fdd_window": 256,
            "fdd_min_sensors": 2,
            "ssi_report": True,
            "ssi_block_rows": 12,
            "ssi_damping_alert": 0.8,
            "harmonic_check": True,
            "modal_decimate": True,
            "shock_srs": True,
            "vibration_severity": True,
            "severity_band_hz": [5.0, 100.0],
            "severity_alert_mms": 50.0,
        }}, fh)
    open(os.path.join(workdir, "config.txt"), "w").close()

    restart_epoch = epochs // 2 if restart_epoch is None else restart_epoch
    uploads: list[str] = []
    pre_upload_set: set[str] = set()  # uploads completed before the restart
    clock = _TickingClock()
    svc, transport = _make_service(cfg_path, data_dir, uploads, clock,
                                   async_uploads=async_uploads)

    macs = [f"0013a20041e7{i:04x}" for i in range(n_sensors)]
    counts = {"clean": 0, "dropped": 0, "truncated": 0, "shock": 0,
              "reduced": 0, "skipped": 0}
    samples: list[dict] = []
    roster_max = {"modal": 0, "ssi": 0, "drift": 0}
    restart_report: dict = {}
    evictions_before_restart = 0
    t0 = time.perf_counter()

    def epoch_traffic(epoch: int) -> None:
        for i, mac in enumerate(macs):
            # Faulted traffic mix + per-epoch delivery churn: ~15% of
            # sensors skip each epoch, so the FDD/SSI roster (the set of
            # sensors that delivered together) varies - the churn that
            # must exercise, and stay inside, the 64-key tracker LRU.
            if rng.random() < 0.15:
                counts["skipped"] += 1
                continue
            axis = "XYZ"[i % 3]
            fs_i = 125.0 if i % 2 else 250.0
            temp_i = 20.0 + 8.0 * np.sin(2 * np.pi * epoch / 50.0) \
                + float(rng.normal(0, 0.5))
            sim = SensorSimulator(mac, fs=fs_i, axis=axis, chunk=200,
                                  seed=seed * 7919 + epoch * 131 + i,
                                  temperature=temp_i)
            n = int(rng.choice([1000, 2048]))
            t = np.arange(n) / fs_i
            x = (np.sin(2 * np.pi * 12.3 * t)
                 + 0.5 * np.sin(2 * np.pi * (47.7 if fs_i > 200 else 31.4) * t)
                 + 0.3 * rng.standard_normal(n))
            total_pkts = 1 + max(1, -(-(n - 200) // 200))
            kind = rng.random()
            if kind < 0.72:
                sim.stream_acquisition(transport, x)
                counts["clean"] += 1
            elif kind < 0.82 and total_pkts >= 4:
                sim.stream_acquisition(
                    transport, x, drop_packets={int(rng.integers(2, total_pkts))})
                counts["dropped"] += 1
            elif kind < 0.90 and total_pkts >= 4:
                sim.stream_acquisition(
                    transport, x, truncate_after=int(rng.integers(2, total_pkts)))
                counts["truncated"] += 1
            elif kind < 0.96:
                td = np.arange(256) / 250.0
                sim.shock_event(
                    transport, np.exp(-2.0 * td) * np.sin(2 * np.pi * 20.0 * td))
                counts["shock"] += 1
            else:
                sim.reduced_data(transport, x[:500])
                counts["reduced"] += 1
        svc.drain()

    def epoch_sync() -> None:
        for mac in macs:
            SensorSimulator(mac).heartbeat(transport)
        svc.drain()

    for epoch in range(epochs):
        epoch_traffic(epoch)
        if epoch == restart_epoch:
            # HARD restart BETWEEN traffic and the sync flush: every file
            # of this epoch is on disk but unuploaded (the queues holding
            # them are in-memory and about to be destroyed) - the exact
            # state the reference's restart loses files in.  Snapshot the
            # damage baselines first to prove the new process resumes them.
            pre_alerted = set(svc._alerted)
            pre_tracks = {}
            for key, tr in list(svc.trackers.items())[:4]:
                live = tr.tracks()
                if live:
                    best = max(live, key=lambda t: len(t.freqs))
                    pre_tracks[key] = (best.freqs[0], len(best.freqs))
            pre_uploads = len(uploads)
            pre_upload_set = set(uploads)
            evictions_before_restart = svc.tracker_evictions
            del svc, transport
            svc, transport = _make_service(cfg_path, data_dir, uploads, clock,
                                           async_uploads=async_uploads)
            resumed, rebaselined = 0, 0
            for key, (f0, ln) in pre_tracks.items():
                tr = svc.trackers.get(key)
                match = tr is not None and any(
                    t.freqs and abs(t.freqs[0] - f0) < 1e-9 and len(t.freqs) >= ln
                    for t in tr.tracks()
                )
                resumed += int(match)
                rebaselined += int(not match)
            restart_report = {
                "epoch": epoch,
                "alerted_preserved": pre_alerted <= set(svc._alerted),
                "tracks_sampled": len(pre_tracks),
                "tracks_resumed": resumed,
                "tracks_rebaselined": rebaselined,
                "uploads_before": pre_uploads,
                "orphans_requeued": "[RECOVERY]" in open(
                    svc.config.logger_file).read(),
            }
            print(f"# restart: {json.dumps(restart_report)}",
                  file=sys.stderr, flush=True)
        epoch_sync()
        roster_max["modal"] = max(roster_max["modal"], len(svc._modal_trackers))
        roster_max["ssi"] = max(roster_max["ssi"], len(svc._ssi_trackers))
        roster_max["drift"] = max(roster_max["drift"], len(svc.trackers))
        if epoch % sample_every == 0 or epoch == epochs - 1:
            samples.append({
                "epoch": epoch,
                "rss_mb": round(_rss_mb(), 1),
                "fds": _fd_count(),
                "compiled": _compiled_count(),
                "programs": len(counter.signatures),
            })
            print(f"# epoch {epoch}: {json.dumps(samples[-1])}",
                  file=sys.stderr, flush=True)

    # Drain: every sensor syncs until queues empty (sinks always succeed).
    for _ in range(4):
        for mac in macs:
            SensorSimulator(mac).heartbeat(transport)
        svc.drain()
        if not any(svc.ftp_queue.get(m) or svc.api_queue.get(m) for m in macs):
            break
    svc.stop()

    wall = time.perf_counter() - t0
    history = open(svc.config.logger_file).read()
    old = svc.config.logger_file + ".old"
    if os.path.exists(old):
        history = open(old).read() + history

    from collections import Counter

    dupe_all = sorted(n for n, c in Counter(uploads).items() if c > 1)
    # Fast-path files (shock/reduced) upload immediately but are cleaned
    # only at their sensor's next sync; a crash inside that window makes
    # orphan recovery re-deliver them.  That is at-least-once delivery BY
    # DESIGN (losing the file would be worse; FTP STOR on the same name is
    # server-side idempotent) - classified separately from hard duplicates,
    # which the gate forbids outright.
    redelivered = [n for n in dupe_all if n in pre_upload_set]
    hard_dupes = [n for n in dupe_all if n not in pre_upload_set]
    dupes = len(hard_dupes)
    dupe_names = hard_dupes[:10]
    still_open = {os.path.basename(p) for p in svc.open_file.values()}
    stranded = [f for f in os.listdir(data_dir) if f.endswith(".log")
                and not f.startswith("history") and f not in still_open]
    # RSS ceilings.  Measured (tracemalloc diff + warm-run samples): RSS
    # growth tracks NEW COMPILES (native compile arenas + retained jaxpr
    # metadata, ~MBs per executable); compile-stable windows are near
    # flat.  So the leak gate is the average RSS slope across
    # compile-stable sample pairs (a true per-epoch leak shows up there),
    # plus an absolute ceiling on post-warm-up growth and on the global
    # executable count itself.
    quarter = samples[max(1, len(samples) // 4)]
    rss_growth = samples[-1]["rss_mb"] - quarter["rss_mb"]
    compiled_max = max(s["compiled"] for s in samples)
    fd_growth = samples[-1]["fds"] - samples[0]["fds"]
    stable = [(a, b) for a, b in zip(samples, samples[1:])
              if a["compiled"] == b["compiled"] and b["epoch"] > a["epoch"]]
    if stable:
        stable_rate = (sum(b["rss_mb"] - a["rss_mb"] for a, b in stable)
                       / sum(b["epoch"] - a["epoch"] for a, b in stable))
    else:
        stable_rate = 0.0
    # Compile saturation: the compiled-program space is FINITE with a
    # CLOSED-FORM ceiling computed from the code's own quantization grids
    # (compiled_bound above) - discovered gradually by the random traffic.
    # A leak would show a flat-or-rising discovery rate AND breach the
    # per-family bounds; saturation shows the rate -> 0 under the bound.
    def _rate(key: str, frac_lo: float, frac_hi: float) -> float:
        lo = samples[int((len(samples) - 1) * frac_lo)]
        hi = samples[int((len(samples) - 1) * frac_hi)]
        d = max(hi["epoch"] - lo["epoch"], 1)
        return (hi[key] - lo[key]) / d

    compile_rate_early = _rate("compiled", 0.0, 0.25)
    compile_rate_late = _rate("compiled", 0.75, 1.0)
    program_rate_early = _rate("programs", 0.0, 0.25)
    program_rate_late = _rate("programs", 0.75, 1.0)

    jax.config.update("jax_log_compiles", prev_log_compiles)
    logging.getLogger("jax._src.interpreters.pxla").removeHandler(counter)
    bound = compiled_bound(n_sensors)
    fam_counts = counter.by_family()
    fam_ok = {f: fam_counts.get(f, 0) <= b
              for f, b in bound.items() if f != "total"}
    programs_total = len(counter.signatures)

    result = {
        "metric": "gateway_endurance_soak",
        "sensors": n_sensors,
        "epochs": epochs,
        "traffic": counts,
        "wall_s": round(wall, 1),
        "uploads": len(uploads),
        "duplicate_uploads": dupes,
        "duplicate_names": dupe_names,
        "crash_window_redeliveries": len(redelivered),
        "rss_mb_quarter": quarter["rss_mb"],
        "rss_mb_final": samples[-1]["rss_mb"],
        "rss_growth_mb": round(rss_growth, 1),
        "rss_stable_rate_mb_per_epoch": round(stable_rate, 3),
        "fd_growth": fd_growth,
        "compiled_max": compiled_max,
        "compile_rate_early": round(compile_rate_early, 2),
        "compile_rate_late": round(compile_rate_late, 2),
        "programs_total": programs_total,
        "programs_by_family": fam_counts,
        "compiled_bound": bound,
        "family_bounds_ok": fam_ok,
        "program_rate_early": round(program_rate_early, 3),
        "program_rate_late": round(program_rate_late, 3),
        "roster_max": roster_max,
        "tracker_evictions": evictions_before_restart + svc.tracker_evictions,
        "async_uploads": async_uploads,
        "restart": restart_report,
        "critical_lines": history.count("CRITICAL"),
        "loop_errors": history.count("Error in main loop"),
        "stranded_files": len(stranded),
        "severity_lines": history.count("Vibration severity"),
        "srs_lines": history.count("Shock SRS:"),
        "fdd_lines": history.count("[FDD]"),
        "ssi_lines": history.count("[SSI]"),
        "samples": samples,
    }
    probe_errors = []
    if compiled_max < 0:
        # Distinguish probe loss from a real ceiling breach: the count
        # comes from a private jax API (_get_cpp_global_cache); on drift
        # the gate failure must say so, not misdiagnose an executable leak.
        probe_errors.append(
            "cache-entry probe unavailable (jax private API drift)")
    if programs_total == 0:
        probe_errors.append(
            "compile-log probe empty (jax moved the pxla Compiling log?)")
    if probe_errors:
        result["compile_gate_error"] = "; ".join(
            probe_errors) + "; compile gates not evaluated as such"
    # Discovery-rate gates: meaningless on short calibration runs (the
    # early-window rate is computed over too few samples); the bound gates
    # always apply.  At soak scale (>= 400 epochs) the claim is saturation
    # proper: the late distinct-program discovery rate is ~0.
    if epochs >= 400:
        rate_ok = program_rate_late <= 0.1
    elif epochs >= 100:
        rate_ok = program_rate_late <= max(0.34 * program_rate_early, 0.2)
    else:
        rate_ok = True
    result["program_rate_ok"] = rate_ok
    result["ok"] = (
        dupes == 0
        and rss_growth < 350.0
        and stable_rate < 1.0
        and fd_growth <= 4
        and not probe_errors
        and programs_total <= bound["total"]
        and all(fam_ok.values())
        # cache entries overcount executables ~7x (weak-type/sharding
        # variants); secondary ceiling keyed to the closed-form bound
        and 0 <= compiled_max <= 8 * bound["total"]
        and rate_ok
        and roster_max["modal"] <= 64
        and roster_max["ssi"] <= 64
        and result["critical_lines"] == 0
        and result["loop_errors"] == 0
        and result["stranded_files"] == 0
        and bool(restart_report)
        and restart_report["tracks_rebaselined"] == 0
        and restart_report["tracks_resumed"] >= 1
        and restart_report["alerted_preserved"]
        and restart_report["orphans_requeued"]
        and result["severity_lines"] > 0
        and result["fdd_lines"] > 0
        and result["ssi_lines"] > 0
    )
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sensors", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--platform", default="",
                    help="jax platform to pin (e.g. 'cpu'); default: the "
                         "device JAX finds")
    args = ap.parse_args()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from apda_fft_tpu.utils.benchtime import device_info

    result = run_endurance(n_sensors=args.sensors, epochs=args.epochs,
                           seed=args.seed)
    result["device"] = device_info()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "samples"}))
    raise SystemExit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
