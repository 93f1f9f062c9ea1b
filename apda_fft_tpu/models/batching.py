"""Record batching: ragged host-side records -> bucketed device epochs.

The gateway and the CLI both need the same shape transformation: a list of
variable-length sample records becomes one padded ``[B, n_fft]`` epoch per
power-of-two bucket, analyzed as a single XLA program each, with results
mapped back to the originating records.  This is the host-side face of the
epoch-batch design (SURVEY.md section 7): the reference's per-file
``work_flow_fft`` loop (``GT_FFT_v5.py:620-679``) becomes one program per
bucket regardless of how many sensors/axes completed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import numpy as np

from apda_fft_tpu.models.pipeline import analyze_epoch
from apda_fft_tpu.models.results import EpochResult
from apda_fft_tpu.ops.fft import next_pow2


@dataclasses.dataclass
class RecordPeaks:
    """Per-record view into a bucket's :class:`EpochResult`."""

    n_fft: int
    fs: float
    result: EpochResult  # the bucket result
    row: int  # this record's row within the bucket

    @property
    def count(self) -> int:
        return int(self.result.count[self.row])

    def peak(self, slot: int) -> dict:
        r, i = self.result, self.row
        return {
            "idx": int(r.idx[i, slot]),
            "freq": float(r.freq[i, slot]),
            "mag": float(r.mag[i, slot]),
            "prominence": float(r.prominence[i, slot]),
            "damping": float(r.damping[i, slot]),
            "q_factor": float(r.q_factor[i, slot]),
            "refined_freq": float(r.refined_freq[i, slot]),
        }

    def exact_freq(self, slot: int, mode: str) -> float:
        """Host-float64 frequency finisher (bit-exact once the index matches).

        Flexible peaks are stored 4-decimal rounded, rigid peaks unrounded
        (reference ``get_peak_prominence.py:188`` vs ``get_peak_resolution.py:105``).
        For ``mode="adaptive"`` the per-window detector is recovered from the
        result itself: windows served by the prominence pass carry a strictly
        positive first-slot prominence (acceptance requires prom > 0.5*std),
        fallback windows have it zeroed by the merge.
        """
        idx = int(self.result.idx[self.row, slot])
        if mode == "adaptive":
            used_flex = (
                int(self.result.count[self.row]) > 0
                and float(self.result.prominence[self.row, 0]) > 0.0
            )
            mode = "flexible" if used_flex else "rigid"
        if mode == "rigid":
            return idx * (self.fs / self.n_fft)
        return round(idx * self.fs / self.n_fft, 4)


def analyze_records(
    records: Sequence[tuple[np.ndarray, float]],
    analyze=analyze_epoch,
    on_bucket=None,
    batch_pad: str | None = "pow2",
    **kwargs,
) -> list[RecordPeaks]:
    """Analyze ragged ``(samples, fs)`` records, one XLA program per bucket.

    Records are grouped by ``next_pow2(len(samples))``, zero-padded with their
    true lengths passed through (so median-centering stays exact), and results
    are returned in input order.  ``analyze`` is pluggable (e.g. a
    mesh-sharded pipeline); ``kwargs`` forward to it (mode, backend, ...).
    ``on_bucket(n_fft, record_indices)`` is invoked after each bucket's
    analyze call, so callers can attribute per-run state (e.g. a metric
    snapshot) to exactly the records that run produced.

    ``batch_pad="pow2"`` (default) rounds each bucket's batch up to the next
    power of two with replicate-last pad rows (never referenced by the
    returned views): a long-running gateway sees a different record count
    every epoch, and an exact-B program would recompile (10-40 s) per novel
    (n_fft, B) pair - pow2 bucketing bounds that to log2(B) programs per
    n_fft at <= 2x device work on sub-ms programs.  Pass ``None`` to compile
    exact batch sizes.
    """
    buckets: dict[int, list[int]] = {}
    for i, (samples, _) in enumerate(records):
        if len(samples) == 0:
            raise ValueError(f"record {i} is empty")
        buckets.setdefault(next_pow2(len(samples)), []).append(i)

    # Host buffers honor a requested compute dtype: building them as float32
    # under dtype=float64 would truncate the inputs before the high-precision
    # path ever saw them.  The dtype may arrive as a kwarg or be carried by a
    # SpectralPipeline passed as ``analyze``.
    req = kwargs.get("dtype")
    if req is None:
        req = getattr(getattr(analyze, "config", None), "dtype", None)
    host_dtype = (
        np.float64 if req is not None and np.dtype(req) == np.float64 else np.float32
    )

    out: list[RecordPeaks | None] = [None] * len(records)
    for n_fft, idxs in sorted(buckets.items()):
        b = len(idxs)
        bp = next_pow2(b) if batch_pad == "pow2" else b
        batch = np.zeros((bp, n_fft), host_dtype)
        lengths = np.full((bp,), n_fft, np.int32)
        # fs stays float64 on the host: the device casts it to the compute
        # dtype anyway, and the rigid detector's non-dyadic wipe-rounding
        # table needs the original float64 rate (pipeline._rigid_corr_batch).
        fs = np.ones((bp,), np.float64)
        for row, i in enumerate(idxs):
            samples, rec_fs = records[i]
            batch[row, : len(samples)] = samples
            lengths[row] = len(samples)
            fs[row] = rec_fs
        # Pad rows REPLICATE the last real record (mesh-path convention):
        # zero rows have count == 0, which would force the adaptive mode's
        # whole-epoch rigid fallback on every padded call; replicated rows
        # behave exactly like their source through every detector.
        for row in range(b, bp):
            batch[row] = batch[b - 1]
            lengths[row] = lengths[b - 1]
            fs[row] = fs[b - 1]
        result = analyze(batch, fs, n_fft=n_fft, lengths=lengths, **kwargs)
        # ONE device->host transfer per bucket: RecordPeaks readers index
        # scalars (count, per-slot idx/freq/mag, drift refined_freq, ...),
        # and each scalar read off a device array would otherwise be its
        # own synchronizing transfer.
        result = jax.device_get(result)
        if on_bucket is not None:
            on_bucket(n_fft, list(idxs))
        for row, i in enumerate(idxs):
            out[i] = RecordPeaks(n_fft=n_fft, fs=records[i][1], result=result, row=row)
    return out  # type: ignore[return-value]


def analyze_records_welch(
    records: Sequence[tuple[np.ndarray, float]],
    *,
    window: int,
    hop: int | None = None,
    taper: str = "hann",
    analyze=None,
    on_bucket=None,
    batch_pad: str | None = "pow2",
    **kwargs,
) -> list[RecordPeaks]:
    """Welch-analyze ragged records, one XLA program per record-length bucket.

    The Welch companion of :func:`analyze_records` for long, noisy
    acquisitions: each record is segmented (``window``/``hop``, 50% overlap
    by default), the segment power spectra are averaged, and the detector
    runs once on the averaged spectrum (see
    :func:`~apda_fft_tpu.models.streaming.analyze_welch`).

    Records are bucketed by their EXACT length, not ``next_pow2``: zero-
    padding a record before segmenting would pollute the trailing Welch
    segments with synthetic silence.  Sensors sharing an acquisition config
    produce identical record lengths, so buckets stay coarse in practice.
    Records shorter than ``window`` are analyzed as a single clamped segment
    (effective window = record length); ``on_bucket(n_fft, record_indices)``
    reports the effective padded segment length per bucket.
    ``batch_pad="pow2"`` bounds the compiled-program count exactly like
    :func:`analyze_records` (replicate-last pad rows, never referenced by
    the returned views).
    """
    if analyze is None:
        from apda_fft_tpu.models.streaming import analyze_welch

        analyze = analyze_welch
    if window < 2:
        raise ValueError(f"window must be >= 2, got {window}")
    if hop is not None and hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")

    buckets: dict[int, list[int]] = {}
    for i, (samples, _) in enumerate(records):
        if len(samples) < 2:
            raise ValueError(f"record {i} has fewer than 2 samples")
        buckets.setdefault(len(samples), []).append(i)

    # Same host-dtype contract as analyze_records: a float64 request must
    # not be truncated to float32 before the high-precision path sees it.
    req = kwargs.get("dtype")
    if req is None:
        req = getattr(getattr(analyze, "__self__", None), "config", None)
        req = getattr(req, "dtype", None)
    host_dtype = (
        np.float64 if req is not None and np.dtype(req) == np.float64 else np.float32
    )

    out: list[RecordPeaks | None] = [None] * len(records)
    for t, idxs in sorted(buckets.items()):
        eff_window = min(window, t)
        eff_hop = min(hop, eff_window) if hop is not None else max(eff_window // 2, 1)
        n_fft = next_pow2(eff_window)
        b = len(idxs)
        bp = next_pow2(b) if batch_pad == "pow2" else b
        batch = np.zeros((bp, t), host_dtype)
        fs = np.ones((bp,), np.float64)
        for row, i in enumerate(idxs):
            batch[row] = np.asarray(records[i][0], host_dtype)
            fs[row] = records[i][1]
        for row in range(b, bp):  # replicate-last pad (see analyze_records)
            batch[row] = batch[b - 1]
            fs[row] = fs[b - 1]
        result = analyze(
            batch, fs, window=eff_window, hop=eff_hop, taper=taper, **kwargs
        )
        result = jax.device_get(result)  # one transfer per bucket (see above)
        if on_bucket is not None:
            on_bucket(n_fft, list(idxs))
        for row, i in enumerate(idxs):
            out[i] = RecordPeaks(n_fft=n_fft, fs=records[i][1], result=result, row=row)
    return out  # type: ignore[return-value]
