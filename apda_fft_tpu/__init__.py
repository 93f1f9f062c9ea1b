"""apda_fft_tpu - accelerator adaptive spectral peak detection framework.

A ground-up JAX/XLA rebuild of the capabilities of APDA-FFT
("Adaptive Peak Detection for FFT-based Structural Monitoring"): batched
windowed radix-2 FFT plus the full adaptive peak-detection chain as one jitted
XLA program per acquisition epoch, with the gateway's protocol / file / egress
surface re-implemented around it.

Quick start::

    import apda_fft_tpu as apda
    result = apda.analyze_epoch(samples, fs=500.0, mode="flexible")
    result.freq, result.mag, result.count
"""

from apda_fft_tpu.models.pipeline import (
    PipelineConfig,
    SpectralPipeline,
    analyze_epoch,
    default_k,
    detect_from_mags,
)
from apda_fft_tpu.models.batching import RecordPeaks, analyze_records
from apda_fft_tpu.models.results import EpochResult
from apda_fft_tpu.models.streaming import (
    analyze_epochs_pipelined,
    analyze_stream,
    analyze_welch,
    coherence,
    coherence_with_phase,
    cross_psd,
    frame_records,
    spectrogram,
    welch_psd,
)
from apda_fft_tpu.models.modal import (
    FDDResult,
    ModalTracker,
    ModeTrack,
    csd_matrix,
    fdd,
    modal_assurance,
)
from apda_fft_tpu.models.ssi import (
    SSIMode,
    SSIResult,
    correlation_blocks,
    modal_phase_collinearity,
    ssi,
)
from apda_fft_tpu.models.tracking import PeakTracker, Track, match_peaks
from apda_fft_tpu.ops.integrate import (
    G_TO_MMS2,
    displacement,
    integrate_acceleration,
    velocity,
    velocity_rms,
)
from apda_fft_tpu.ops.resample import (
    decimate,
    decimation_factor,
    rational_factors,
    resample_rational,
)
from apda_fft_tpu.ops.ringdown import ringdown_damping
from apda_fft_tpu.ops.srs import (
    SRSResult,
    shock_response_spectrum,
    smallwood_coefficients,
    srs_frequencies,
)
from apda_fft_tpu.ops.fft import (
    center_and_pad,
    full_spectrum,
    halfspec_magnitudes,
    next_pow2,
    taper_window,
)
from apda_fft_tpu.ops.peaks_prominence import ProminencePeaks, prominence_peaks
from apda_fft_tpu.ops.peaks_resolution import ResolutionPeaks, resolution_peaks

__version__ = "0.3.0"

__all__ = [
    "EpochResult",
    "FDDResult",
    "G_TO_MMS2",
    "SRSResult",
    "ModalTracker",
    "ModeTrack",
    "PeakTracker",
    "PipelineConfig",
    "ProminencePeaks",
    "RecordPeaks",
    "ResolutionPeaks",
    "SSIMode",
    "SSIResult",
    "SpectralPipeline",
    "Track",
    "analyze_epoch",
    "analyze_epochs_pipelined",
    "detect_from_mags",
    "analyze_records",
    "analyze_stream",
    "analyze_welch",
    "center_and_pad",
    "coherence",
    "coherence_with_phase",
    "correlation_blocks",
    "cross_psd",
    "csd_matrix",
    "decimate",
    "decimation_factor",
    "displacement",
    "fdd",
    "frame_records",
    "default_k",
    "integrate_acceleration",
    "modal_assurance",
    "full_spectrum",
    "halfspec_magnitudes",
    "match_peaks",
    "modal_phase_collinearity",
    "next_pow2",
    "prominence_peaks",
    "rational_factors",
    "resample_rational",
    "resolution_peaks",
    "ringdown_damping",
    "shock_response_spectrum",
    "smallwood_coefficients",
    "spectrogram",
    "srs_frequencies",
    "ssi",
    "taper_window",
    "velocity",
    "velocity_rms",
    "welch_psd",
]
