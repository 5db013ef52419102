"""Typed configuration for the PyTorch port of the heartbeat analyzer.

An own copy of ``bpm_analysis_tpu/config.py`` (the port imports nothing of
the JAX package): the seven commented sections of the reference's flat
parameter dict (its ``config.py:3-108``) as frozen dataclasses,
plus the compat switches and the runtime knobs.  Field names, defaults and
meanings are identical, so a JAX config carries over field for field through
:func:`config_from_dict`.

The reference's config/code drifts (SURVEY.md §2) are reproduced as the code
behaves, with the documented-but-unimplemented behavior gated behind
:class:`CompatConfig` flags:

* ``rr_correction_threshold_pct``: 0.40 wins at runtime (``bpm_analysis.py:1273``).
* ``cascade_reset_trigger_count`` (=3) and ``enable_interval_penalty``
  (=True) are read by the code but absent from the reference config; they are
  first-class fields here.
* the kick-start override (``bpm_analysis.py:168``) writes a state key that is
  never read; ``CompatConfig.kickstart_effective`` enables the documented
  behavior (README.md:9) instead of the as-implemented no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Section 1 — general & preprocessing (reference config.py:4-9)."""

    downsample_factor: int = 300
    save_filtered_wav: bool = True
    # Hardcoded in the reference (bpm_analysis.py:1018): band-pass corner
    # frequencies in Hz and filter order.
    bandpass_low_hz: float = 20.0
    bandpass_high_hz: float = 150.0
    bandpass_order: int = 2
    # Envelope rolling-mean window = sample_rate // envelope_window_divisor
    # (bpm_analysis.py:1053).
    envelope_window_divisor: int = 10


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Section 2 — signal feature detection (reference config.py:11-17)."""

    min_peak_distance_sec: float = 0.05
    peak_prominence_quantile: float = 0.1
    trough_prominence_quantile: float = 0.1


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Section 3 — noise estimation & rejection (reference config.py:19-32).

    The 3.2 "peak noise vetoing" keys of the reference config are vestigial
    (never read by v4.3 code; SURVEY.md §2.2) and intentionally omitted.
    """

    noise_floor_quantile: float = 0.20
    noise_window_sec: float = 10.0
    trough_rejection_multiplier: float = 4.0
    # Fallback quantile when the final floor is all-NaN (hardcoded 0.1 at
    # bpm_analysis.py:1114).
    all_nan_fallback_quantile: float = 0.1


@dataclasses.dataclass(frozen=True)
class PairingConfig:
    """Section 4 — S1/S2 pairing & confidence engine (config.py:34-68)."""

    pairing_confidence_threshold: float = 0.50
    s1_s2_interval_cap_sec: float = 0.4
    s1_s2_interval_rr_fraction: float = 0.7
    deviation_smoothing_factor: float = 0.05
    stability_history_window: int = 20
    stability_confidence_floor: float = 0.60
    stability_confidence_ceiling: float = 1.25
    s1_s2_boost_ratio: float = 1.2
    boost_amount_min: float = 0.10
    boost_amount_max: float = 0.35
    penalty_amount_min: float = 0.10
    penalty_amount_max: float = 0.30
    s2_s1_ratio_low_bpm: float = 1.5
    s2_s1_ratio_high_bpm: float = 1.1
    contractility_bpm_low: float = 120.0
    contractility_bpm_high: float = 140.0
    recovery_phase_duration_sec: float = 120.0
    # 4.4 interval penalty (read via .get with these defaults,
    # bpm_analysis.py:250-253; enable flag absent from reference config).
    enable_interval_penalty: bool = True
    interval_penalty_start_factor: float = 1.0
    interval_penalty_full_factor: float = 1.4
    interval_max_penalty: float = 0.75
    # 4.5 kick-start (dead code in the reference — see CompatConfig).
    kickstart_check_threshold: float = 0.3
    kickstart_override_ratio: float = 0.60
    # Hardcoded anchors of the blended confidence model
    # (bpm_analysis.py:1128-1132).
    deviation_points: Tuple[float, ...] = (0.0, 0.25, 0.40, 0.80, 1.0)
    curve_low: Tuple[float, ...] = (0.9, 0.9, 0.7, 0.1, 0.1)
    curve_high: Tuple[float, ...] = (0.1, 0.5, 0.75, 0.65, 0.0)
    # Hardcoded preliminary-pass threshold (bpm_analysis.py:1632).
    preliminary_confidence_threshold: float = 0.75
    # Hardcoded boost-saturation ratio (bpm_analysis.py:1191).
    boost_saturation_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class RhythmConfig:
    """Section 5 — rhythm plausibility & validation (config.py:70-87)."""

    min_bpm: float = 40.0
    max_bpm: float = 240.0
    lone_s1_forward_check_pct: float = 0.50
    lone_s1_confidence_threshold: float = 0.50
    lone_s1_rhythm_weight: float = 0.65
    lone_s1_amplitude_weight: float = 0.35
    # Read via .get, absent from reference config (bpm_analysis.py:294).
    cascade_reset_trigger_count: int = 3
    # Hardcoded long-term-BPM EMA constants (bpm_analysis.py:1242-1243).
    belief_learning_rate: float = 0.05
    belief_max_change_per_beat: float = 3.0
    # Hardcoded lone-S1 confidence curves (bpm_analysis.py:1213-1228).
    rhythm_dev_points: Tuple[float, ...] = (0.0, 0.15, 0.30, 0.50)
    rhythm_conf_curve: Tuple[float, ...] = (1.0, 0.8, 0.4, 0.0)
    amp_ratio_points: Tuple[float, ...] = (0.0, 0.4, 0.7, 1.0)
    amp_conf_curve: Tuple[float, ...] = (0.0, 0.4, 0.8, 1.0)
    # Hardcoded forward-check amplitude waiver (bpm_analysis.py:323).
    forward_check_amp_waiver: float = 1.7
    # Default belief when no hint/estimate exists (bpm_analysis.py:103,1647).
    default_start_bpm: float = 80.0


@dataclasses.dataclass(frozen=True)
class CorrectionConfig:
    """Section 6 — post-processing correction pass (config.py:89-97).

    ``enable_correction_pass`` exists in the reference config (False!) but is
    never checked — the pass always runs (bpm_analysis.py:1655-1698).  Here
    the flag is honored and defaults to True to match runtime behavior.
    """

    enable_correction_pass: bool = True
    rr_correction_threshold_pct: float = 0.40
    rr_correction_long_interval_pct: float = 1.70
    penalty_waiver_strength_ratio: float = 4.0
    penalty_waiver_max_s2_s1_ratio: float = 2.5
    # Hardcoded stage-5 constants (bpm_analysis.py:1318,1672).
    margin_beats: int = 3
    max_iterations: int = 5
    long_gap_multiplier_stage4_min_peaks: int = 5


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    """Section 7 — output, HRV & reporting (config.py:99-108)."""

    output_smoothing_window_sec: float = 5.0
    hrv_window_size_beats: int = 40
    hrv_step_size_beats: int = 5
    plot_amplitude_scale_factor: float = 250.0
    plot_downsample_factor: int = 1
    # Hardcoded analytics constants (bpm_analysis.py:1486,1552,1597).
    incline_min_duration_sec: float = 10.0
    incline_min_bpm_change: float = 15.0
    slope_window_sec: float = 20.0
    hrr_interval_sec: float = 60.0
    slope_peak_prominence: float = 5.0


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Bug-compatibility switches (SURVEY.md §2 quirk catalogue).

    Defaults reproduce the reference *as implemented* (the golden vulpine
    artifacts embed these quirks); flipping a flag enables the documented /
    fixed behavior.
    """

    # Reference decimates BEFORE filtering with no anti-alias filter
    # (bpm_analysis.py:1031-1045, contradicting README.md:6).  False = same;
    # True = filter at native rate then decimate (the north-star path).
    antialias_decimation: bool = False
    # Reference kick-start writes an override that is never read
    # (bpm_analysis.py:168).  True = actually apply the documented override.
    kickstart_effective: bool = False
    # Reference calculate_hrr feeds integer-truncated epoch seconds to
    # np.interp (bpm_analysis.py:1606): the beat times are floored to whole
    # seconds (the timezone offset of datetime.fromtimestamp(0) cancels for
    # whole-second offsets) while the query stays float.  True (default)
    # reproduces the golden 58.9 HRR on vulpine; False uses the clean exact
    # float-second interpolation (61.2 on the same curve).
    hrr_truncated_interp: bool = True
    # Reference preprocess_audio writes ``*_filtered_debug.wav`` twice: once
    # beside the wav being analyzed (bpm_analysis.py:1047-1050) and once in
    # the output directory (:1056-1060).  In the GUI flow both resolve to the
    # same file (the wav is already in the output dir), but a direct
    # analyze_wav_file call on a wav elsewhere gets both copies — and some
    # labeler setups read the beside-the-input one.  True (default)
    # reproduces that; False writes only the output-directory copy.
    filtered_wav_beside_input: bool = True


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Runtime knobs — new in this framework (no reference equivalent).

    Same fields and defaults as the JAX package's ``RuntimeConfig`` so a
    configuration carries over unchanged; fields that only steer JAX/TPU
    code generation (``quantile_chunk`` beyond memory chunking,
    ``classifier_unroll``) are accepted and have no effect on results."""

    # Static capacities for padded per-recording arrays.  Sized for ~10 min
    # recordings at ~300 Hz with dense beats; bump for longer inputs.
    max_raw_peaks: int = 4096
    max_troughs: int = 4096
    max_candidates: int = 2048
    # Compute dtype for the DSP/analytics path ("float32" on the card;
    # tests run "float64" on CPU for exact parity with the reference).
    dtype: str = "float32"
    # Anchors per chunk of the plain strided and knot quantiles (bounds
    # memory); the CUDA kernels ignore it.
    quantile_chunk: int = 1024
    # Noise-floor quantile stride: 1 = exact pandas parity (the wavelet-tree
    # rank select, whatever the backend); >1 = strided anchors + linear
    # interpolation.
    noise_quantile_stride: int = 1
    # Strided-quantile backend (stride > 1; models/noise_floor.quantile_path):
    # "auto" and "knots_pallas" = the knot domain on the CUDA knot kernel for
    # CUDA tensors and its plain version for CPU tensors; "knots" = that plain
    # version on any device; "pallas" (stride dividing 128) = the dense series
    # on the CUDA strided-quantile kernel (its plain version for CPU
    # tensors), in float32; anything else ("xla") = the dense strided
    # quantile in the envelope's dtype.
    quantile_backend: str = "auto"
    # Work-buffer multiplier for the peak/trough finders: the intermediate
    # local-extrema population (before distance/prominence pruning) is
    # bounded by factor * max_raw_peaks / max_troughs.
    find_peaks_work_factor: int = 4
    # Slot-axis bound (as a multiple of the peak/trough capacity) for the
    # prominence evaluation.  Distance survivors beyond factor * capacity are
    # truncated WITH the overflow flag set (same contract as every capacity).
    prominence_work_factor: float = 1.5
    # Slots per classifier scan step in the JAX package; no effect here.
    classifier_unroll: int = 4
    # Prominence evaluation backend: "extrema" (and "auto") computes
    # prominences in the extrema domain (ops/find_peaks.extrema_prominences);
    # "dense" by sparse-table descents over the envelope, one table pair
    # shared by the trough and raw-peak finders.  Same results.
    prominence_backend: str = "auto"
    # Extrema-sweep radius: nearest-taller searches within this many extrema
    # slots are resolved by shifted compares; peaks taller than their whole
    # window fall to the residual descent.
    prominence_sweep_window: int = 64
    # Slot capacity of that residual descent; overflow sets the pipeline
    # overflow flag (truncate-with-flag contract).
    prominence_residual_capacity: int = 1024
    # Slot capacity of the shared extrema decomposition (ALL local maxima /
    # minima, pre-height-filter, incl. 2 virtual edge slots).  0 derives
    # find_peaks_work_factor * max_raw_peaks.  Truncation sets the overflow
    # flag.
    extrema_capacity: int = 0
    # Slot capacity the raw-peak finder compacts its height-surviving maxima
    # into before the distance NMS.  0 keeps the full extrema width.
    # Populations beyond the capacity are truncated WITH the overflow flag.
    raw_candidate_capacity: int = 0


@dataclasses.dataclass(frozen=True)
class AnalyzerConfig:
    """Top-level config: seven reference sections + compat + runtime."""

    preprocess: PreprocessConfig = PreprocessConfig()
    features: FeatureConfig = FeatureConfig()
    noise: NoiseConfig = NoiseConfig()
    pairing: PairingConfig = PairingConfig()
    rhythm: RhythmConfig = RhythmConfig()
    correction: CorrectionConfig = CorrectionConfig()
    output: OutputConfig = OutputConfig()
    compat: CompatConfig = CompatConfig()
    runtime: RuntimeConfig = RuntimeConfig()

    def replace(self, **kw) -> "AnalyzerConfig":
        return dataclasses.replace(self, **kw)

    def with_pairing_threshold(self, threshold: float) -> "AnalyzerConfig":
        """The preliminary pass re-runs the classifier with a higher pairing
        threshold (bpm_analysis.py:1630-1632)."""
        return self.replace(
            pairing=dataclasses.replace(self.pairing, pairing_confidence_threshold=threshold)
        )


DEFAULT_CONFIG = AnalyzerConfig()


_SECTION_TYPES = {
    "preprocess": PreprocessConfig, "features": FeatureConfig,
    "noise": NoiseConfig, "pairing": PairingConfig, "rhythm": RhythmConfig,
    "correction": CorrectionConfig, "output": OutputConfig,
    "compat": CompatConfig, "runtime": RuntimeConfig,
}


def config_from_dict(d: dict) -> AnalyzerConfig:
    """Build an :class:`AnalyzerConfig` from ``dataclasses.asdict`` of an
    analyzer config (the JAX package's or this one's): one nested dict per
    section.  Sequences become tuples so the result stays hashable; a
    missing section keeps its defaults, and an unknown section or field
    raises ``TypeError``."""
    unknown = set(d) - set(_SECTION_TYPES)
    if unknown:
        raise TypeError(f"unknown config sections: {sorted(unknown)}")
    sections = {}
    for name, values in d.items():
        fields = {k: tuple(v) if isinstance(v, (list, tuple)) else v
                  for k, v in values.items()}
        sections[name] = _SECTION_TYPES[name](**fields)
    return AnalyzerConfig(**sections)
