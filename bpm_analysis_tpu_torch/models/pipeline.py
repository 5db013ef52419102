"""The batched analysis pipeline — the device-side orchestrator.

Port of ``bpm_analysis_tpu/models/pipeline.py`` (reference
``analyze_wav_file``, bpm_analysis.py:1725-1768):

  STAGE 1   envelope extrema + dynamic noise floor
  STAGE 2   preliminary high-confidence pass → start BPM + recovery window
  STAGE 3   main classification
  STAGE 4+5 rhythmic + iterative gap/conflict corrections
  STAGE 6   metrics (BPM curve, HRV, HRR, slopes)

Every stage works on the whole batch (B, n) at once; the JAX package's
``vmap`` over recordings is the leading axis here.  A NaN start-BPM hint
means "no hint" (a 0.0 hint also falls through, bpm_analysis.py:1647).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import AnalyzerConfig
from ..device import as_tensor, resolve_device
from ..ops import find_peaks as fp
from ..ops import quantile as quantile_ops
from ..ops import series
from ..ops.indexing import arange, take
from . import analytics, classifier, corrections, noise_floor
from . import envelope as envm


class PipelineResult(NamedTuple):
    floor: torch.Tensor
    trough_positions: torch.Tensor
    trough_count: torch.Tensor
    raw_peak_positions: torch.Tensor
    raw_peak_count: torch.Tensor
    start_bpm: torch.Tensor
    peak_bpm_time: torch.Tensor      # NaN when no recovery phase found
    recovery_end_time: torch.Tensor
    trace: classifier.ClassifierTrace
    smoothed_deviation: torch.Tensor
    classes: torch.Tensor            # final (post-correction) class per raw peak
    precorrection_classes: torch.Tensor
    s1_positions: torch.Tensor       # post-classification, pre-correction
    s1_count: torch.Tensor
    final_positions: torch.Tensor    # post-correction S1 peaks
    final_count: torch.Tensor
    metrics: analytics.Metrics
    ok: torch.Tensor                 # >= 2 final peaks
    overflowed: torch.Tensor         # (B,) bool: some capacity truncated data


def raw_peaks(envelope: torch.Tensor, floor: torch.Tensor, sample_rate: int,
              cfg: AnalyzerConfig, n_valid=None, env_tables=None,
              extrema=None) -> fp.Peaks:
    """``PeakClassifier._find_raw_peaks`` (bpm_analysis.py:223-229), height
    = the noise floor.  With the shared ``extrema`` decomposition the height
    filter applies to its candidate maxima, which are then compacted for the
    distance NMS; otherwise the dense finder runs on the edge-held envelope
    with its shared ``env_tables`` (built here when None)."""
    valid, env_m = envm.edge_held(envelope, n_valid)
    prom = quantile_ops.quantile_exact(envelope, cfg.features.peak_prominence_quantile,
                                       valid=valid)
    n = envelope.shape[1]
    dist = int(cfg.features.min_peak_distance_sec * sample_rate)
    cap = min(cfg.runtime.max_raw_peaks, fp.distance_capacity_bound(n, dist))
    common = dict(
        prominence=prom, distance=dist,
        work_capacity=cfg.runtime.find_peaks_work_factor * cfg.runtime.max_raw_peaks,
        prominence_capacity=int(cfg.runtime.prominence_work_factor * cap))
    if extrema is None:
        tables = {} if env_tables is None else dict(max_table=env_tables[0],
                                                    min_table=env_tables[1])
        return fp.find_peaks(env_m, cap, height=floor, **common, **tables)
    mh_real = extrema.max_heights[:, 1:-1]
    floor_at = take(floor, torch.clamp(extrema.max_positions.long(), 0, n - 1))
    in_count = arange(mh_real.shape[1], envelope)[None, :] < extrema.max_count.long()[:, None]
    keep = in_count & (mh_real >= floor_at)
    ccap = min(cfg.runtime.raw_candidate_capacity or mh_real.shape[1], mh_real.shape[1])
    (cpos, chts), ccount, cover = fp.compact_slots(
        keep, ccap, [(extrema.max_positions, n), (mh_real, float("-inf"))])
    return fp.find_peaks(
        env_m, cap, **common,
        extrema=extrema, extrema_negated=False,
        candidates=fp.Peaks(cpos, ccount, cover | extrema.overflowed),
        priorities=chts,
        prominence_sweep_window=cfg.runtime.prominence_sweep_window,
        prominence_residual_capacity=cfg.runtime.prominence_residual_capacity)


def preliminary_pass(envelope, floor, peaks: fp.Peaks, sample_rate: int,
                     start_bpm_hint, cfg: AnalyzerConfig):
    """``_run_preliminary_pass`` (bpm_analysis.py:1623-1652): a trace-free
    classification at the high-confidence threshold gives the start BPM
    (median RR of >= 10 anchors) and the recovery window."""
    dtype = envelope.dtype
    hint_valid = ~torch.isnan(start_bpm_hint) & (start_bpm_hint != 0)
    hint_or_default = torch.where(hint_valid, start_bpm_hint,
                                  torch.full_like(start_bpm_hint,
                                                  cfg.rhythm.default_start_bpm))
    cfg_hc = cfg.with_pairing_threshold(cfg.pairing.preliminary_confidence_threshold)
    res = classifier.classify(envelope, floor, peaks.positions, peaks.count,
                              sample_rate, hint_or_default, cfg_hc, want_trace=False)
    anchors, a_count = res.s1_positions.long(), res.s1_count.long()

    cap = anchors.shape[1]
    slot = arange(cap, anchors)[None, :]
    rr = (anchors[:, 1:] - anchors[:, :-1]).to(dtype) / sample_rate
    rr_valid = slot[:, :-1] < a_count[:, None] - 1
    median_rr = series.masked_median(rr, rr_valid)
    est_valid = (a_count >= 10) & (median_rr > 0)
    estimate = 60.0 / torch.where(median_rr > 0, median_rr, torch.ones_like(median_rr))
    default = torch.full_like(estimate, cfg.rhythm.default_start_bpm)
    start_bpm = torch.where(hint_valid, start_bpm_hint,
                            torch.where(est_valid, estimate, default))

    prelim_bpm = analytics.bpm_series(res.s1_positions, res.s1_count, sample_rate,
                                      cfg, dtype)
    peak_time, recovery_end, rec_ok = analytics.recovery_phase(prelim_bpm, cfg)
    nan = torch.full_like(peak_time, float("nan"))
    return (start_bpm, torch.where(rec_ok, peak_time, nan),
            torch.where(rec_ok, recovery_end, nan))


def analyze_envelope(envelope: torch.Tensor, sample_rate: int, cfg: AnalyzerConfig,
                     start_bpm_hints: torch.Tensor, n_valid=None) -> PipelineResult:
    """Full pipeline (stages 1b-6) over a batch of envelopes (B, n) on their
    device.  ``n_valid`` (B,) marks each row's valid prefix of a zero-padded
    batch: every result equals the run on ``envelope[b, :n_valid[b]]``."""
    dtype = envelope.dtype
    bsz, n = envelope.shape
    start_bpm_hints = start_bpm_hints.to(dtype)

    # Peak-finder auxiliaries of the edge-held envelope, built once and
    # shared by the trough finder (on -env: roles swap and comparisons
    # negate) and the raw-peak finder: the extrema decomposition (default),
    # or the dense sparse-table pair (prominence_backend="dense").
    _, env_m = envm.edge_held(envelope, n_valid)
    if cfg.runtime.prominence_backend == "dense":
        env_tables = (fp._sparse_table(env_m, torch.maximum),
                      fp._sparse_table(env_m, torch.minimum))
        extrema = None
    else:
        env_tables = None
        extrema = fp.build_extrema(
            env_m, cfg.runtime.extrema_capacity
            or cfg.runtime.find_peaks_work_factor * cfg.runtime.max_raw_peaks)

    nf = noise_floor.dynamic_noise_floor(envelope, sample_rate, cfg,
                                         n_valid=n_valid, env_tables=env_tables,
                                         extrema=extrema)
    peaks = raw_peaks(envelope, nf.floor, sample_rate, cfg, n_valid=n_valid,
                      env_tables=env_tables, extrema=extrema)

    start_bpm, peak_time, recovery_end = preliminary_pass(
        envelope, nf.floor, peaks, sample_rate, start_bpm_hints, cfg)

    res = classifier.classify(
        envelope, nf.floor, peaks.positions, peaks.count, sample_rate,
        start_bpm, cfg, peak_bpm_time_sec=peak_time,
        recovery_end_time_sec=recovery_end)

    # Reference short-circuit: < 2 raw peaks → every raw peak is a "beat"
    # with no debug info (bpm_analysis.py:115-116).
    few = peaks.count.long() < 2
    ccap = cfg.runtime.max_candidates
    rp = peaks.positions
    if rp.shape[1] < ccap:
        rp = torch.cat([rp, torch.full((bsz, ccap - rp.shape[1]), n, dtype=rp.dtype,
                                       device=rp.device)], dim=1)
    slot = arange(ccap, envelope)[None, :]
    few_pos = torch.where(slot < peaks.count.long()[:, None], rp[:, :ccap], n)
    s1_pos = torch.where(few[:, None], few_pos, res.s1_positions).to(torch.int32)
    s1_count = torch.where(few, torch.clamp(peaks.count, max=ccap),
                           res.s1_count).to(torch.int32)

    corr = corrections.refine_and_correct(
        s1_pos, s1_count, peaks.positions, peaks.count, res.trace.peak_class,
        envelope, nf.floor, sample_rate, cfg)

    metrics = analytics.compute_metrics(corr.positions, corr.count, sample_rate,
                                        cfg, dtype)

    return PipelineResult(
        floor=nf.floor,
        trough_positions=nf.trough_positions,
        trough_count=nf.trough_count,
        raw_peak_positions=peaks.positions,
        raw_peak_count=peaks.count,
        start_bpm=start_bpm,
        peak_bpm_time=peak_time,
        recovery_end_time=recovery_end,
        trace=res.trace,
        smoothed_deviation=res.smoothed_deviation,
        classes=corr.classes,
        precorrection_classes=corr.precorrection_classes,
        s1_positions=s1_pos,
        s1_count=s1_count,
        final_positions=corr.positions,
        final_count=corr.count,
        metrics=metrics,
        ok=corr.count >= 2,
        overflowed=(peaks.overflowed | nf.overflowed | res.s1_overflowed
                    | corr.overflowed),
    )


def analyze_batch(envelopes, sample_rate: int, cfg: AnalyzerConfig,
                  start_bpm_hints: Optional[torch.Tensor] = None,
                  n_valid: Optional[torch.Tensor] = None,
                  device=None) -> PipelineResult:
    """Analyze a batch of equal-length envelopes (B, n).

    Entry point: runs on CUDA unless ``device="cpu"``; inputs may be numpy
    arrays or tensors.  ``start_bpm_hints`` (B,) defaults to NaN (no hint);
    ``n_valid`` (B,) enables mixed-length batches padded to one length."""
    dev = resolve_device(device)
    envelopes = as_tensor(envelopes, dev)
    if start_bpm_hints is None:
        start_bpm_hints = torch.full((envelopes.shape[0],), float("nan"),
                                     dtype=envelopes.dtype, device=dev)
    else:
        start_bpm_hints = as_tensor(start_bpm_hints, dev)
    if n_valid is not None:
        n_valid = as_tensor(n_valid, dev).to(torch.int32)
    with torch.no_grad():
        return analyze_envelope(envelopes, sample_rate, cfg, start_bpm_hints,
                                n_valid=n_valid)
