"""Dynamic noise-floor estimation (reference bpm_analysis.py:1064-1117).

Port of ``bpm_analysis_tpu/models/noise_floor.py``, batched:

1. trough detection on the negated envelope (distance + prominence, the
   prominence threshold a quantile of the envelope, :1067),
2. draft floor: centered rolling quantile (window ``noise_window_sec * sr``,
   ``min_periods=3``, q = ``noise_floor_quantile``) of the trough
   interpolation → bfill/ffill,
3. trough sanitization: keep troughs with amplitude ≤ ``multiplier`` × the
   draft floor at the trough (:1090-1097),
4. final floor: the same rolling quantile over the sanitized troughs.

Fallback ladder: fewer than 5 raw troughs → static floor at the envelope's
``noise_floor_quantile`` with the raw troughs returned; ≤ 2 sanitized
troughs → the filled draft floor; an all-NaN floor → static floor at
quantile 0.1.

The rolling quantile, by ``noise_quantile_stride`` and ``quantile_backend``
as the JAX package selects it:

* stride > 1, "auto"/"knots_pallas": the knot domain (the dense series is
  never built), on the CUDA knot kernel for CUDA tensors and its plain
  version for CPU tensors; "knots": the plain version on any device;
* stride > 1, "pallas" with a stride dividing 128: the dense series on the
  CUDA strided-quantile kernel (its plain version for CPU tensors), in
  float32;
* any other stride > 1: the dense strided quantile
  ``rolling_quantile_centered_strided`` (the JAX "xla" backend);
* stride 1, whatever the backend: the exact ``rolling_quantile_centered``
  (pandas parity), on the CUDA rolling-quantile kernel for CUDA tensors and
  its wavelet-tree plain version for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AnalyzerConfig
from ..ops import find_peaks as fp
from ..ops import knot_quantile as kq
from ..ops import quantile as q
from ..ops import series
from ..ops.indexing import arange, take
from . import envelope as envm


class NoiseFloorResult(NamedTuple):
    floor: torch.Tensor                 # (B, n) dense noise floor
    trough_positions: torch.Tensor      # (B, max_troughs) int32, padded with n
    trough_count: torch.Tensor          # (B,) int32
    raw_trough_positions: torch.Tensor
    raw_trough_count: torch.Tensor
    overflowed: torch.Tensor            # (B,) bool: a capacity truncated troughs


def quantile_path(cfg: AnalyzerConfig) -> str:
    """The rolling quantile this configuration runs: "knots_kernel",
    "knots", "strided_kernel", "strided" or "exact" (module docstring)."""
    stride = cfg.runtime.noise_quantile_stride
    backend = cfg.runtime.quantile_backend
    if stride <= 1:
        return "exact"
    if backend in ("auto", "knots_pallas"):
        return "knots_kernel"
    if backend == "knots":
        return "knots"
    if backend == "pallas" and 128 % stride == 0:
        return "strided_kernel"
    return "strided"


def dynamic_noise_floor(
    envelope: torch.Tensor, sample_rate: int, cfg: AnalyzerConfig, n_valid=None,
    env_tables=None, extrema=None,
) -> NoiseFloorResult:
    """Noise floor of each row of ``envelope`` (B, n).  ``n_valid`` (B,) marks
    each row's valid prefix of a zero-padded batch: the padded tail is held
    at ``envelope[n_valid-1]`` for the peak finder, NaN-masked out of every
    rolling quantile and masked out of the global quantiles.  ``extrema`` is
    the shared extrema decomposition of the edge-held envelope;
    ``env_tables`` its shared ``(max_table, min_table)`` sparse tables (the
    dense prominence backend).  With neither, the trough finder builds its
    own tables."""
    bsz, n = envelope.shape
    ncfg = cfg.noise
    min_dist = int(cfg.features.min_peak_distance_sec * sample_rate)
    cap = min(cfg.runtime.max_troughs,
              fp.distance_capacity_bound(n, max(min_dist, 1)))
    valid, env_m = envm.edge_held(envelope, n_valid)

    trough_prom = q.quantile_exact(
        envelope, cfg.features.trough_prominence_quantile, valid=valid)
    if extrema is not None:
        # Extrema were built on env == -(-env_m): the envelope's minima ARE
        # the trough candidates, prioritized by their negated heights.
        shared = dict(
            extrema=extrema, extrema_negated=True,
            candidates=fp.Peaks(extrema.min_positions, extrema.min_count,
                                extrema.overflowed),
            priorities=-extrema.min_heights[:, 1:-1],
            prominence_sweep_window=cfg.runtime.prominence_sweep_window,
            prominence_residual_capacity=cfg.runtime.prominence_residual_capacity)
    elif env_tables is not None:
        # Tables are of env == -(-env_m): descents flip in place, no copies.
        shared = dict(max_table=env_tables[0], min_table=env_tables[1],
                      tables_negated=True)
    else:
        shared = {}
    troughs = fp.find_peaks(
        -env_m, cap, prominence=trough_prom, distance=min_dist,
        work_capacity=cfg.runtime.find_peaks_work_factor * cfg.runtime.max_troughs,
        prominence_capacity=int(cfg.runtime.prominence_work_factor * cap),
        **shared)
    slot = arange(cap, envelope)[None, :]
    t_valid = slot < troughs.count.long()[:, None]
    t_pos = torch.where(t_valid, troughs.positions.long(), 0)
    t_amp = take(env_m, t_pos)

    window = int(ncfg.noise_window_sec * sample_rate)
    stride = cfg.runtime.noise_quantile_stride
    path = quantile_path(cfg)
    if path in ("knots_kernel", "knots"):
        floor_at_trough, final_of = _knot_floors(
            envelope, troughs, t_pos, t_amp, n_valid, cfg, min_dist, window,
            stride, path == "knots_kernel")
    else:
        floor_at_trough, final_of = _dense_floors(
            envelope, troughs, t_pos, t_amp, valid, n_valid, cfg, min_dist,
            window, stride, path)

    # --- sanitize troughs ---------------------------------------------------
    keep = t_valid & ~torch.isnan(floor_at_trough) & (
        t_amp <= ncfg.trough_rejection_multiplier * floor_at_trough)
    sane_pos, sane_count = series.compact_valid(t_pos, keep, fill=n)
    sane_amp = take(env_m, torch.where(slot < sane_count.long()[:, None], sane_pos, 0))

    # --- final floor from sanitized troughs, and the fallback ladder --------
    sc = sane_count.long()[:, None]
    floor, all_nan = final_of(sane_pos, sane_amp, sane_count, sc > 2)
    static_all_nan = q.quantile_exact(
        envelope, ncfg.all_nan_fallback_quantile, valid=valid)
    floor = torch.where(all_nan, static_all_nan[:, None], floor)
    static_few = q.quantile_exact(envelope, ncfg.noise_floor_quantile, valid=valid)
    few_troughs = troughs.count.long()[:, None] < 5
    floor = torch.where(few_troughs, static_few[:, None], floor)

    out_pos = torch.where(few_troughs, troughs.positions.long(), sane_pos)
    out_count = torch.where(few_troughs[:, 0], troughs.count, sane_count)

    return NoiseFloorResult(
        floor=floor,
        trough_positions=out_pos.to(torch.int32),
        trough_count=out_count.to(torch.int32),
        raw_trough_positions=troughs.positions,
        raw_trough_count=troughs.count,
        overflowed=troughs.overflowed,
    )


def _tail_span_fix(envelope, n_valid, stride):
    """The strided floors interpolate between anchors; an unpadded run's
    final partial span holds its LAST anchor constant, while a padded run
    would interpolate toward a tail anchor.  Pin each row's span
    [last_anchor*stride, n) to the last anchor's value (exact for stride 1
    too: the span is then the last valid sample itself)."""
    if n_valid is None:
        return lambda d: d
    last_anchor_pos = ((n_valid.long()[:, None] - 1) // stride) * stride
    idx = arange(envelope.shape[1], envelope)[None, :]
    return lambda d: torch.where(idx >= last_anchor_pos, take(d, last_anchor_pos), d)


def _knot_floors(envelope, troughs, t_pos, t_amp, n_valid, cfg, min_dist,
                 window, stride, use_kernel):
    """The knot-domain floors (JAX ``_dynamic_noise_floor_knots``): anchors
    straight from the trough knots, the draft evaluated sparsely at the
    troughs, the draft/final choice and the all-NaN test made on the anchor
    axis (both floors share the grid and ``interp_anchors`` is linear in the
    anchors), and one dense expansion.  Returns the draft floor at the
    troughs and ``final_of``, which gives the chosen floor and its all-NaN
    flag (B, 1)."""
    n = envelope.shape[1]
    ncfg = cfg.noise
    min_spacing = max(min_dist, 1)
    fix_tail_span = _tail_span_fix(envelope, n_valid, stride)

    def rolling_q_knots(pos, amp, count):
        if use_kernel:
            # float32 contract, as the TPU kernel: amplitudes go in as
            # float32 and the anchors come back in the envelope's dtype.
            return kq.knot_quantile_anchors_f32(
                pos.to(torch.int32).contiguous(),
                amp.to(torch.float32).contiguous(),
                count.to(torch.int32).contiguous(), n, window,
                ncfg.noise_floor_quantile, min_periods=3, stride=stride,
                min_spacing=min_spacing, n_valid=n_valid).to(envelope.dtype)
        return kq.rolling_quantile_knots(
            pos, amp, count, n, window, ncfg.noise_floor_quantile,
            min_periods=3, stride=stride, min_spacing=min_spacing,
            n_valid=n_valid, chunk=cfg.runtime.quantile_chunk,
            dtype=envelope.dtype)

    draft_anchors = q.bfill_ffill(rolling_q_knots(troughs.positions, t_amp,
                                                  troughs.count))
    floor_at_trough = kq.anchors_at(draft_anchors, t_pos, n, stride,
                                    n_valid=n_valid)

    def final_of(sane_pos, sane_amp, sane_count, use_final):
        final_anchors = rolling_q_knots(sane_pos, sane_amp, sane_count)
        anchors = torch.where(use_final, q.bfill_ffill(final_anchors), draft_anchors)
        return (fix_tail_span(q.interp_anchors(anchors, n, stride)),
                torch.isnan(anchors).all(dim=1, keepdim=True))

    return floor_at_trough, final_of


def _dense_floors(envelope, troughs, t_pos, t_amp, valid, n_valid, cfg,
                  min_dist, window, stride, path):
    """The dense floors (JAX ``dynamic_noise_floor``'s own branch): the
    trough interpolation is built densely, tail-masked, reduced by the
    rolling quantile of ``path``, and edge-filled.  Returns what
    ``_knot_floors`` returns."""
    n = envelope.shape[1]
    ncfg = cfg.noise
    qv = ncfg.noise_floor_quantile
    chunk = cfg.runtime.quantile_chunk
    fix_tail_span = _tail_span_fix(envelope, n_valid, stride)

    def rolling_q(d):
        if path == "strided_kernel":
            # float32 contract, as the TPU kernel; the anchors are expanded
            # in the envelope's dtype.
            return q.rolling_quantile_strided_f32(
                d, window, qv, min_periods=3, stride=stride)
        if path == "strided":
            return q.rolling_quantile_centered_strided(
                d, window, qv, min_periods=3, stride=stride, chunk=chunk)
        return q.rolling_quantile_centered(d, window, qv, min_periods=3)

    if valid is None:
        def mask_tail(d):
            return d
    else:
        def mask_tail(d):
            # NaN == missing == pandas truncating the window at the series end.
            return torch.where(valid, d, torch.full_like(d, float("nan")))

    def floor_of(pos, amp, count):
        # Troughs come out of the distance NMS, >= min_dist apart: the
        # spacing-aware block interpolation applies.
        dense = series.interpolate_dense(pos, amp, count, n, dtype=envelope.dtype,
                                         min_spacing=max(min_dist, 1))
        # NaNs here are structurally prefix/suffix runs (min_periods edges
        # and the masked tail), so the edge fill is exactly bfill().ffill().
        return q.edge_fill(mask_tail(fix_tail_span(rolling_q(mask_tail(dense)))))

    draft_filled = floor_of(t_pos, t_amp, troughs.count)
    floor_at_trough = take(draft_filled, t_pos)

    def final_of(sane_pos, sane_amp, sane_count, use_final):
        floor = torch.where(use_final, floor_of(sane_pos, sane_amp, sane_count),
                            draft_filled)
        return floor, torch.isnan(floor).all(dim=1, keepdim=True)

    return floor_at_trough, final_of
