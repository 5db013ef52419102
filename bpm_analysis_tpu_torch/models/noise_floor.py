"""Dynamic noise-floor estimation (reference bpm_analysis.py:1064-1117).

Port of ``bpm_analysis_tpu/models/noise_floor.py`` on its strided knot-domain
path (``_dynamic_noise_floor_knots``), batched:

1. trough detection on the negated envelope (distance + prominence, the
   prominence threshold a quantile of the envelope, :1067),
2. draft floor: centered rolling quantile (window ``noise_window_sec * sr``,
   ``min_periods=3``, q = ``noise_floor_quantile``) of the trough
   interpolation, evaluated at anchors every ``stride`` samples in the knot
   domain → bfill/ffill,
3. trough sanitization: keep troughs with amplitude ≤ ``multiplier`` × the
   draft floor at the trough (:1090-1097),
4. final floor: the same rolling quantile over the sanitized troughs.

Fallback ladder: fewer than 5 raw troughs → static floor at the envelope's
``noise_floor_quantile`` with the raw troughs returned; ≤ 2 sanitized
troughs → the filled draft floor; an all-NaN floor → static floor at
quantile 0.1.

The rolling quantile runs on the CUDA knot kernel for CUDA tensors
(``quantile_backend`` "auto"/"knots_pallas") and on its plain version for
CPU tensors or with "knots".  The exact stride-1 floor (ROADMAP.md A11) and
the dense strided backends "xla"/"pallas" (A12) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AnalyzerConfig
from ..ops import find_peaks as fp
from ..ops import knot_quantile as kq
from ..ops import quantile as q
from ..ops import series
from ..ops.cuda import knot_kernel
from ..ops.indexing import arange, take
from . import envelope as envm


class NoiseFloorResult(NamedTuple):
    floor: torch.Tensor                 # (B, n) dense noise floor
    trough_positions: torch.Tensor      # (B, max_troughs) int32, padded with n
    trough_count: torch.Tensor          # (B,) int32
    raw_trough_positions: torch.Tensor
    raw_trough_count: torch.Tensor
    overflowed: torch.Tensor            # (B,) bool: a capacity truncated troughs


def _knots_backend(cfg: AnalyzerConfig) -> bool:
    """True for the kernel's wrapper, False for the plain version; raises
    for the paths that are not ported yet."""
    stride = cfg.runtime.noise_quantile_stride
    backend = cfg.runtime.quantile_backend
    if stride <= 1:
        raise NotImplementedError(
            "noise_quantile_stride=1 (the exact wavelet-tree floor) is not "
            "ported yet: ROADMAP.md queue A item 11")
    if backend in ("auto", "knots_pallas"):
        return True
    if backend == "knots":
        return False
    raise NotImplementedError(
        f"quantile_backend={backend!r} (dense strided quantile) is not ported "
        "yet: ROADMAP.md queue A item 12")


def dynamic_noise_floor(
    envelope: torch.Tensor, sample_rate: int, cfg: AnalyzerConfig, n_valid=None,
    extrema=None,
) -> NoiseFloorResult:
    """Noise floor of each row of ``envelope`` (B, n).  ``n_valid`` (B,) marks
    each row's valid prefix of a zero-padded batch; ``extrema`` is the
    shared extrema decomposition of the edge-held envelope."""
    use_kernel = _knots_backend(cfg)
    if extrema is None:
        raise NotImplementedError(
            "the dense prominence backend is not ported yet: ROADMAP.md "
            "queue A item 12")
    bsz, n = envelope.shape
    ncfg = cfg.noise
    min_dist = int(cfg.features.min_peak_distance_sec * sample_rate)
    cap = min(cfg.runtime.max_troughs,
              fp.distance_capacity_bound(n, max(min_dist, 1)))
    valid, env_m = envm.edge_held(envelope, n_valid)

    trough_prom = q.quantile_exact(envelope, cfg.features.trough_prominence_quantile,
                                   valid=valid)
    # Extrema were built on env == -(-env_m): the envelope's minima ARE the
    # trough candidates, prioritized by their negated heights.
    troughs = fp.find_peaks(
        -env_m, cap, prominence=trough_prom, distance=min_dist,
        work_capacity=cfg.runtime.find_peaks_work_factor * cfg.runtime.max_troughs,
        prominence_capacity=int(cfg.runtime.prominence_work_factor * cap),
        extrema=extrema, extrema_negated=True,
        candidates=fp.Peaks(extrema.min_positions, extrema.min_count,
                            extrema.overflowed),
        priorities=-extrema.min_heights[:, 1:-1],
        prominence_sweep_window=cfg.runtime.prominence_sweep_window,
        prominence_residual_capacity=cfg.runtime.prominence_residual_capacity)
    slot = arange(cap, envelope)[None, :]
    t_valid = slot < troughs.count.long()[:, None]
    t_pos = torch.where(t_valid, troughs.positions.long(), 0)
    t_amp = take(env_m, t_pos)

    window = int(ncfg.noise_window_sec * sample_rate)
    stride = cfg.runtime.noise_quantile_stride
    min_spacing = max(min_dist, 1)

    def rolling_q_knots(pos, amp, count):
        if use_kernel:
            # float32 contract, as the TPU kernel: amplitudes go in as
            # float32 and the anchors come back in the envelope's dtype.
            return knot_kernel.knot_quantile_anchors(
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

    if n_valid is None:
        def fix_tail_span(d):
            return d
    else:
        last_anchor_pos = ((n_valid.long()[:, None] - 1) // stride) * stride
        idx = arange(n, envelope)[None, :]

        def fix_tail_span(d):
            return torch.where(idx >= last_anchor_pos, take(d, last_anchor_pos), d)

    # --- draft floor from ALL troughs (anchors only) -----------------------
    draft_anchors = rolling_q_knots(troughs.positions, t_amp, troughs.count)
    draft_anchors_filled = q.bfill_ffill(draft_anchors)

    # --- sanitize troughs (sparse draft evaluation) ------------------------
    floor_at_trough = kq.anchors_at(draft_anchors_filled, t_pos, n, stride,
                                    n_valid=n_valid)
    keep = t_valid & ~torch.isnan(floor_at_trough) & (
        t_amp <= ncfg.trough_rejection_multiplier * floor_at_trough)
    sane_pos, sane_count = series.compact_valid(t_pos, keep, fill=n)
    sane_amp = take(env_m, torch.where(slot < sane_count.long()[:, None], sane_pos, 0))

    # --- final floor from sanitized troughs --------------------------------
    final_anchors = rolling_q_knots(sane_pos, sane_amp, sane_count)

    # --- fallback ladder (selected on the anchor axis) ----------------------
    sc = sane_count.long()[:, None]
    floor_anchors = torch.where(sc > 2, q.bfill_ffill(final_anchors),
                                draft_anchors_filled)
    floor = fix_tail_span(q.interp_anchors(floor_anchors, n, stride))
    static_all_nan = q.quantile_exact(envelope, ncfg.all_nan_fallback_quantile,
                                      valid=valid)
    all_nan = torch.isnan(floor_anchors).all(dim=1, keepdim=True)
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
