"""Analytics over batched beat lists: BPM curve, HRV, HRR, slopes.

Port of ``bpm_analysis_tpu/models/analytics.py`` (reference
bpm_analysis.py:1414-1620 and ``_calculate_final_metrics`` :1701-1722).
Every function works on (B, cap) arrays plus (B,) counts.  The reference's
quirks stay behind the same switches (``compat.hrr_truncated_interp``: the
integer-truncated epoch-second interpolation of ``calculate_hrr``).

:func:`compute_metrics` is the CUDA kernel ``csrc/metrics.cu`` on the card
(one launch) and :func:`compute_metrics_plain`, the eager functions below,
on the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import AnalyzerConfig
from ..ops import find_peaks as fp
from ..ops import rolling, series
from ..ops.cuda import metrics_kernel
from ..ops.indexing import arange, scatter_drop, take


HRV_CAPACITY = 512   # windowed_hrv's window slots


class BpmSeries(NamedTuple):
    times: torch.Tensor     # (B, cap) seconds of beats 1..count
    smoothed: torch.Tensor  # (B, cap) time-smoothed BPM
    instant: torch.Tensor   # (B, cap) raw instantaneous BPM
    count: torch.Tensor     # (B,)


class SlopeStats(NamedTuple):
    found: torch.Tensor
    start_time: torch.Tensor
    end_time: torch.Tensor
    start_bpm: torch.Tensor
    end_bpm: torch.Tensor
    slope: torch.Tensor
    duration: torch.Tensor


class SlopeList(NamedTuple):
    start_time: torch.Tensor  # (B, cap) sorted by |slope| descending
    end_time: torch.Tensor
    start_bpm: torch.Tensor
    end_bpm: torch.Tensor
    duration: torch.Tensor
    bpm_change: torch.Tensor
    slope: torch.Tensor
    count: torch.Tensor


class HrvResult(NamedTuple):
    time: torch.Tensor     # (B, cap) window midpoint seconds
    rmssdc: torch.Tensor
    sdnn: torch.Tensor
    bpm: torch.Tensor
    count: torch.Tensor


class HrrStats(NamedTuple):
    found: torch.Tensor
    peak_bpm: torch.Tensor
    peak_time: torch.Tensor
    recovery_bpm: torch.Tensor
    hrr: torch.Tensor


class Metrics(NamedTuple):
    bpm: BpmSeries
    hrv: HrvResult
    hrr: HrrStats
    peak_exertion: SlopeStats
    peak_recovery: SlopeStats
    inclines: SlopeList
    declines: SlopeList
    avg_bpm: torch.Tensor
    min_bpm: torch.Tensor
    max_bpm: torch.Tensor
    avg_rmssdc: torch.Tensor
    avg_sdnn: torch.Tensor


def _nan_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float("nan"))


def _divisor(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor in ``like``'s dtype and on its device.  A CUDA
    tensor over a Python number is a multiply by the number's reciprocal,
    over a device tensor an IEEE division, as on the CPU: so a beat time
    rounds alike on both, and one on a smoothing window's edge keeps its
    side."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def smoothing_slot_bound(sample_rate: int, cfg: AnalyzerConfig) -> int | None:
    """Slots in half the BPM smoothing window at most (beat times are >= the
    peak-finder NMS distance apart, which bounds the window's slot span), or
    None past 128 slots, where the plain version's shifted adds would cost
    more than a prefix sum."""
    dt_min = max(int(cfg.features.min_peak_distance_sec * sample_rate), 1) / sample_rate
    m_bound = int(math.ceil(cfg.output.output_smoothing_window_sec / 2 / dt_min)) + 1
    return m_bound if m_bound <= 128 else None


def bpm_series(positions: torch.Tensor, count: torch.Tensor, sample_rate: int,
               cfg: AnalyzerConfig, dtype: torch.dtype) -> BpmSeries:
    """``calculate_bpm_series`` (bpm_analysis.py:1463-1484): instantaneous
    BPM at each beat after the first, smoothed by a centered 5 s time
    window (closed right).  Diffs <= 1e-6 s are dropped."""
    bsz, cap = positions.shape
    count = count.long()[:, None]
    slot = arange(cap, positions)[None, :]
    pos = torch.where(slot < count, positions.long(), torch.iinfo(torch.int32).max)
    t = pos.to(dtype)
    t = t / _divisor(sample_rate, t)
    diffs = t[:, 1:] - t[:, :-1]
    dvalid = (slot[:, :-1] < count - 1) & (diffs > 1e-6)
    inst = 60.0 / torch.where(dvalid, diffs, torch.ones_like(diffs))
    times = t[:, 1:]
    # Compact the valid diffs to the front, keeping time order.
    rank = torch.cumsum(dvalid.long(), dim=1) - 1
    write = torch.where(dvalid, rank, cap)
    vcount = dvalid.long().sum(dim=1)
    ctimes = scatter_drop(cap, write, times, float("nan"), dtype)
    cinst = scatter_drop(cap, write, inst, float("nan"), dtype)
    valid = slot < vcount[:, None]

    smoothed = rolling.rolling_mean_time_window(
        ctimes, cinst, valid, cfg.output.output_smoothing_window_sec,
        max_slots_in_half_window=smoothing_slot_bound(sample_rate, cfg))
    return BpmSeries(times=ctimes, smoothed=smoothed, instant=cinst,
                     count=vcount.to(torch.int32))


def steepest_slope(bpm: BpmSeries, window_sec: float, direction: int,
                   start_slot=None) -> SlopeStats:
    """``find_peak_exertion_rate`` (direction=+1, whole series) /
    ``find_peak_recovery_rate`` (direction=-1, from ``start_slot`` (B,)
    onward) — steepest slope over the first window >= ``window_sec`` ahead
    (bpm_analysis.py:1552-1595)."""
    bsz, cap = bpm.times.shape
    count = bpm.count.long()[:, None]
    slot = arange(cap, bpm.times)[None, :]
    valid = slot < count
    t = torch.where(valid, bpm.times, torch.full_like(bpm.times, float("inf")))
    v = bpm.smoothed
    if start_slot is None:
        start_slot = torch.zeros(bsz, dtype=torch.int64, device=t.device)
    start = start_slot.long()[:, None]

    in_range = valid & (slot >= start)
    t0 = take(t, torch.clamp(start, max=cap - 1))
    last_t = take(t, torch.clamp(count - 1, min=0))
    long_enough = (count - start >= 2) & (last_t - t0 >= window_sec)

    end_idx = torch.searchsorted(t.contiguous(), (t + window_sec).contiguous(), right=False)
    has_end = end_idx < count
    end_c = torch.clamp(end_idx, 0, cap - 1)
    t_end = take(t, end_c)
    duration = t_end - t
    ok = in_range & has_end & (duration > 0) & (slot < count - 1)
    v_end = take(v, end_c)
    slope = (v_end - v) / torch.where(ok, duration, torch.ones_like(duration))
    eff = torch.where(ok, slope * direction, torch.full_like(slope, float("-inf")))
    best = torch.argmax(eff, dim=1, keepdim=True)
    found = long_enough & (take(eff, best) > 0)
    return SlopeStats(
        found=found[:, 0],
        start_time=take(t, best)[:, 0],
        end_time=take(t_end, best)[:, 0],
        start_bpm=take(v, best)[:, 0],
        end_bpm=take(v_end, best)[:, 0],
        slope=take(slope, best)[:, 0],
        duration=take(duration, best)[:, 0],
    )


def _masked_argmax(bpm: BpmSeries) -> torch.Tensor:
    valid = arange(bpm.times.shape[1], bpm.times)[None, :] < bpm.count.long()[:, None]
    v = torch.where(valid, bpm.smoothed, torch.full_like(bpm.smoothed, float("-inf")))
    return torch.argmax(v, dim=1)


def peak_recovery(bpm: BpmSeries, cfg: AnalyzerConfig) -> SlopeStats:
    return steepest_slope(bpm, cfg.output.slope_window_sec, -1,
                          start_slot=_masked_argmax(bpm))


def peak_exertion(bpm: BpmSeries, cfg: AnalyzerConfig) -> SlopeStats:
    return steepest_slope(bpm, cfg.output.slope_window_sec, +1)


def slope_extrema(bpm: BpmSeries, cfg: AnalyzerConfig, capacity: int = 64):
    """Peak/trough sets of the smoothed BPM curve for the major-slope scans
    (bpm_analysis.py:1496-1497,1529-1530), shared by both passes."""
    o = cfg.output
    bsz, cap = bpm.times.shape
    count = bpm.count.long()[:, None]
    slot = arange(cap, bpm.times)[None, :]
    valid = slot < count
    t = torch.where(valid, bpm.times, torch.full_like(bpm.times, float("inf")))
    v = torch.where(valid, bpm.smoothed, _nan_like(bpm.smoothed))

    dt = t[:, 1:] - t[:, :-1]
    dt_valid = slot[:, :-1] < count - 1
    mean_dt = series.nanmean_fixed(torch.where(dt_valid, dt, _nan_like(dt)))
    safe = torch.where(mean_dt == 0, torch.ones_like(mean_dt), mean_dt)
    dist = torch.where(torch.isnan(mean_dt) | (mean_dt == 0),
                       torch.full_like(mean_dt, 5, dtype=torch.int32),
                       (o.incline_min_duration_sec / 2 / safe).to(torch.int32))
    vv = torch.where(valid, bpm.smoothed, take(v, torch.clamp(count - 1, min=0)))
    pk = fp.find_peaks(vv, capacity, prominence=o.slope_peak_prominence, distance=dist)
    tr = fp.find_peaks(-vv, capacity, prominence=o.slope_peak_prominence, distance=dist)
    return pk, tr


def major_slopes(bpm: BpmSeries, cfg: AnalyzerConfig, declines: bool,
                 capacity: int = 64, extrema=None) -> SlopeList:
    """``find_major_hr_inclines/declines`` (bpm_analysis.py:1486-1550):
    trough→next-peak (incline) or peak→next-trough (decline) segments with
    duration >= 10 s and |ΔBPM| >= 15, sorted by slope steepness."""
    o = cfg.output
    bsz, cap = bpm.times.shape
    count = bpm.count.long()[:, None]
    slot = arange(cap, bpm.times)[None, :]
    valid = slot < count
    t = torch.where(valid, bpm.times, torch.full_like(bpm.times, float("inf")))
    v = torch.where(valid, bpm.smoothed, _nan_like(bpm.smoothed))

    pk, tr = extrema if extrema is not None else slope_extrema(bpm, cfg, capacity)
    starts, ends = (pk, tr) if declines else (tr, pk)
    s_slot = arange(capacity, t)[None, :]
    s_valid = s_slot < starts.count.long()[:, None]
    s_pos = torch.where(s_valid, starts.positions.long(), cap)
    e_padded = torch.where(s_slot < ends.count.long()[:, None], ends.positions.long(), cap)
    nxt = torch.searchsorted(e_padded, s_pos, right=True)
    has_next = nxt < ends.count.long()[:, None]
    e_pos = take(e_padded, torch.clamp(nxt, 0, capacity - 1))

    s_c = torch.clamp(s_pos, 0, cap - 1)
    e_c = torch.clamp(e_pos, 0, cap - 1)
    ts, te = take(t, s_c), take(t, e_c)
    vs, ve = take(v, s_c), take(v, e_c)
    duration = te - ts
    change = ve - vs
    magnitude = -change if declines else change
    ok = (s_valid & has_next & (ends.count.long()[:, None] > 0)
          & (starts.count.long()[:, None] > 0)
          & (duration >= o.incline_min_duration_sec)
          & (magnitude >= o.incline_min_bpm_change) & (count >= 2))
    slope = change / torch.where(duration > 0, duration, torch.ones_like(duration))

    sort_key = torch.where(ok, slope if declines else -slope,
                           torch.full_like(slope, float("inf")))
    order = torch.argsort(sort_key, dim=1, stable=True)
    cnt = ok.long().sum(dim=1)
    first = s_slot < cnt[:, None]

    def take_sorted(x):
        return torch.where(first, take(x, order), _nan_like(x))

    return SlopeList(
        start_time=take_sorted(ts), end_time=take_sorted(te),
        start_bpm=take_sorted(vs), end_bpm=take_sorted(ve),
        duration=take_sorted(duration), bpm_change=take_sorted(change),
        slope=take_sorted(slope), count=cnt.to(torch.int32))


def _interp_rows(x: torch.Tensor, xp: torch.Tensor, fp_: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x[b], xp[b], fp[b])`` per row, ``x`` (B,), ``xp`` sorted
    (B, k)."""
    k = xp.shape[1]
    i = torch.searchsorted(xp.contiguous(), x[:, None].contiguous(), right=True)
    i = torch.clamp(i, 1, k - 1)
    f_lo, f_hi = take(fp_, i - 1), take(fp_, i)
    x_lo, x_hi = take(xp, i - 1), take(xp, i)
    df = f_hi - f_lo
    dx = x_hi - x_lo
    delta = x[:, None] - x_lo
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                    else np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x[:, None] < xp[:, :1], fp_[:, :1], f)
    f = torch.where(x[:, None] > xp[:, -1:], fp_[:, -1:], f)
    return f[:, 0]


def hrr(bpm: BpmSeries, cfg: AnalyzerConfig) -> HrrStats:
    """1-minute heart-rate recovery (bpm_analysis.py:1597-1610); with
    ``compat.hrr_truncated_interp`` the interpolation abscissae are the beat
    times floored to whole seconds, as the reference's epoch-second call."""
    bsz, cap = bpm.times.shape
    count = bpm.count.long()[:, None]
    valid = arange(cap, bpm.times)[None, :] < count
    v = torch.where(valid, bpm.smoothed, torch.full_like(bpm.smoothed, float("-inf")))
    t = torch.where(valid, bpm.times, torch.full_like(bpm.times, float("inf")))
    imax = torch.argmax(v, dim=1, keepdim=True)
    peak_bpm = take(v, imax)[:, 0]
    peak_time = take(t, imax)[:, 0]
    check_time = peak_time + cfg.output.hrr_interval_sec
    last_i = torch.clamp(count - 1, min=0)
    last_t = take(t, last_i)
    found = (count[:, 0] >= 2) & (check_time <= last_t[:, 0])
    tq = torch.where(valid, bpm.times, last_t)
    if cfg.compat.hrr_truncated_interp:
        tq = torch.floor(tq)
    vq = torch.where(valid, bpm.smoothed, take(v, last_i))
    recovery_bpm = _interp_rows(check_time, tq, vq)
    return HrrStats(found=found, peak_bpm=peak_bpm, peak_time=peak_time,
                    recovery_bpm=recovery_bpm, hrr=peak_bpm - recovery_bpm)


def windowed_hrv(positions: torch.Tensor, count: torch.Tensor, sample_rate: int,
                 cfg: AnalyzerConfig, dtype, capacity: int = HRV_CAPACITY) -> HrvResult:
    """``calculate_windowed_hrv`` (bpm_analysis.py:1414-1461): windows of
    ``hrv_window_size_beats`` RR intervals every ``hrv_step_size_beats``;
    SDNN (population std, ms), RMSSDc (= RMSSD_ms / mean_RR_sec, the
    reference's unit mix), window BPM, at the window midpoint time."""
    w = cfg.output.hrv_window_size_beats
    step = cfg.output.hrv_step_size_beats
    bsz, cap = positions.shape
    count = count.long()[:, None]
    slot = arange(cap, positions)[None, :]
    t = torch.where(slot < count, positions.long(), 0).to(dtype)
    t = t / _divisor(sample_rate, t)
    rr_ms = (t[:, 1:] - t[:, :-1]) * 1000.0

    n_rr = torch.clamp(count - 1, min=0)
    starts = arange(capacity, positions)[None, :] * step
    wvalid = (starts + w <= n_rr) & (count >= w)
    idx = torch.clamp(starts[:, :, None] + arange(w, positions)[None, None, :], 0, cap - 2)
    win = take(rr_ms, idx.expand(bsz, -1, -1))             # (B, capacity, w)
    # Fixed-order sums: the same bits for a recording whatever the batch.
    mean_rr = series.fixed_order_sum(win) / _divisor(w, t)
    sdnn = torch.sqrt(series.fixed_order_sum((win - mean_rr[..., None]) ** 2) / _divisor(w, t))
    sd = win[:, :, 1:] - win[:, :, :-1]
    rmssd = torch.sqrt(series.fixed_order_sum(sd ** 2) / _divisor(w - 1, t))
    mean_rr_sec = mean_rr / _divisor(1000.0, t)
    rmssdc = torch.where(mean_rr_sec > 0, rmssd / mean_rr_sec, torch.zeros_like(rmssd))
    wbpm = torch.where(mean_rr_sec > 0, 60.0 / mean_rr_sec, torch.zeros_like(mean_rr_sec))
    starts_b = starts.expand(bsz, -1)
    mid = (take(t, torch.clamp(starts_b, 0, cap - 1))
           + take(t, torch.clamp(starts_b + w, 0, cap - 1))) / 2.0
    nwin = wvalid.long().sum(dim=1)

    def mask(x):
        return torch.where(wvalid, x, _nan_like(x))

    return HrvResult(time=mask(mid), rmssdc=mask(rmssdc), sdnn=mask(sdnn),
                     bpm=mask(wbpm), count=nwin.to(torch.int32))


def _nan_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """nanmin / nanmax along the last axis (NaN for an all-NaN row)."""
    fill = float("inf") if op == "min" else float("-inf")
    filled = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
    out = filled.amin(dim=1) if op == "min" else filled.amax(dim=1)
    return torch.where(torch.isnan(x).all(dim=1), torch.full_like(out, float("nan")), out)


def compute_metrics_plain(positions: torch.Tensor, count: torch.Tensor, sample_rate: int,
                          cfg: AnalyzerConfig, dtype) -> Metrics:
    """``_calculate_final_metrics`` (bpm_analysis.py:1701-1722) in eager
    PyTorch: the plain version of ``csrc/metrics.cu``."""
    bpm = bpm_series(positions, count, sample_rate, cfg, dtype)
    hrv = windowed_hrv(positions, count, sample_rate, cfg, dtype)
    cap = bpm.times.shape[1]
    valid = arange(cap, bpm.times)[None, :] < bpm.count.long()[:, None]
    sm = torch.where(valid, bpm.smoothed, _nan_like(bpm.smoothed))
    nonempty = bpm.count > 0
    nan = torch.full_like(sm[:, 0], float("nan"))
    avg = torch.where(nonempty, series.nanmean_fixed(sm), nan)
    mn = torch.where(nonempty, _nan_reduce(sm, "min"), nan)
    mx = torch.where(nonempty, _nan_reduce(sm, "max"), nan)
    hrv_nonempty = hrv.count > 0
    avg_rmssdc = torch.where(hrv_nonempty, series.nanmean_fixed(hrv.rmssdc), nan)
    avg_sdnn = torch.where(hrv_nonempty, series.nanmean_fixed(hrv.sdnn), nan)
    slope_ext = slope_extrema(bpm, cfg)
    return Metrics(
        bpm=bpm,
        hrv=hrv,
        hrr=hrr(bpm, cfg),
        peak_exertion=peak_exertion(bpm, cfg),
        peak_recovery=peak_recovery(bpm, cfg),
        inclines=major_slopes(bpm, cfg, declines=False, extrema=slope_ext),
        declines=major_slopes(bpm, cfg, declines=True, extrema=slope_ext),
        avg_bpm=avg, min_bpm=mn, max_bpm=mx,
        avg_rmssdc=avg_rmssdc, avg_sdnn=avg_sdnn,
    )


def compute_metrics(positions: torch.Tensor, count: torch.Tensor, sample_rate: int,
                    cfg: AnalyzerConfig, dtype) -> Metrics:
    """``_calculate_final_metrics`` (bpm_analysis.py:1701-1722): on a card one
    launch of the kernel ``csrc/metrics.cu``, the plain version's bits there
    wherever :func:`smoothing_slot_bound` bounds the smoothing window below
    the capacity, as in every benchmark cell; with an unbounded window the
    kernel sums each window in slot order where the plain version
    differences a prefix sum, so the two differ by rounding.
    :func:`compute_metrics_plain` on the CPU."""
    if positions.device.type == "cpu":
        return compute_metrics_plain(positions, count, sample_rate, cfg, dtype)
    p = metrics_kernel.compute(positions.to(torch.int32).contiguous(),
                               count.to(torch.int32).contiguous(), sample_rate, cfg, dtype,
                               smoothing_slot_bound(sample_rate, cfg), HRV_CAPACITY)
    sc = dict(zip(metrics_kernel.SCALARS, p.scalars))

    def stats(name: str, found) -> SlopeStats:
        return SlopeStats(found, *(sc[f"{name}.{f}"] for f in SlopeStats._fields[1:]))

    def slope_list(k: int) -> SlopeList:
        fields = dict(zip(metrics_kernel.LIST_FIELDS, p.slopes[k]))
        return SlopeList(**fields, count=p.counts[2 + k])

    return Metrics(
        bpm=BpmSeries(times=p.series[0], smoothed=p.series[1], instant=p.series[2],
                      count=p.counts[0]),
        hrv=HrvResult(time=p.hrv[0], rmssdc=p.hrv[1], sdnn=p.hrv[2], bpm=p.hrv[3],
                      count=p.counts[1]),
        hrr=HrrStats(found=p.found[0], peak_bpm=sc["hrr.peak_bpm"],
                     peak_time=sc["hrr.peak_time"], recovery_bpm=sc["hrr.recovery_bpm"],
                     hrr=sc["hrr.hrr"]),
        peak_exertion=stats("peak_exertion", p.found[1]),
        peak_recovery=stats("peak_recovery", p.found[2]),
        inclines=slope_list(0), declines=slope_list(1),
        avg_bpm=sc["avg_bpm"], min_bpm=sc["min_bpm"], max_bpm=sc["max_bpm"],
        avg_rmssdc=sc["avg_rmssdc"], avg_sdnn=sc["avg_sdnn"])


def recovery_phase(bpm: BpmSeries, cfg: AnalyzerConfig):
    """``find_recovery_phase`` (bpm_analysis.py:1612-1620): peak-BPM time of
    the preliminary smoothed series, recovery window end = +120 s.
    Returns (peak_time, end_time, valid), each (B,)."""
    imax = _masked_argmax(bpm)
    peak_time = take(bpm.times, imax)
    ok = bpm.count >= 2
    return peak_time, peak_time + cfg.pairing.recovery_phase_duration_sec, ok
