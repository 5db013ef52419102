"""The stateful beat classifier as one sequential scan over raw-peak slots.

Port of ``bpm_analysis_tpu/models/classifier.py`` (reference
``PeakClassifier``, bpm_analysis.py:64-330, and its confidence helpers
:1120-1250).  The JAX ``lax.scan`` becomes, on the card, the CUDA kernel
``csrc/classify_scan.cu`` (one block per recording, through
``ops/cuda/classify_kernel``; :func:`classify_scan` makes the choice and
builds the kernel's constant tables) and, on the CPU, its plain version
:func:`scan_plain`: a Python loop over slots whose state is (B,)-shaped, so
every recording of the batch advances in lockstep:

* the reference's variable advance (1 for lone/noise, 2 for an S1-S2 pair)
  is a ``pending_s2`` carry flag — the slot after an accepted pair is the S2;
* the debug-string greps of the reference are a 20-slot ring of "was this
  candidate an S1 (Paired)" flags;
* every decision emits the 26-field :class:`ClassifierTrace`.

Everything that depends only on the slot's inputs (intervals, strength
ratios, the boost amount, the forward-check terms) is computed for all slots
before the scan (:class:`ScanInputs`); the scan carries only what depends on
the state and reads nothing back to the host.

Quirks reproduced (SURVEY.md §2): the belief EMA runs once per processed
step even when it classified noise; a NaN confidence clamps to 1.0; the
kick-start override is a no-op unless ``compat.kickstart_effective``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import AnalyzerConfig
from ..device import upload
from ..ops import rolling
from ..ops.cuda import classify_kernel
from ..ops.indexing import arange, take
from .. import types

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}
# The classify kernel's constant tables on the card, by (sample_rate, cfg,
# dtype, device); the last 16 configurations are kept.
_kernel_tables: dict = {}
# Trace fields that are slot inputs, passed through as they are.
SLOT_FIELDS = ("deviation", "s2_s1_ratio", "s1_s2_ratio", "interval_sec", "implied_bpm")


class ClassifierTrace(NamedTuple):
    """Per-raw-peak-slot structured decision trace, each (B, capacity)."""

    peak_class: torch.Tensor        # int32 class code (types.*)
    deviation: torch.Tensor
    blend_ratio: torch.Tensor
    base_conf: torch.Tensor
    pairing_ratio: torch.Tensor
    stability_factor: torch.Tensor  # NaN when beat_count < 5
    s2_s1_ratio: torch.Tensor
    max_expected_ratio: torch.Tensor
    penalty_amount: torch.Tensor    # NaN when no penalty
    boost_amount: torch.Tensor      # NaN when no boost
    s1_s2_ratio: torch.Tensor
    interval_sec: torch.Tensor
    max_interval_sec: torch.Tensor
    interval_penalty: torch.Tensor  # NaN when no interval penalty
    final_conf: torch.Tensor
    paired: torch.Tensor            # bool
    lone_reason: torch.Tensor       # int32 types.LONE_*
    lone_conf: torch.Tensor
    rhythm_score: torch.Tensor
    actual_rr_sec: torch.Tensor
    expected_rr_sec: torch.Tensor
    amp_score: torch.Tensor
    amp_ratio: torch.Tensor
    implied_bpm: torch.Tensor
    belief: torch.Tensor
    belief_time_sec: torch.Tensor


class ClassifierResult(NamedTuple):
    s1_positions: torch.Tensor      # (B, max_candidates) int32, padded with n
    s1_count: torch.Tensor          # (B,) int32
    trace: Optional[ClassifierTrace]  # None under classify(want_trace=False)
    smoothed_deviation: torch.Tensor  # (B, capacity-1)
    s1_overflowed: torch.Tensor     # (B,) bool


class Interp:
    """``jnp.interp(x, xp, fp)`` with constant knots ``xp`` (a tuple) and
    values ``fp`` (a tuple, or per call a tensor (..., k) varying with
    ``x``), its constant tables built once on the device: segment index
    ``searchsorted(xp, x, 'right')`` clamped to [1, k-1], then
    ``fp[i-1] + (delta / dx) * df``, constant beyond the ends.  (A NaN ``x``
    lands in another segment than in JAX, and gives NaN all the same.)"""

    def __init__(self, xp, fp, dtype: torch.dtype, device):
        npd = _NP_DTYPE[dtype]
        xp_np = np.asarray(xp, npd)
        self.k = len(xp)
        self.x_first, self.x_last = float(xp_np[0]), float(xp_np[-1])
        dx = xp_np[1:] - xp_np[:-1]                    # rounded in the working dtype
        dx0 = np.abs(dx) <= np.spacing(np.finfo(npd).eps)
        self.dx0 = torch.as_tensor(dx0, device=device) if dx0.any() else None
        self.xp_t = torch.as_tensor(xp_np, device=device)
        rows = [xp_np[:-1], np.where(dx0, npd(1), dx)]
        self.const_fp = fp is not None
        if self.const_fp:
            fp_np = np.asarray(fp, npd)
            rows += [fp_np[:-1], fp_np[1:] - fp_np[:-1]]
            self.f_ends = (float(fp_np[0]), float(fp_np[-1]))
        self.table = torch.as_tensor(np.stack(rows), device=device)  # (rows, k-1)

    def __call__(self, x: torch.Tensor, fp: Optional[torch.Tensor] = None):
        i = torch.searchsorted(self.xp_t, x.contiguous(), right=True)
        im1 = torch.clamp(i, 1, self.k - 1) - 1
        seg = self.table[:, im1]
        if self.const_fp:
            x_lo, dx, f_lo, df = seg
            f_first, f_last = self.f_ends
        else:
            x_lo, dx = seg
            f_pair = torch.gather(fp, -1, torch.stack([im1, im1 + 1], dim=-1))
            f_lo = f_pair[..., 0]
            df = f_pair[..., 1] - f_lo
            f_first, f_last = fp[..., 0], fp[..., -1]
        f = f_lo + ((x - x_lo) / dx) * df
        if self.dx0 is not None:
            f = torch.where(self.dx0[im1], f_lo, f)
        f = torch.where(x < self.x_first, f_first, f)
        return torch.where(x > self.x_last, f_last, f)


def deviation_series(envelope, floor, positions, count, cfg: AnalyzerConfig):
    """Smoothed peak-strength deviation series (bpm_analysis.py:93-100):
    dev[k] = |s[k+1]-s[k]| / (max(s[k], s[k+1]) + 1e-9), smoothed by a
    centered rolling mean of width max(5, int(n_dev * factor)) per row."""
    dtype = envelope.dtype
    cap = positions.shape[1]
    pos = torch.clamp(positions.long(), 0, envelope.shape[1] - 1)
    strengths = torch.clamp(take(envelope, pos) - take(floor, pos), min=0)
    d = (strengths[:, 1:] - strengths[:, :-1]).abs() / (
        torch.maximum(strengths[:, :-1], strengths[:, 1:]) + 1e-9)
    n_dev = torch.clamp(count.long() - 1, min=0)
    valid = arange(cap - 1, envelope)[None, :] < n_dev[:, None]
    window = torch.clamp(
        (n_dev.to(dtype) * cfg.pairing.deviation_smoothing_factor).to(torch.int32),
        min=5)
    max_window = max(5, int((cap - 1) * cfg.pairing.deviation_smoothing_factor) + 1)
    smoothed = rolling.rolling_mean_dynamic_window(d, valid, window, max_window)
    return smoothed, strengths


class ScanInputs(NamedTuple):
    """What the carry-dependent loop reads, all computed before it: per slot
    (B, capacity) and per row (B,)."""

    positions: torch.Tensor     # int32 raw-peak positions (padded with n)
    count: torch.Tensor         # (B,) int32 valid slots
    start_belief: torch.Tensor  # (B,) the belief's initial value
    deviation: torch.Tensor     # smoothed deviation at the (t-1, t) midpoint
    interval_sec: torch.Tensor  # to the next raw peak
    s2_s1_ratio: torch.Tensor
    s1_s2_ratio: torch.Tensor
    strength: torch.Tensor
    boost: torch.Tensor         # boost amount if boosted
    implied_bpm: torch.Tensor
    flags: torch.Tensor         # uint8: STRONG_S1 | IN_RECOVERY | FWD_WAIVED


STRONG_S1, IN_RECOVERY, FWD_WAIVED = 1, 2, 4


class _Carry(NamedTuple):
    pending_s2: torch.Tensor
    belief: torch.Tensor
    last_pos: torch.Tensor
    prev_pos: torch.Tensor
    last_strength: torch.Tensor
    cand_count: torch.Tensor
    ring: torch.Tensor           # (B, hist) bool — paired flags, newest last
    rejections: torch.Tensor
    ks_lone: torch.Tensor        # (B, 4) bool, kick-start bookkeeping
    ks_next_noise: torch.Tensor  # (B, 4) bool
    ks_prev_was_lone: torch.Tensor


def scan_plain(x: ScanInputs, sample_rate: int, cfg: AnalyzerConfig,
               want_trace: bool = True):
    """The carry-dependent loop over the slots, one step per slot for every
    row at once: the plain version of ``csrc/classify_scan.cu``.  Returns
    (peak_class (B, capacity) int32, the trace or None).

    Every division has a tensor divisor, so it is an IEEE division on any
    device (a CUDA division by a Python number multiplies by its
    reciprocal); a Python number over a tensor is torch's
    ``reciprocal() * number`` everywhere."""
    p = cfg.pairing
    r = cfg.rhythm
    dtype = x.deviation.dtype
    dev = x.deviation.device
    bsz, cap = x.positions.shape
    sr = torch.tensor(sample_rate, dtype=dtype, device=dev)
    nan = float("nan")
    count = x.count.long()
    positions = x.positions.long()
    slots = arange(cap, x.deviation)[None, :]
    active_all = slots < count[:, None]
    is_last_all = slots == count[:, None] - 1
    strong_s1_all = (x.flags & STRONG_S1) != 0
    in_recovery_all = (x.flags & IN_RECOVERY) != 0
    fwd_waived_all = (x.flags & FWD_WAIVED) != 0
    hist = p.stability_history_window
    hist_t = torch.tensor(hist, dtype=dtype, device=dev)
    kickstart = cfg.compat.kickstart_effective

    npd = _NP_DTYPE[dtype]
    base_interp = Interp(p.deviation_points, None, dtype, dev)
    sf_interp = Interp((0.0, 1.0), (p.stability_confidence_floor,
                                    p.stability_confidence_ceiling), dtype, dev)
    ratio_interp = Interp((p.contractility_bpm_low, p.contractility_bpm_high),
                          (p.s2_s1_ratio_low_bpm, p.s2_s1_ratio_high_bpm), dtype, dev)
    rhythm_interp = Interp(r.rhythm_dev_points, r.rhythm_conf_curve, dtype, dev)
    amp_interp = Interp(r.amp_ratio_points, r.amp_conf_curve, dtype, dev)
    curve_low = torch.as_tensor(np.asarray(p.curve_low, npd), device=dev)
    curve_span = torch.as_tensor(np.asarray(p.curve_high, npd)
                                 - np.asarray(p.curve_low, npd), device=dev)
    bpm_span = torch.tensor(p.contractility_bpm_high - p.contractility_bpm_low,
                            dtype=dtype, device=dev)

    c = _Carry(
        pending_s2=torch.zeros(bsz, dtype=torch.bool, device=dev),
        belief=x.start_belief.to(dtype).clone(),
        last_pos=torch.full((bsz,), -1, dtype=torch.int64, device=dev),
        prev_pos=torch.full((bsz,), -1, dtype=torch.int64, device=dev),
        last_strength=torch.zeros(bsz, dtype=dtype, device=dev),
        cand_count=torch.zeros(bsz, dtype=torch.int64, device=dev),
        ring=torch.zeros(bsz, hist, dtype=torch.bool, device=dev),
        rejections=torch.zeros(bsz, dtype=torch.int64, device=dev),
        ks_lone=torch.zeros(bsz, 4, dtype=torch.bool, device=dev),
        ks_next_noise=torch.zeros(bsz, 4, dtype=torch.bool, device=dev),
        ks_prev_was_lone=torch.zeros(bsz, dtype=torch.bool, device=dev),
    )
    nan_t = torch.full((bsz,), nan, dtype=dtype, device=dev)
    fields = ClassifierTrace._fields
    ys = {f: [] for f in fields} if want_trace else {"peak_class": []}

    for t in range(cap):
        pos = positions[:, t]
        strength = x.strength[:, t]
        dev_t = x.deviation[:, t]
        active, is_last = active_all[:, t], is_last_all[:, t]
        interval_sec = x.interval_sec[:, t]
        s2s1 = x.s2_s1_ratio[:, t]
        pending = c.pending_s2

        # ---- pairing ratio (bpm_analysis.py:179-186) ----------------------
        ring_mean = c.ring.to(dtype).sum(dim=1) / hist_t
        pairing_ratio = torch.where(c.cand_count < hist,
                                    torch.full_like(ring_mean, 0.5), ring_mean)
        if kickstart:
            matches = (c.ks_lone & c.ks_next_noise).long().sum(dim=1)
            lones = c.ks_lone.long().sum(dim=1)
            fire = ((pairing_ratio < p.kickstart_check_threshold)
                    & (c.cand_count >= 4) & (lones >= 3) & (matches >= 3))
            pairing_ratio = torch.where(fire, torch.full_like(pairing_ratio,
                                                              p.kickstart_override_ratio),
                                        pairing_ratio)

        # ---- pair attempt (bpm_analysis.py:231-272) -----------------------
        blend = torch.clamp((c.belief - p.contractility_bpm_low) / bpm_span, 0, 1)
        curve = curve_low + curve_span * blend[:, None]
        base_conf = base_interp(dev_t, curve)

        # 1. stability pre-adjustment (>= 5 beats)
        sf = sf_interp(pairing_ratio)
        use_sf = c.cand_count >= 5
        conf = torch.where(use_sf, base_conf * sf, base_conf)

        # 2. strength ratio vs expectation
        eff_bpm = torch.where(in_recovery_all[:, t],
                              torch.clamp(c.belief, min=p.contractility_bpm_low), c.belief)
        max_expected = ratio_interp(eff_bpm)
        # 3. penalty / boost
        do_penalty = s2s1 > max_expected
        severity = torch.clamp((s2s1 / max_expected - 1.0) / 2.0, 0, 1)
        penalty = p.penalty_amount_min + severity * (p.penalty_amount_max - p.penalty_amount_min)
        do_boost = ~do_penalty & strong_s1_all[:, t]
        boost = x.boost[:, t]
        conf = torch.where(do_penalty, conf - penalty,
                           torch.where(do_boost, conf + boost, conf))
        # Python max(0.0, min(1.0, nan)) == 1.0 (bpm_analysis.py:1197).
        conf = torch.where(torch.isnan(conf), torch.ones_like(conf),
                           torch.clamp(conf, 0, 1))

        # 4. interval penalty
        max_interval = torch.clamp((60.0 / c.belief) * p.s1_s2_interval_rr_fraction,
                                   max=p.s1_s2_interval_cap_sec)
        pzs = max_interval * p.interval_penalty_start_factor
        pze = max_interval * p.interval_penalty_full_factor
        exceed_i = torch.clamp((interval_sec - pzs) / (pze - pzs + 1e-9), 0, 1)
        ipen = exceed_i * p.interval_max_penalty
        do_ipen = (interval_sec > max_interval) & (interval_sec > pzs)
        if not p.enable_interval_penalty:
            do_ipen = torch.zeros_like(do_ipen)
        conf = torch.where(do_ipen, torch.clamp(conf - ipen, min=0), conf)

        paired = conf >= p.pairing_confidence_threshold

        # ---- lone-S1 validation (bpm_analysis.py:274-329, 1201-1237) ------
        first_beat = c.cand_count == 0
        expected_rr = 60.0 / c.belief
        actual_rr = (pos - c.last_pos).to(dtype) / sr
        rhythm_dev = (actual_rr - expected_rr).abs() / expected_rr
        rhythm_score = rhythm_interp(rhythm_dev)
        amp_ratio = strength / (c.last_strength + 1e-9)
        amp_score = amp_interp(amp_ratio)
        lone_conf = (rhythm_score * r.lone_s1_rhythm_weight
                     + amp_score * r.lone_s1_amplitude_weight)
        conf_ok = lone_conf >= r.lone_s1_confidence_threshold
        min_fwd = expected_rr * r.lone_s1_forward_check_pct
        fwd_fail = (interval_sec < min_fwd) & ~fwd_waived_all[:, t]

        lone_valid = first_beat | (conf_ok & ~fwd_fail)
        lone_reason = torch.where(
            first_beat, types.LONE_FIRST_BEAT,
            torch.where(~conf_ok, types.LONE_REJ_CONFIDENCE,
                        torch.where(fwd_fail, types.LONE_REJ_FORWARD, types.LONE_OK)))

        # cascade reset (bpm_analysis.py:286-302)
        is_rhythm_rej = ~lone_valid & (lone_reason == types.LONE_REJ_CONFIDENCE)
        rej_after = torch.where(is_rhythm_rej, c.rejections + 1, 0)
        cascade = ~lone_valid & (rej_after >= r.cascade_reset_trigger_count)

        # ---- outcome: consumed-S2 > last peak > pair > lone/cascade/noise --
        lone_class = torch.where(lone_valid, types.LONE_S1_VALIDATED,
                                 torch.where(cascade, types.LONE_S1_CASCADE, types.NOISE))
        peak_class = torch.where(
            pending, types.S2_PAIRED,
            torch.where(is_last, types.LONE_S1_LAST,
                        torch.where(paired, types.S1_PAIRED, lone_class)))
        peak_class = torch.where(active, peak_class, types.UNCLASSIFIED)

        processed = active & ~pending
        appended = processed & (is_last | paired | (lone_valid | cascade))
        appended_paired_flag = processed & ~is_last & paired

        new_last = torch.where(appended, pos, c.last_pos)
        new_prev = torch.where(appended, c.last_pos, c.prev_pos)
        new_last_strength = torch.where(appended, strength, c.last_strength)
        new_count = c.cand_count + appended.long()
        shifted_ring = torch.cat([c.ring[:, 1:], appended_paired_flag[:, None]], dim=1)
        new_ring = torch.where(appended[:, None], shifted_ring, c.ring)
        new_rej = torch.where(
            processed & ~is_last,
            torch.where(paired | lone_valid | cascade, 0, rej_after),
            c.rejections)

        # ---- belief update (once per loop iteration; bpm_analysis.py:203-212)
        rr_new = (new_last - new_prev).to(dtype) / sr
        can_update = processed & (new_count > 1) & (new_prev >= 0) & (rr_new > 0)
        instant = 60.0 / rr_new
        target = (1 - r.belief_learning_rate) * c.belief + r.belief_learning_rate * instant
        max_change = r.belief_max_change_per_beat * rr_new
        change = torch.minimum(torch.maximum(target - c.belief, -max_change), max_change)
        updated = torch.clamp(c.belief + change, r.min_bpm, r.max_bpm)
        new_belief = torch.where(can_update, updated, c.belief)

        ys["peak_class"].append(peak_class)
        if want_trace:
            belief_time = torch.where(processed & (new_count > 0),
                                      new_last.to(dtype) / sr, nan_t)
            step = dict(
                deviation=dev_t, blend_ratio=blend, base_conf=base_conf,
                pairing_ratio=pairing_ratio,
                stability_factor=torch.where(use_sf, sf, nan_t),
                s2_s1_ratio=s2s1, max_expected_ratio=max_expected,
                penalty_amount=torch.where(do_penalty, penalty, nan_t),
                boost_amount=torch.where(do_boost, boost, nan_t),
                s1_s2_ratio=x.s1_s2_ratio[:, t], interval_sec=interval_sec,
                max_interval_sec=max_interval,
                interval_penalty=torch.where(do_ipen, ipen, nan_t),
                final_conf=conf, paired=paired, lone_reason=lone_reason,
                lone_conf=lone_conf, rhythm_score=rhythm_score,
                actual_rr_sec=actual_rr, expected_rr_sec=expected_rr,
                amp_score=amp_score, amp_ratio=amp_ratio,
                implied_bpm=x.implied_bpm[:, t], belief=new_belief,
                belief_time_sec=belief_time)
            for k, v in step.items():
                ys[k].append(v)

        next_pending = processed & ~is_last & paired
        if kickstart:
            appended_lone = appended & ~appended_paired_flag
            is_noise_step = processed & ~is_last & ~paired & ~lone_valid & ~cascade
            marked = c.ks_next_noise.clone()
            marked[:, -1] = marked[:, -1] | (is_noise_step & c.ks_prev_was_lone)
            ks_lone = torch.where(
                appended[:, None],
                torch.cat([c.ks_lone[:, 1:], appended_lone[:, None]], dim=1), c.ks_lone)
            ks_next_noise = torch.where(
                appended[:, None],
                torch.cat([marked[:, 1:], torch.zeros_like(marked[:, :1])], dim=1),
                marked)
            ks_prev_was_lone = torch.where(processed, appended_lone, c.ks_prev_was_lone)
        else:
            ks_lone, ks_next_noise = c.ks_lone, c.ks_next_noise
            ks_prev_was_lone = c.ks_prev_was_lone
        c = _Carry(next_pending, new_belief, new_last, new_prev, new_last_strength,
                   new_count, new_ring, new_rej, ks_lone, ks_next_noise,
                   ks_prev_was_lone)

    stacked = {k: torch.stack(v, dim=1) for k, v in ys.items()}
    peak_class = stacked["peak_class"].to(torch.int32)
    if not want_trace:
        return peak_class, None
    stacked["peak_class"] = peak_class
    stacked["lone_reason"] = stacked["lone_reason"].to(torch.int32)
    return peak_class, ClassifierTrace(**stacked)


def _interp_table(interp: Interp, fp=None) -> np.ndarray:
    """One Interp's row of the classify kernel's table (``enum Table``), in float64
    holding values of the working dtype.  ``fp`` (low, span) replaces the
    constant values for the base interp, whose values vary with the belief."""
    row = np.zeros(classify_kernel.TABLE_WIDTH)
    k = interp.k
    if not 2 <= k <= classify_kernel.MAX_KNOTS:
        raise ValueError(f"the classify kernel takes 2-{classify_kernel.MAX_KNOTS} interp "
                         f"knots, got {k}")
    xp = interp.xp_t.cpu().numpy()
    if not (np.diff(xp) >= 0).all():
        raise ValueError(f"the classify kernel's segment count needs sorted knots, got {xp}")
    table = interp.table.cpu().numpy().astype(np.float64)
    row[0] = k
    row[1:1 + k] = xp
    row[9:9 + k - 1] = table[1]
    if interp.dx0 is not None:
        row[17:17 + k - 1] = interp.dx0.cpu().numpy()
    if fp is None:
        row[25:25 + k - 1] = table[2]
        row[33:33 + k - 1] = table[3]
        row[41], row[42] = interp.f_ends
    else:
        low, span = fp
        row[25:25 + k] = low
        row[33:33 + k] = span
    return row


def kernel_constants(sample_rate: int, cfg, dtype: torch.dtype):
    """(float table, int table) for the classify kernel, as numpy arrays: the
    scalars of its ``enum Const`` and the five Interp tables, every float
    rounded to the working dtype exactly as :func:`scan_plain` rounds the
    Python number at its operation (the Interp tables taken from
    :class:`Interp` itself); the codes of its ``enum Int``, from ``types``."""
    p, r = cfg.pairing, cfg.rhythm
    npd = _NP_DTYPE[dtype]
    scalars = [
        sample_rate, p.stability_history_window, 0.5, p.kickstart_check_threshold,
        p.kickstart_override_ratio, p.contractility_bpm_low,
        p.contractility_bpm_high - p.contractility_bpm_low, p.penalty_amount_min,
        p.penalty_amount_max - p.penalty_amount_min, 1.0, 2.0, 60.0,
        p.s1_s2_interval_rr_fraction, p.s1_s2_interval_cap_sec,
        p.interval_penalty_start_factor, p.interval_penalty_full_factor, 1e-9,
        p.interval_max_penalty, p.pairing_confidence_threshold, r.lone_s1_rhythm_weight,
        r.lone_s1_amplitude_weight, r.lone_s1_confidence_threshold,
        r.lone_s1_forward_check_pct, 1 - r.belief_learning_rate, r.belief_learning_rate,
        r.belief_max_change_per_beat, r.min_bpm, r.max_bpm, 0.0, float("nan")]
    head = np.zeros(classify_kernel.SCALARS)
    head[:len(scalars)] = np.asarray(scalars, np.float64).astype(npd)

    def interp(xp, fp):
        return Interp(xp, fp, dtype, "cpu")

    curve_low = np.asarray(p.curve_low, npd)
    curve_span = np.asarray(p.curve_high, npd) - curve_low
    tables = [
        _interp_table(interp(p.deviation_points, None), fp=(curve_low, curve_span)),
        _interp_table(interp((0.0, 1.0), (p.stability_confidence_floor,
                                          p.stability_confidence_ceiling))),
        _interp_table(interp((p.contractility_bpm_low, p.contractility_bpm_high),
                             (p.s2_s1_ratio_low_bpm, p.s2_s1_ratio_high_bpm))),
        _interp_table(interp(r.rhythm_dev_points, r.rhythm_conf_curve)),
        _interp_table(interp(r.amp_ratio_points, r.amp_conf_curve)),
    ]
    floats = np.concatenate([head, *tables]).astype(npd)
    hist = p.stability_history_window
    if not 1 <= hist <= classify_kernel.MAX_HIST:
        raise ValueError(f"the classify kernel keeps a ring of 1-{classify_kernel.MAX_HIST} "
                         f"slots, got {hist}")
    ints = np.asarray([
        types.UNCLASSIFIED, types.S1_PAIRED, types.S2_PAIRED, types.LONE_S1_VALIDATED,
        types.LONE_S1_CASCADE, types.LONE_S1_LAST, types.NOISE, types.LONE_OK,
        types.LONE_FIRST_BEAT, types.LONE_REJ_CONFIDENCE, types.LONE_REJ_FORWARD,
        hist, r.cascade_reset_trigger_count, int(p.enable_interval_penalty)], np.int32)
    return floats, ints


def constant_divisors(sample_rate: int, cfg) -> np.ndarray:
    """The float32 constant divisors of the classify kernel's chain, which
    ``classify_kernel.division_mismatches`` takes: the BPM span, the
    sample rate, 2 and the dx of each segment of the three interps on the
    chain (ratio, rhythm, amplitude)."""
    floats, _ = kernel_constants(sample_rate, cfg, torch.float32)
    out = [floats[6], floats[0], floats[10]]                # C_BPM_SPAN, C_SR, C_TWO
    width = classify_kernel.TABLE_WIDTH
    for which in (2, 3, 4):                                  # I_RATIO, I_RHYTHM, I_AMP
        row = floats[classify_kernel.SCALARS + which * width:][:width]
        k = int(row[0])
        out += [dx for dx, dx0 in zip(row[9:9 + k - 1], row[17:17 + k - 1]) if not dx0]
    return np.asarray(out, np.float32)


def classify_scan(x: ScanInputs, n: int, sample_rate: int, cfg: AnalyzerConfig,
                  want_trace: bool = True):
    """(peak_class (B, capacity) int32, the trace or None) of the
    carry-dependent loop over ``x``, whose positions lie in [0, n]: the CUDA
    kernel ``csrc/classify_scan.cu`` for CUDA tensors, with its constant
    tables built once a configuration and kept on the card, and
    :func:`scan_plain` for CPU tensors."""
    dev = x.deviation.device
    if dev.type == "cpu":
        return scan_plain(x, sample_rate, cfg, want_trace=want_trace)
    dtype = x.deviation.dtype
    key = (sample_rate, cfg, dtype, str(dev))
    if key not in _kernel_tables:
        if len(_kernel_tables) >= 16:
            _kernel_tables.pop(next(iter(_kernel_tables)))
        floats, ints = kernel_constants(sample_rate, cfg, dtype)
        _kernel_tables[key] = (torch.as_tensor(floats, device=dev),
                               torch.as_tensor(ints, device=dev))
    consts, codes = _kernel_tables[key]
    peak_class, lone_reason, paired, fields = classify_kernel.classify_scan(
        x, n, consts, codes, cfg.compat.kickstart_effective, want_trace=want_trace)
    if not want_trace:
        return peak_class, None
    traced = dict(zip(classify_kernel.KERNEL_FIELDS, fields))
    traced.update({f: getattr(x, f) for f in SLOT_FIELDS})
    return peak_class, ClassifierTrace(peak_class=peak_class, paired=paired,
                                       lone_reason=lone_reason, **traced)


def classify(
    envelope: torch.Tensor,
    floor: torch.Tensor,
    positions: torch.Tensor,
    count: torch.Tensor,
    sample_rate: int,
    start_bpm: torch.Tensor,
    cfg: AnalyzerConfig,
    peak_bpm_time_sec=None,
    recovery_end_time_sec=None,
    want_trace: bool = True,
) -> ClassifierResult:
    """Run the classification over the raw-peak slots of every row.
    ``want_trace=False`` keeps only ``peak_class`` (the preliminary pass)."""
    p = cfg.pairing
    r = cfg.rhythm
    dtype = envelope.dtype
    dev = envelope.device
    bsz, n = envelope.shape
    cap = positions.shape[1]
    sr = upload("sample_rate", sample_rate, dtype, dev)
    nan = float("nan")
    count = count.long()

    smoothed_dev, strengths = deviation_series(envelope, floor, positions, count, cfg)
    # Deviation seen by slot t's pair attempt: the (t-1, t) midpoint value.
    dev_at_slot = torch.cat([torch.full((bsz, 1), nan, dtype=dtype, device=dev),
                             smoothed_dev], dim=1)

    positions = positions.long()
    env_at = take(envelope, torch.clamp(positions, 0, n - 1))
    times = positions.to(dtype) / sr
    pos_next = torch.cat([positions[:, 1:], torch.full((bsz, 1), n, dtype=torch.int64,
                                                       device=dev)], dim=1)
    env_next = torch.cat([env_at[:, 1:], env_at[:, -1:]], dim=1)
    strength_next = torch.cat([strengths[:, 1:], strengths[:, -1:]], dim=1)

    if peak_bpm_time_sec is not None and recovery_end_time_sec is not None:
        rec_lo = peak_bpm_time_sec.to(dtype)[:, None]
        rec_hi = recovery_end_time_sec.to(dtype)[:, None]
        rec_valid = ~(torch.isnan(rec_lo) | torch.isnan(rec_hi))
    else:
        rec_lo = rec_hi = torch.zeros(bsz, 1, dtype=dtype, device=dev)
        rec_valid = torch.zeros(bsz, 1, dtype=torch.bool, device=dev)

    # ---- slot-only terms, for every slot at once -----------------------------
    interval_all = (pos_next - positions).to(dtype) / sr
    s2s1_all = strength_next / (strengths + 1e-9)
    s1s2_all = strengths / (strength_next + 1e-9)
    strong_s1_all = strengths > strength_next * p.s1_s2_boost_ratio
    exceed_all = torch.clamp((s1s2_all - p.s1_s2_boost_ratio)
                             / (p.boost_saturation_ratio - p.s1_s2_boost_ratio), 0, 1)
    boost_all = p.boost_amount_min + exceed_all * (p.boost_amount_max - p.boost_amount_min)
    in_recovery_all = rec_valid & (rec_lo < times) & (times < rec_hi)
    fwd_waived_all = env_at > env_next * r.forward_check_amp_waiver
    implied_all = torch.where(interval_all > 0, 60.0 / interval_all,
                              torch.full_like(interval_all, float("inf")))

    flags = (strong_s1_all.to(torch.uint8) * STRONG_S1
             | in_recovery_all.to(torch.uint8) * IN_RECOVERY
             | fwd_waived_all.to(torch.uint8) * FWD_WAIVED)
    inputs = ScanInputs(
        positions=positions.to(torch.int32), count=count.to(torch.int32),
        start_belief=start_bpm.to(dtype).contiguous(), deviation=dev_at_slot,
        interval_sec=interval_all, s2_s1_ratio=s2s1_all, s1_s2_ratio=s1s2_all,
        strength=strengths.contiguous(), boost=boost_all, implied_bpm=implied_all,
        flags=flags)
    peak_class, trace = classify_scan(inputs, n, sample_rate, cfg, want_trace=want_trace)

    is_beat = ((peak_class == types.S1_PAIRED)
               | (peak_class == types.LONE_S1_VALIDATED)
               | (peak_class == types.LONE_S1_CASCADE)
               | (peak_class == types.LONE_S1_LAST))
    ccap = cfg.runtime.max_candidates
    key = torch.where(is_beat, positions, n)
    if ccap > cap:
        key = torch.cat([key, torch.full((bsz, ccap - cap), n, dtype=key.dtype,
                                         device=dev)], dim=1)
    s1_positions = torch.sort(key, dim=1).values[:, :ccap].to(torch.int32)
    n_beats = is_beat.long().sum(dim=1)
    return ClassifierResult(
        s1_positions=s1_positions,
        s1_count=torch.clamp(n_beats, max=ccap).to(torch.int32),
        trace=trace,
        smoothed_deviation=smoothed_dev,
        s1_overflowed=n_beats > ccap,
    )
