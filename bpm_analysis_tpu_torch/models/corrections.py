"""Post-classification correction passes (reference stages 4 & 5), batched.

Port of ``bpm_analysis_tpu/models/corrections.py``.

Stage 4 — ``correct_peaks_by_rhythm`` (bpm_analysis.py:1257-1306): greedy
left-to-right conflict resolution against the median RR; sequential by
construction, so a scan over candidate slots carrying the last accepted
peak (per row), :func:`rhythm_scan`: the CUDA kernel
``csrc/rhythm_scan.cu`` on the card, its plain version
:func:`rhythm_scan_plain` on the CPU.  Skipped for < 5 peaks.

Stage 5 — ``_fix_rhythmic_discontinuities`` (bpm_analysis.py:1309-1412),
iterated until an iteration corrects nothing, at most ``max_iterations``
times: pass 1 promotes the first qualifying Noise pair inside each long
gap; pass 2 removes the weaker of too-close adjacent beats (closed form).
The batch iterates until every row has converged; a converged row passes
through unchanged, exactly as the JAX ``while_loop`` under ``vmap``.  One
host read per iteration decides whether to go on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AnalyzerConfig
from ..device import upload
from ..ops import series
from ..ops.cuda import rhythm_kernel
from ..ops.find_peaks import compact_slots
from ..ops.indexing import arange, scatter_drop, take
from .. import types
from ..utils.profiling import host_read, span


class CorrectionResult(NamedTuple):
    positions: torch.Tensor       # (B, max_candidates) int32 final S1 peaks
    count: torch.Tensor           # (B,) int32
    classes: torch.Tensor         # (B, max_raw_peaks) int32 updated classes
    precorrection_classes: torch.Tensor
    overflowed: torch.Tensor      # (B,) bool


def rhythm_scan_plain(pos: torch.Tensor, amp: torch.Tensor, count: torch.Tensor,
                      threshold: torch.Tensor, sample_rate: int):
    """Stage 4's greedy scan, one step per slot for every row at once: the
    plain version of ``csrc/rhythm_scan.cu``.  Carries the last kept slot,
    position and amplitude per row; returns (written (B, cap) bool, victim
    (B, cap) int32: the slot each one unseated, or cap)."""
    bsz, cap = pos.shape
    dtype = amp.dtype
    sr = torch.tensor(sample_rate, dtype=dtype, device=amp.device)
    pos = pos.long()
    valid = arange(cap, pos)[None, :] < count.long()[:, None]
    last_slot = torch.zeros(bsz, dtype=torch.int64, device=pos.device)
    last_pos, last_amp = pos[:, 0], amp[:, 0]
    written, victim = [], []
    for i in range(cap):
        p, a, v = pos[:, i], amp[:, i], valid[:, i]
        interval = (p - last_pos).to(dtype) / sr
        act = v & (i > 0)
        conflict = act & (interval < threshold)
        replace = conflict & (a > last_amp)
        w = act & ~(conflict & ~replace)              # drop: skip
        victim.append(torch.where(replace, last_slot, cap))
        written.append(w)
        last_slot = torch.where(w, i, last_slot)
        last_pos = torch.where(w, p, last_pos)
        last_amp = torch.where(w, a, last_amp)
    return torch.stack(written, dim=1), torch.stack(victim, dim=1).to(torch.int32)


def rhythm_scan(pos: torch.Tensor, amp: torch.Tensor, count: torch.Tensor,
                threshold: torch.Tensor, n: int, sample_rate: int):
    """Stage 4's greedy scan (:func:`rhythm_scan_plain`'s result) over
    positions in [0, n]: the CUDA kernel ``csrc/rhythm_scan.cu`` for CUDA
    tensors, :func:`rhythm_scan_plain` for CPU tensors."""
    if amp.device.type == "cpu":
        return rhythm_scan_plain(pos, amp, count, threshold, sample_rate)
    return rhythm_kernel.rhythm_scan(pos, amp, count, threshold, n, sample_rate)


def rhythm_correction(positions: torch.Tensor, count: torch.Tensor,
                      envelope: torch.Tensor, sample_rate: int,
                      cfg: AnalyzerConfig):
    """Stage 4.  Returns (positions, count) with conflicts resolved."""
    bsz, cap = positions.shape
    n = envelope.shape[1]
    dtype = envelope.dtype
    sr = upload("sample_rate", sample_rate, dtype, envelope.device)
    count = count.long()
    slot = arange(cap, positions)[None, :]
    valid = slot < count[:, None]
    pos = torch.where(valid, positions.long(), n)
    amp = take(envelope, torch.clamp(pos, 0, n - 1))

    rr = (pos[:, 1:] - pos[:, :-1]).to(dtype) / sr
    rr_valid = slot[:, :-1] < count[:, None] - 1
    median_rr = series.masked_median(rr, rr_valid)
    threshold = median_rr * cfg.correction.rr_correction_threshold_pct

    written, victim = rhythm_scan(pos.to(torch.int32), amp.contiguous(),
                                  count.to(torch.int32), threshold.contiguous(), n,
                                  sample_rate)
    written[:, 0] = count > 0
    unseated = scatter_drop(cap, victim, True, False, torch.bool)
    kept = written & ~unseated
    out_pos, out_len = series.compact_valid(pos, kept, fill=n)

    # Reference skips correction entirely for < 5 peaks (bpm_analysis.py:1263).
    skip = count < 5
    final_pos = torch.where(skip[:, None], positions.long(), out_pos)
    final_count = torch.where(skip, count, out_len.long())
    return final_pos.to(torch.int32), final_count.to(torch.int32)


def _static_candidates(raw_pos, raw_count, noise_flag, envelope, floor,
                       capacity: int, cfg: AnalyzerConfig):
    """Loop-invariant promotion candidates of the raw-peak list (noise flag
    sticky, raw list fixed), compacted to ``capacity`` slots.  Returns
    (cand_rslot, cand_pos, cand_next, count, overflowed)."""
    c = cfg.correction
    bsz, rcap = raw_pos.shape
    n = envelope.shape[1]
    rslot = arange(rcap, raw_pos)[None, :].expand(bsz, rcap)
    rvalid = rslot < raw_count.long()[:, None]
    rpos = torch.where(rvalid, raw_pos.long(), n)
    rpos_c = torch.clamp(rpos, 0, n - 1)
    next_rpos = torch.cat([rpos[:, 1:], torch.full_like(rpos[:, :1], n)], dim=1)
    has_next = rslot + 1 < raw_count.long()[:, None]
    next_noise = torch.cat([noise_flag[:, 1:], torch.zeros_like(noise_flag[:, :1])], dim=1)
    env_r = take(envelope, rpos_c)
    floor_r = take(floor, rpos_c)
    s1_strength = torch.clamp(env_r - floor_r, min=0)
    strong = s1_strength > c.penalty_waiver_strength_ratio * floor_r
    next_rpos_c = torch.clamp(next_rpos, 0, n - 1)
    ratio_ok = (take(envelope, next_rpos_c) / (env_r + 1e-9)
                < c.penalty_waiver_max_s2_s1_ratio)
    cand = rvalid & noise_flag & has_next & next_noise & strong & ratio_ok
    (cand_rslot, cand_pos, cand_next), count, over = compact_slots(
        cand, capacity, [(rslot, rcap), (rpos, n), (next_rpos, n)])
    return cand_rslot, cand_pos, cand_next, count, over


def rr_padded(rr: torch.Tensor, cap: int) -> torch.Tensor:
    inf = torch.full_like(rr[:, :1], float("inf"))
    return torch.cat([rr, inf], dim=1)[:, :cap]


def _fix_iteration(s1_pos, s1_count, cand, rcap: int, classes,
                   envelope, floor, sample_rate, cfg: AnalyzerConfig):
    """One iteration of stage 5 over every row.  Returns updated (s1_pos,
    s1_count, classes, corrections_made, overflowed)."""
    c = cfg.correction
    bsz, cap = s1_pos.shape
    n = envelope.shape[1]
    dtype = envelope.dtype
    dev = envelope.device
    sr = upload("sample_rate", sample_rate, dtype, dev)
    margin = c.margin_beats
    s1_count = s1_count.long()
    cnt = s1_count[:, None]

    slot = arange(cap, s1_pos)[None, :]
    valid = slot < cnt
    pos = torch.where(valid, s1_pos.long(), n)
    enough = s1_count >= margin * 2

    rr = (pos[:, 1:] - pos[:, :-1]).to(dtype) / sr
    rr_valid = slot[:, :-1] < cnt - 1

    # One sort serves q1, q3 and the IQR-filtered median (the stable subset
    # is a contiguous run of the sorted valid prefix).
    big = torch.finfo(dtype).max
    s = torch.sort(torch.where(rr_valid, rr, torch.full_like(rr, big)), dim=1).values
    nvr = rr_valid.long().sum(dim=1)

    def q_at(qv, m, offset):
        p = qv * torch.clamp(m - 1, min=0).to(dtype)
        top = torch.clamp(m - 1, min=0)
        lo = torch.minimum(torch.clamp(torch.floor(p).long(), min=0), top)
        hi = torch.minimum(torch.clamp(torch.ceil(p).long(), min=0), top)
        frac = p - lo.to(dtype)
        out = take(s, offset + lo) * (1 - frac) + take(s, offset + hi) * frac
        return torch.where(m > 0, out, torch.full_like(out, float("nan")))

    zero = torch.zeros_like(nvr)
    q1 = q_at(0.25, nvr, zero)
    q3 = q_at(0.75, nvr, zero)
    iqr = q3 - q1
    lo_b, hi_b = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    a = (rr_valid & (rr <= lo_b[:, None])).long().sum(dim=1)
    m = (rr_valid & (rr < hi_b[:, None])).long().sum(dim=1) - a
    any_stable = m >= 1
    median_rr = q_at(0.5, m, a)
    short_thresh = median_rr * c.rr_correction_threshold_pct
    long_thresh = median_rr * c.rr_correction_long_interval_pct
    active = enough & any_stable

    # ---- pass 1: promote noise pairs inside long gaps ---------------------
    gap_in_margin = (slot >= margin) & (slot < cnt - 1 - margin)
    gap_long = gap_in_margin & (rr_padded(rr, cap) > long_thresh[:, None])

    cand_rslot, cand_pos, cand_next, cand_count, _ = cand
    ccap = cand_pos.shape[1]
    cslot = arange(ccap, cand_pos)[None, :]
    cvalid = cslot < cand_count.long()[:, None]

    gap_of = torch.searchsorted(pos, cand_pos.long(), right=True) - 1
    gap_of_c = torch.clamp(gap_of, 0, cap - 1)
    next_s1 = take(pos, torch.clamp(gap_of_c + 1, max=cap - 1))
    in_gap = (gap_of >= 0) & (cand_pos > take(pos, gap_of_c)) & (cand_pos < next_s1)
    s2_in_gap = cand_next < next_s1
    cand_ok = (active[:, None] & cvalid & in_gap & take(gap_long, gap_of_c) & s2_in_gap)

    # First qualifying candidate per gap (segmented min over candidate slots).
    first_per_gap = torch.full((bsz, cap), ccap, dtype=torch.int64, device=dev)
    first_per_gap.scatter_reduce_(
        1, gap_of_c, torch.where(cand_ok, cslot, ccap).expand(bsz, ccap),
        reduce="amin", include_self=True)
    promoted_gap = gap_long & (first_per_gap < ccap)
    promoted_cslot = torch.where(promoted_gap, first_per_gap, ccap)
    promoted_s1_rslot = torch.where(
        promoted_gap, take(cand_rslot, torch.clamp(promoted_cslot, 0, ccap - 1)), rcap)
    promote_mask_s1 = scatter_drop(rcap, promoted_s1_rslot, True, False, torch.bool)
    promote_mask_s2 = torch.cat([torch.zeros_like(promote_mask_s1[:, :1]),
                                 promote_mask_s1[:, :-1]], dim=1)

    n_promoted = promoted_gap.long().sum(dim=1)
    classes = torch.where(promote_mask_s1, types.S1_CORRECTED_GAP, classes)
    classes = torch.where(promote_mask_s2, types.S2_CORRECTED_GAP, classes)

    # Merge promoted S1 positions (raw peak positions: the final beats stay a
    # subset of the NMS-spaced raw peaks, which analytics relies on) into
    # the S1 list in closed form: a promotion in gap g lands right after
    # pos[g].
    prom_csum = torch.cumsum(promoted_gap.long(), dim=1)
    prom_before = torch.cat([torch.zeros_like(prom_csum[:, :1]), prom_csum[:, :-1]], dim=1)
    merged_count = s1_count + n_promoted
    overflowed = active & (merged_count > cap)
    merged_count = torch.clamp(merged_count, max=cap)
    slot_a = torch.where(valid, slot + prom_before, cap + 1)
    prom_pos = take(cand_pos.long(), torch.clamp(promoted_cslot, 0, ccap - 1))
    slot_b = torch.where(promoted_gap, slot + prom_csum, cap + 1)
    merged = scatter_drop(cap + 1, slot_a, pos, n, pos.dtype)
    merged = torch.cat([merged, merged[:, :1]], dim=1)
    merged = merged.scatter(1, torch.where(slot_b > cap, cap + 1, slot_b),
                            prom_pos)[:, :cap]
    merged = torch.where(slot < merged_count[:, None], merged, n)

    # ---- pass 2: remove the weaker of too-close adjacent beats ------------
    mvalid = slot < merged_count[:, None]
    mpos = torch.where(mvalid, merged, n)
    mamp = take(envelope, torch.clamp(mpos, 0, n - 1))
    mnext = torch.clamp(slot + 1, max=cap - 1).expand(bsz, cap)
    in_range = active[:, None] & (slot >= margin) & (slot < merged_count[:, None] - 1 - margin)
    interval = (take(mpos, mnext) - mpos).to(dtype) / sr
    C = in_range & (interval < short_thresh[:, None])
    E = ~(take(mamp, mnext) > mamp)
    ce = C & E
    slot_b2 = slot.expand(bsz, cap)
    last_non_ce = torch.cummax(torch.where(~ce, slot_b2, -1), dim=1).values
    prev_non_ce = torch.cat([torch.full_like(last_non_ce[:, :1], -1),
                             last_non_ce[:, :-1]], dim=1)
    rm_b = ce & (((slot - prev_non_ce) & 1) == 1)
    rm_b_prev = torch.cat([torch.zeros_like(rm_b[:, :1]), rm_b[:, :-1]], dim=1)
    conflicts = C & ~rm_b_prev
    rm_a = conflicts & ~E
    removed = rm_a | rm_b_prev
    n_removed = conflicts.long().sum(dim=1)

    keep = mvalid & ~removed
    out_pos, out_count = series.compact_valid(mpos, keep, fill=n)

    corrections = torch.where(active, n_promoted + n_removed, 0)
    out_pos = torch.where(active[:, None], out_pos, s1_pos.long())
    out_count = torch.where(active, out_count.long(), s1_count)
    return (out_pos.to(torch.int32), out_count.to(torch.int32),
            classes.to(torch.int32), corrections, overflowed)


def refine_and_correct(s1_pos, s1_count, raw_pos, raw_count, classes,
                       envelope, floor, sample_rate, cfg: AnalyzerConfig
                       ) -> CorrectionResult:
    """Stages 4 + 5 (reference ``_refine_and_correct_peaks``,
    bpm_analysis.py:1655-1698).  Every position returned is a member of
    ``raw_pos``: corrections only drop peaks or promote existing raw
    peaks."""
    s1_pos = s1_pos.to(torch.int32)
    s1_count = s1_count.to(torch.int32)
    classes = classes.to(torch.int32)
    precorrection = classes
    bsz = s1_pos.shape[0]
    if not cfg.correction.enable_correction_pass:
        return CorrectionResult(s1_pos, s1_count, classes, precorrection,
                                torch.zeros(bsz, dtype=torch.bool, device=s1_pos.device))

    pos, count = rhythm_correction(s1_pos, s1_count, envelope, sample_rate, cfg)

    # "Noise" substring flag: NOISE class now; sticky through promotions.
    noise_flag = classes == types.NOISE
    rcap = raw_pos.shape[1]
    *cand_arrays, cand_count, cand_over = _static_candidates(
        raw_pos, raw_count, noise_flag, envelope, floor, s1_pos.shape[1], cfg)
    cand = (*cand_arrays, cand_count, cand_over)

    still_active = torch.ones(bsz, dtype=torch.bool, device=s1_pos.device)
    ovf = torch.zeros_like(still_active)
    for _ in range(cfg.correction.max_iterations):
        if not host_read("fix", still_active.any()):      # one host read per iteration
            break
        with span("bpm.fix.round"):
            new_pos, new_count, new_classes, corrections, new_ovf = _fix_iteration(
                pos, count, cand, rcap, classes, envelope, floor, sample_rate, cfg)
        take_ = still_active
        pos = torch.where(take_[:, None], new_pos, pos)
        count = torch.where(take_, new_count, count)
        classes = torch.where(take_[:, None], new_classes, classes)
        ovf = ovf | (take_ & new_ovf)
        still_active = still_active & (corrections > 0)
    return CorrectionResult(pos, count, classes, precorrection, ovf | cand_over)
