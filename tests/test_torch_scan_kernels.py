"""The two scan kernels' per-thread loops, emulated in numpy scalars on the
CPU and held bit for bit against their plain versions.

The kernels run only on a card (tests/test_torch_cuda.py).  These tests keep
their arithmetic checkable here: each emulation walks one recording's slots
as the kernel does, with np.float32 / np.float64 scalars, the kernel's
constant tables (``classifier.kernel_constants``), a 64-bit mask for the
20-slot paired ring and 4-bit masks for the kick-start rings and
NaN-propagating clamp / maximum / minimum.  The classifier's emulation
follows its block's design: per chunk of 64 slots, the helper warps'
slot-only precompute (the base interp's segment rows and quotient, the slot
bits), the chain over that ring with the pairing-ratio and stability tables
computed once, Interp's segment as a count of the knots not greater than x
(on the chain, of the interior knots), both candidate belief updates before
the decision with the last appended slots' quotients carried, and the trace
staged per chunk, then flushed.  Its divisions by a constant are IEEE here; the card
holds the kernel's fast path for them against IEEE division
(tests/test_torch_cuda.py).

* ``csrc/classify_scan.cu`` against ``models/classifier.scan_plain``: all
  26 trace fields and the classes (NaN equal to NaN), float32 and float64,
  with and without the trace, kick-start on and off, on rows with 0, 1, 2
  and 4 peaks, a row at full capacity and NaN recovery bounds.
* ``csrc/rhythm_scan.cu`` against ``models/corrections.rhythm_scan_plain``:
  ``written`` and ``victim``, float32 and float64, on
  ``chip_smoke.rhythm_cases`` (the card's cases).  The emulation follows
  the kernel's block: the integer threshold d* by warp 0's rounds of 32
  candidates (held against a brute-force scan of every distance), tiles of
  2048 slots with the sorted vote and the carry handed from tile to tile,
  runs owned by the 128 threads' chunks with each slot written by exactly
  one thread, and an unsorted tile's single chain.

The inputs come from the port's own pipeline on 60 s synthetic recordings at
302 Hz with 512 raw-peak slots (as tests/test_torch_classifier.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu_torch import synth
from bpm_analysis_tpu_torch.config import DEFAULT_CONFIG
from bpm_analysis_tpu_torch.models import classifier as tcls
from bpm_analysis_tpu_torch.models import corrections as tcorr
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import noise_floor as tnf
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.ops import find_peaks as tfp
from bpm_analysis_tpu_torch.kernels import build
from bpm_analysis_tpu_torch.ops.cuda import classify_kernel
from bpm_analysis_tpu_torch import types

torch.set_num_threads(1)

SR = 302
SEEDS = (0, 1, 2, 3)
TRUNCATED = (0, 1, 2, 4)      # rows of seed 0 cut to this many raw peaks

# Offsets of the kernel's enums (csrc/classify_scan.cu).
(C_SR, C_HIST, C_HALF, C_KICK_THR, C_KICK_OVR, C_BPM_LOW, C_BPM_SPAN, C_PEN_MIN,
 C_PEN_SPAN, C_ONE, C_TWO, C_SIXTY, C_RR_FRAC, C_IVL_CAP, C_PZS, C_PZE, C_EPS,
 C_IPEN_MAX, C_PAIR_THR, C_W_RHYTHM, C_W_AMP, C_LONE_THR, C_FWD_PCT,
 C_ONE_MINUS_LR, C_LR, C_MAX_CHANGE, C_MIN_BPM, C_MAX_BPM, C_ZERO, C_NAN) = range(30)
T_K, T_XP, T_DX, T_DX0, T_FLO, T_DF, T_FIRST, T_LAST = 0, 1, 9, 17, 25, 33, 41, 42
I_BASE, I_SF, I_RATIO, I_RHYTHM, I_AMP = range(5)
(K_UNCLASSIFIED, K_S1_PAIRED, K_S2_PAIRED, K_LONE_VALIDATED, K_LONE_CASCADE,
 K_LONE_LAST, K_NOISE, K_LONE_OK, K_LONE_FIRST, K_LONE_REJ_CONF, K_LONE_REJ_FWD,
 K_HIST, K_CASCADE, K_ENABLE_IPEN) = range(14)


def _config(dtype: str, kickstart: bool = False):
    return dataclasses.replace(
        DEFAULT_CONFIG,
        runtime=dataclasses.replace(DEFAULT_CONFIG.runtime, max_raw_peaks=512,
                                    max_troughs=512, max_candidates=256,
                                    noise_quantile_stride=64, quantile_backend="knots",
                                    dtype=dtype),
        compat=dataclasses.replace(DEFAULT_CONFIG.compat, kickstart_effective=kickstart))


_CACHE = {}
_CORRECTION = {}


def _captured(dtype: str):
    """(classifier ScanInputs, (pos, amp, count, threshold) of the rhythm
    scan, n) from the port's pipeline on the test batch, on the CPU: seeds
    0-3, then seed 0 cut to 0, 1, 2 and 4 raw peaks; the recovery window of
    row 1 is NaN."""
    if dtype in _CACHE:
        return _CACHE[dtype]
    cfg = _config(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.float64
    x = np.stack([synth._quantize_int16(synth.synth_recording(s)[:SR * 60])
                  for s in SEEDS]).astype(dtype)
    env = tenv.preprocess(x, SR, cfg, device="cpu")[0]
    ext = tfp.build_extrema(env, cfg.runtime.find_peaks_work_factor * cfg.runtime.max_raw_peaks)
    nf = tnf.dynamic_noise_floor(env, SR, cfg, extrema=ext)
    peaks = tpipe.raw_peaks(env, nf.floor, SR, cfg, extrema=ext)
    n = env.shape[1]
    rows = list(range(len(SEEDS))) + [0] * len(TRUNCATED)
    env, floor = env[rows], nf.floor[rows]
    pos, count = peaks.positions[rows].clone(), peaks.count[rows].clone()
    for i, k in enumerate(TRUNCATED):
        r = len(SEEDS) + i
        pos[r, k:] = n
        count[r] = k
    hint = torch.full((len(rows),), float("nan"), dtype=tdt)
    start, peak_t, rec_end = tpipe.preliminary_pass(env, floor, tfp.Peaks(pos, count, None),
                                                    SR, hint, cfg)
    peak_t = peak_t.clone()
    peak_t[1] = float("nan")

    calls = {}
    real_scan, real_rhythm = tcls.classify_scan, tcorr.rhythm_scan

    def scan(x, *a, **k):
        calls["scan"] = x
        return real_scan(x, *a, **k)

    def rhythm(*a, **k):
        calls["rhythm"] = a[:4]
        return real_rhythm(*a, **k)

    tcls.classify_scan, tcorr.rhythm_scan = scan, rhythm
    try:
        res = tcls.classify(env, floor, pos, count, SR, start, cfg,
                            peak_bpm_time_sec=peak_t, recovery_end_time_sec=rec_end)
        tcorr.rhythm_correction(res.s1_positions, res.s1_count, env, SR, cfg)
    finally:
        tcls.classify_scan, tcorr.rhythm_scan = real_scan, real_rhythm
    _CACHE[dtype] = calls["scan"], calls["rhythm"], n
    _CORRECTION[dtype] = cfg, res.s1_positions, res.s1_count, env
    return _CACHE[dtype]


def correction_inputs(dtype: str):
    """(config, S1 positions, S1 count, envelope) that stage 4 took in
    ``_captured``'s run."""
    _captured(dtype)
    return _CORRECTION[dtype]


def _full_row(x: tcls.ScanInputs, row: int) -> tcls.ScanInputs:
    """The inputs cut to ``row``'s count of slots: that row at full capacity."""
    k = int(x.count[row])
    cut = {f: (v[:, :k].contiguous() if v.dim() == 2 else v) for f, v in x._asdict().items()}
    cut["count"] = torch.clamp(x.count, max=k)
    return tcls.ScanInputs(**cut)


# --------------------------------------------------------------------------
# The classifier kernel's thread, in numpy scalars.

def _isnan(v):
    return v != v


def _clamp(v, lo, hi):
    return v if _isnan(v) else min(max(v, lo), hi)


def _clamp_min(v, lo):
    return v if _isnan(v) else max(v, lo)


def _clamp_max(v, hi):
    return v if _isnan(v) else min(v, hi)


def _maximum(a, b):
    return a if _isnan(a) else (b if _isnan(b) else max(a, b))


def _minimum(a, b):
    return a if _isnan(a) else (b if _isnan(b) else min(a, b))


CHUNK = 64                     # the kernel's kChunk
HALF_IDX, KICK_IDX = 1, 2      # pairing-ratio table rows past hist (hist + 1, hist + 2)


def _segment(xp, k, x):
    """The kernel's segment index: the count of knots not greater than x
    (searchsorted(right=True) for sorted knots, k for a NaN x), clamped."""
    cnt = sum(1 for j in range(k) if not (xp[j] > x))
    return min(max(cnt, 1), k - 1) - 1


def _interior_segment(xp, k, x):
    """The chain's segment index: the count over the interior knots 1..k-2
    alone, capped at k - 2."""
    return min(sum(1 for j in range(1, k - 1) if not (xp[j] > x)), k - 2)


def _interp(tb, x, segment=_segment):
    """Interp.__call__ with the constant values of table ``tb``: the kernel's
    chain interps (``segment=_interior_segment``) and its set-up's stability
    table (each division here is IEEE; the card holds the kernel's fast
    division against it)."""
    k = int(tb[T_K])
    im1 = segment(tb[T_XP:], k, x)
    f_lo = tb[T_FLO + im1]
    f = f_lo + ((x - tb[T_XP + im1]) / tb[T_DX + im1]) * tb[T_DF + im1]
    if tb[T_DX0 + im1] != 0:
        f = f_lo
    if x < tb[T_XP]:
        f = tb[T_FIRST]
    if x > tb[T_XP + k - 1]:
        f = tb[T_LAST]
    return f


def _precompute(tb, arr, b, t, cnt, T, sr, eps):
    """A helper thread's slot: the inputs, the bits and the base interp's
    row (ba, bb), next row (bc, bd) and quotient bq, or ``lo`` where the
    blend is f_lo alone."""
    dv = arr["deviation"][b, t]
    k = int(tb[T_K])
    im1 = _segment(tb[T_XP:], k, dv)
    lo_row = (0 if dv < tb[T_XP] else k - 1 if dv > tb[T_XP + k - 1]
              else im1 if tb[T_DX0 + im1] != 0 else None)
    slot = dict(p=int(arr["positions"][b, t]), ivl=arr["interval_sec"][b, t],
                r21=arr["s2_s1_ratio"][b, t], st=arr["strength"][b, t],
                bst=arr["boost"][b, t], fl=int(arr["flags"][b, t]) & 7,
                active=t < cnt, is_last=t == cnt - 1, lo=lo_row is not None)
    slot.update(p_sec=T(slot["p"]) / sr, st_eps=slot["st"] + eps)
    if lo_row is not None:
        slot.update(ba=tb[T_FLO + lo_row], bb=tb[T_DF + lo_row], bc=T(0), bd=T(0), bq=T(0))
    else:
        slot.update(ba=tb[T_FLO + im1], bb=tb[T_DF + im1], bc=tb[T_FLO + im1 + 1],
                    bd=tb[T_DF + im1 + 1], bq=(dv - tb[T_XP + im1]) / tb[T_DX + im1])
    return slot


def emulate_classify(x: tcls.ScanInputs, cfg, want_trace: bool):
    """(peak_class, {field: (B, cap)}) of the kernel's blocks, one row at a
    time: per chunk of 64 slots the helpers' slot ring, then the chain over
    it into the chunk's out buffers, then the flush of those buffers."""
    dtype = x.deviation.dtype
    T = np.float32 if dtype == torch.float32 else np.float64
    floats, si = tcls.kernel_constants(SR, cfg, dtype)
    sc = [T(v) for v in floats]
    tables = [sc[32 + i * 48:32 + (i + 1) * 48] for i in range(5)]
    kick = cfg.compat.kickstart_effective
    hist = int(si[K_HIST])
    # The set-up's pairing-ratio tables: ring means, then 1/2 and the override.
    ptab = [T(i) / sc[C_HIST] for i in range(hist + 1)] + [sc[C_HALF], sc[C_KICK_OVR]]
    with np.errstate(all="ignore"):
        sftab = [_interp(tables[I_SF], v) for v in ptab]
    arr = {f: getattr(x, f).numpy() for f in x._fields}
    bsz, cap = arr["positions"].shape
    pc = np.zeros((bsz, cap), np.int32)
    out = {f: np.zeros((bsz, cap), T) for f in classify_kernel.KERNEL_FIELDS}
    lone_out = np.zeros((bsz, cap), np.int32)
    paired_out = np.zeros((bsz, cap), bool)
    zero, one = sc[C_ZERO], sc[C_ONE]

    def chain_interp(tb, x):
        return _interp(tb, x, _interior_segment)

    def update(belief, rr, instant):
        target = belief * sc[C_ONE_MINUS_LR] + instant * sc[C_LR]
        max_change = rr * sc[C_MAX_CHANGE]
        change = _minimum(_maximum(target - belief, -max_change), max_change)
        return _clamp(belief + change, sc[C_MIN_BPM], sc[C_MAX_BPM])

    with np.errstate(all="ignore"):
        for b in range(bsz):
            pending, belief = False, arr["start_belief"][b]
            last_pos = prev_pos = -1
            # The carried divisions of the last appended slots.
            rr_keep = T(last_pos - prev_pos) / sc[C_SR]
            inst_keep = (one / rr_keep) * sc[C_SIXTY]
            last_sec = T(last_pos) / sc[C_SR]
            ls_eps = T(0) + sc[C_EPS]
            cand_count, ring, rejections = 0, 0, 0
            ks_lone = ks_next = 0
            ks_prev = False
            cnt = int(arr["count"][b])
            for t0 in range(0, cap, CHUNK):
                n = min(CHUNK, cap - t0)
                slots = [_precompute(tables[I_BASE], arr, b, t0 + u, cnt, T, sc[C_SR], sc[C_EPS])
                         for u in range(n)]
                chunk_pc = np.zeros(n, np.int32)
                chunk_f = {f: np.zeros(n, T) for f in classify_kernel.KERNEL_FIELDS}
                chunk_lone, chunk_paired = np.zeros(n, np.int32), np.zeros(n, bool)
                for u, s in enumerate(slots):
                    fl = s["fl"]
                    ridx = hist + HALF_IDX if cand_count < hist else bin(ring).count("1")
                    if kick:
                        matches = bin(ks_lone & ks_next).count("1")
                        lones = bin(ks_lone).count("1")
                        if (ptab[ridx] < sc[C_KICK_THR] and cand_count >= 4 and lones >= 3
                                and matches >= 3):
                            ridx = hist + KICK_IDX
                    pairing_ratio, sf = ptab[ridx], sftab[ridx]

                    blend = _clamp((belief - sc[C_BPM_LOW]) / sc[C_BPM_SPAN], zero, one)
                    f_lo = s["ba"] + s["bb"] * blend
                    base_conf = (f_lo if s["lo"]
                                 else f_lo + s["bq"] * ((s["bc"] + s["bd"] * blend) - f_lo))
                    use_sf = cand_count >= 5
                    conf = base_conf * sf if use_sf else base_conf
                    eff = _clamp_min(belief, sc[C_BPM_LOW]) if fl & tcls.IN_RECOVERY else belief
                    max_expected = chain_interp(tables[I_RATIO], eff)
                    do_penalty = s["r21"] > max_expected
                    # The kernel multiplies by 1/2: the same bits as / 2.
                    severity = _clamp((s["r21"] / max_expected - one) * T(0.5), zero, one)
                    assert sc[C_TWO] == 2
                    penalty = severity * sc[C_PEN_SPAN] + sc[C_PEN_MIN]
                    do_boost = (not do_penalty) and bool(fl & tcls.STRONG_S1)
                    conf = (conf - penalty if do_penalty
                            else (conf + s["bst"] if do_boost else conf))
                    conf = one if _isnan(conf) else _clamp(conf, zero, one)

                    ivl = s["ivl"]
                    expected_rr = (one / belief) * sc[C_SIXTY]
                    max_interval = _clamp_max(expected_rr * sc[C_RR_FRAC], sc[C_IVL_CAP])
                    pzs, pze = max_interval * sc[C_PZS], max_interval * sc[C_PZE]
                    exceed_i = _clamp((ivl - pzs) / (pze - pzs + sc[C_EPS]), zero, one)
                    ipen = exceed_i * sc[C_IPEN_MAX]
                    do_ipen = bool(si[K_ENABLE_IPEN]) and ivl > max_interval and ivl > pzs
                    if do_ipen:
                        conf = _clamp_min(conf - ipen, zero)
                    paired = bool(conf >= sc[C_PAIR_THR])

                    p = s["p"]
                    first_beat = cand_count == 0
                    actual_rr = T(p - last_pos) / sc[C_SR]
                    rhythm_dev = abs(actual_rr - expected_rr) / expected_rr
                    rhythm_score = chain_interp(tables[I_RHYTHM], rhythm_dev)
                    amp_ratio = s["st"] / ls_eps
                    amp_score = chain_interp(tables[I_AMP], amp_ratio)
                    lone_conf = rhythm_score * sc[C_W_RHYTHM] + amp_score * sc[C_W_AMP]
                    conf_ok = bool(lone_conf >= sc[C_LONE_THR])
                    fwd_fail = bool(ivl < expected_rr * sc[C_FWD_PCT]) and not fl & tcls.FWD_WAIVED
                    lone_valid = first_beat or (conf_ok and not fwd_fail)
                    lone_reason = (si[K_LONE_FIRST] if first_beat else si[K_LONE_REJ_CONF]
                                   if not conf_ok else si[K_LONE_REJ_FWD] if fwd_fail
                                   else si[K_LONE_OK])
                    rej_after = (rejections + 1 if not lone_valid
                                 and lone_reason == si[K_LONE_REJ_CONF] else 0)
                    cascade = (not lone_valid) and rej_after >= si[K_CASCADE]
                    lone_class = (si[K_LONE_VALIDATED] if lone_valid else si[K_LONE_CASCADE]
                                  if cascade else si[K_NOISE])
                    peak_class = (si[K_S2_PAIRED] if pending else si[K_LONE_LAST]
                                  if s["is_last"] else si[K_S1_PAIRED] if paired else lone_class)
                    if not s["active"]:
                        peak_class = si[K_UNCLASSIFIED]
                    processed = s["active"] and not pending
                    appended = processed and (s["is_last"] or paired or lone_valid or cascade)
                    appended_paired = processed and not s["is_last"] and paired
                    new_last = p if appended else last_pos
                    new_prev = last_pos if appended else prev_pos
                    new_count = cand_count + int(appended)

                    # Both candidate updates, then the decision's pick.
                    inst_append = (one / actual_rr) * sc[C_SIXTY]
                    upd_append = update(belief, actual_rr, inst_append)
                    upd_keep = update(belief, rr_keep, inst_keep)
                    rr_new = actual_rr if appended else rr_keep
                    can_update = processed and new_count > 1 and new_prev >= 0 and rr_new > 0
                    new_belief = ((upd_append if appended else upd_keep) if can_update
                                  else belief)

                    chunk_pc[u] = peak_class
                    if want_trace:
                        nan = sc[C_NAN]
                        row = dict(
                            blend_ratio=blend, base_conf=base_conf, pairing_ratio=pairing_ratio,
                            stability_factor=sf if use_sf else nan,
                            max_expected_ratio=max_expected,
                            penalty_amount=penalty if do_penalty else nan,
                            boost_amount=s["bst"] if do_boost else nan,
                            max_interval_sec=max_interval,
                            interval_penalty=ipen if do_ipen else nan, final_conf=conf,
                            lone_conf=lone_conf, rhythm_score=rhythm_score,
                            actual_rr_sec=actual_rr, expected_rr_sec=expected_rr,
                            amp_score=amp_score, amp_ratio=amp_ratio, belief=new_belief,
                            belief_time_sec=((s["p_sec"] if appended else last_sec)
                                             if processed and new_count > 0 else nan))
                        for f, v in row.items():
                            chunk_f[f][u] = v
                        chunk_lone[u] = lone_reason
                        chunk_paired[u] = paired

                    if kick:
                        appended_lone = appended and not appended_paired
                        noise_step = (processed and not s["is_last"] and not paired
                                      and not lone_valid and not cascade)
                        marked = ks_next | (8 if noise_step and ks_prev else 0)
                        if appended:
                            ks_lone = (ks_lone >> 1) | (8 if appended_lone else 0)
                            ks_next = marked >> 1
                        else:
                            ks_next = marked
                        if processed:
                            ks_prev = appended_lone
                    if appended:
                        ls_eps, last_sec = s["st_eps"], s["p_sec"]
                        rr_keep, inst_keep = actual_rr, inst_append
                        ring = (ring >> 1) | (int(appended_paired) << (hist - 1))
                    if processed and not s["is_last"]:
                        rejections = 0 if (paired or lone_valid or cascade) else rej_after
                    pending = processed and not s["is_last"] and paired
                    belief, last_pos, prev_pos, cand_count = (new_belief, new_last, new_prev,
                                                              new_count)
                # The helpers' flush of the finished chunk.
                pc[b, t0:t0 + n] = chunk_pc
                if want_trace:
                    for f in classify_kernel.KERNEL_FIELDS:
                        out[f][b, t0:t0 + n] = chunk_f[f]
                    lone_out[b, t0:t0 + n] = chunk_lone
                    paired_out[b, t0:t0 + n] = chunk_paired
    if not want_trace:
        return pc, None
    out.update(peak_class=pc, lone_reason=lone_out, paired=paired_out)
    out.update({f: getattr(x, f).numpy() for f in tcls.SLOT_FIELDS})
    return pc, out


def _assert_trace_equal(got: dict, trace: tcls.ClassifierTrace):
    assert set(got) == set(tcls.ClassifierTrace._fields)
    for f in tcls.ClassifierTrace._fields:
        exp = getattr(trace, f).numpy()
        assert got[f].dtype == exp.dtype, f
        np.testing.assert_array_equal(got[f], exp, err_msg=f)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kickstart", [False, True])
def test_classify_kernel_emulation_equals_plain_loop(dtype, kickstart):
    x, _, _ = _captured(dtype)
    cfg = _config(dtype, kickstart)
    counts = x.count.tolist()
    assert counts[len(SEEDS):] == list(TRUNCATED) and min(counts[:len(SEEDS)]) >= 100
    assert bool((x.flags & tcls.IN_RECOVERY).any()) and not bool(
        (x.flags[1] & tcls.IN_RECOVERY).any())
    for want_trace in (True, False):
        pc_exp, trace = tcls.scan_plain(x, SR, cfg, want_trace=want_trace)
        pc, got = emulate_classify(x, cfg, want_trace)
        np.testing.assert_array_equal(pc, pc_exp.numpy())
        if want_trace:
            _assert_trace_equal(got, trace)
            classes = set(pc[:len(SEEDS)].ravel().tolist())
            assert {types.S1_PAIRED, types.S2_PAIRED, types.LONE_S1_LAST,
                    types.UNCLASSIFIED} <= classes
            assert len(set(got["lone_reason"].ravel().tolist())) >= 3
        else:
            assert trace is None


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_classify_kernel_emulation_at_full_capacity(dtype):
    x, _, _ = _captured(dtype)
    full = _full_row(x, 2)
    assert int(full.count[2]) == full.positions.shape[1]
    cfg = _config(dtype)
    pc_exp, trace = tcls.scan_plain(full, SR, cfg)
    pc, got = emulate_classify(full, cfg, True)
    np.testing.assert_array_equal(pc, pc_exp.numpy())
    _assert_trace_equal(got, trace)


def test_classify_wrapper_takes_the_plain_version_on_the_cpu():
    x, _, _ = _captured("float32")
    cfg = _config("float32")
    before = build.launches["classify_scan"]
    pc, trace = tcls.classify_scan(x, 18120, SR, cfg)
    pc_exp, trace_exp = tcls.scan_plain(x, SR, cfg)
    assert build.launches["classify_scan"] == before
    assert torch.equal(pc, pc_exp)
    for f in tcls.ClassifierTrace._fields:
        assert torch.equal(torch.nan_to_num(getattr(trace, f), nan=-7.0),
                           torch.nan_to_num(getattr(trace_exp, f), nan=-7.0)), f


# --------------------------------------------------------------------------
# The rhythm kernel's block.

THREADS, TILE, SPAN = 128, chip_smoke.RHYTHM_TILE, (1 << 24) - 1   # kThreads, kTile, kSpan


def conflict_limit(thr, sr, T):
    """The kernel's d* (``conflict_limit``): warp 0's rounds, in each of
    which lane j tests the last value of the j-th of 32 parts of [lo, hi)."""
    lo, hi = -SPAN, SPAN + 1
    while lo < hi:
        part = (hi - lo + 31) // 32
        last = [lo + (j + 1) * part - 1 for j in range(32)]
        votes = [e >= hi or not (T(e) / sr < thr) for e in last]
        if not any(votes):
            return hi
        j = votes.index(True)
        lo, hi = lo + j * part, min(last[j], hi)
    return lo


def emulate_rhythm(pos, amp, count, threshold):
    """(written, victim, paths) of the kernel's blocks, one row at a time: per
    tile of TILE slots the vote, then each thread's chunk in turn (its
    inactive slots, then its chain: thread 0 from the carry, another from
    the first run start in its chunk), each slot written by exactly one
    thread.  ``paths`` counts sorted and unsorted tiles, tiles entered with
    a carry, tiles refused for the carried position alone, chains that ran
    past their chunk, and the longest chain."""
    T = amp.dtype.type
    sr = T(SR)
    bsz, cap = pos.shape
    written = np.zeros((bsz, cap), bool)
    victim = np.zeros((bsz, cap), np.int32)
    owner = np.full((bsz, cap), -1)
    paths = dict(sorted=0, unsorted=0, carried=0, carry_vote=0, past_chunk=0, longest=0)
    for b in range(bsz):
        dstar = conflict_limit(threshold[b], sr, T)
        cnt = int(count[b])
        carry = None
        for t0 in range(0, cap, TILE):
            nt = min(TILE, cap - t0)
            p = [int(v) for v in pos[b, t0:t0 + nt]]
            a = amp[b, t0:t0 + nt]
            act_end = min(max(cnt - t0, 0), nt)
            if t0 == 0 and act_end > 0:
                carry = (0, p[0], a[0])
            pairs_ok = all(p[i] >= p[i - 1] for i in range(1, act_end))
            carry_ok = act_end == 0 or carry[1] <= p[0]
            is_sorted = pairs_ok and carry_ok
            paths["sorted" if is_sorted else "unsorted"] += 1
            paths["carry_vote"] += pairs_ok and not carry_ok
            paths["carried"] += t0 > 0 and act_end > 0

            def put(i, w, v, k):
                assert owner[b, t0 + i] == -1, (b, t0 + i)
                owner[b, t0 + i] = k
                written[b, t0 + i], victim[b, t0 + i] = w, v

            per = -(-nt // THREADS)
            carry_out = None
            for k in range(THREADS):
                lo, hi = min(k * per, nt), min(k * per + per, nt)
                for i in range(max(lo, act_end), hi):
                    put(i, False, cap, k)
                stop = hi
                if k == 0:
                    first, c = 0, carry
                    if not is_sorted:
                        stop = nt
                elif is_sorted:
                    first = next((i for i in range(lo, min(hi, act_end))
                                  if p[i] - p[i - 1] >= dstar), None)
                    if first is None:
                        continue
                    c = (t0 + first - 1, p[first - 1], a[first - 1])
                else:
                    continue
                i = first
                while i < act_end:
                    if i >= stop and p[i] - p[i - 1] >= dstar:
                        break
                    last_slot, last_pos, last_amp = c
                    act = t0 + i > 0
                    conflict = act and p[i] - last_pos < dstar
                    replace = conflict and a[i] > last_amp
                    w = act and not (conflict and not replace)
                    put(i, w, last_slot if replace else cap, k)
                    if w:
                        c = (t0 + i, p[i], a[i])
                    i += 1
                paths["past_chunk"] += i > hi
                paths["longest"] = max(paths["longest"], i - first)
                if i == nt:
                    assert carry_out is None
                    carry_out = c
            carry = carry_out
    assert (owner >= 0).all()
    return written, victim, paths


_RHYTHM = {}
FIRST_CASES, EDGE_CASES = chip_smoke.RHYTHM_CASES[:3], chip_smoke.RHYTHM_CASES[3:]


def _rhythm_cases(dtype):
    """chip_smoke.rhythm_cases of the captured call, by name."""
    if dtype not in _RHYTHM:
        _, (pos, amp, count, threshold), n = _captured(dtype)
        cases = chip_smoke.rhythm_cases(pos, amp, count, threshold, n, SR)
        _RHYTHM[dtype] = {c[0]: c[1:5] for c in cases}
    return _RHYTHM[dtype]


def _emulate_and_compare(name, pos, amp, count, threshold):
    w_exp, v_exp = tcorr.rhythm_scan_plain(pos, amp, count, threshold, SR)
    w, v, paths = emulate_rhythm(pos.numpy(), amp.numpy(), count.numpy(), threshold.numpy())
    np.testing.assert_array_equal(w, w_exp.numpy(), err_msg=name)
    np.testing.assert_array_equal(v, v_exp.numpy(), err_msg=name)
    return v, paths


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rhythm_kernel_emulation_equals_plain_loop(dtype):
    replaced = 0
    cases = _rhythm_cases(dtype)
    for name in FIRST_CASES:
        pos, amp, count, threshold = cases[name]
        v, paths = _emulate_and_compare(name, pos, amp, count, threshold)
        assert paths["unsorted"] == 0, name
        replaced += int((v < pos.shape[1]).sum())
    counts = _captured(dtype)[1][2].tolist()
    assert min(counts) < 5 and replaced > 10


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rhythm_kernel_emulation_on_edge_cases(dtype, case):
    """Bit for bit against the plain loop, and each case reaches what it is
    for: the block's paths, the tile hand-off, d* at the edges."""
    pos, amp, count, threshold = _rhythm_cases(dtype)[case]
    v, paths = _emulate_and_compare(case, pos, amp, count, threshold)
    T = np.dtype(dtype).type
    cap = pos.shape[1]
    p = pos.numpy().astype(np.int64)
    if case == "few_slots":
        assert count[:4].tolist() == [0, 1, 2, 4] and (v[3] < cap).any()
    elif case == "edge_thresholds":
        assert [conflict_limit(t, T(SR), T) for t in threshold[:4].numpy()] == \
            [-SPAN, SPAN + 1, -302, -SPAN]
        assert (v[0] == cap).all() and (v[1] < cap).any()
    elif case.endswith("f(d)"):
        d = [15 if r % 2 == 0 or count[r] < 4 else int(p[r, 3] - p[r, 2])
             for r in range(pos.shape[0])]
        got = [conflict_limit(t, T(SR), T) for t in threshold.numpy()]
        want = {"at_f(d)": [[x] for x in d], "above_f(d)": [[x + 1] for x in d],
                "below_f(d)": [[x - 1, x] for x in d]}[case]
        assert all(g in w for g, w in zip(got, want)), (got, d)
    elif case == "unsorted":
        assert paths["unsorted"] >= 3 and paths["sorted"] >= 1
        assert (v[2] < cap).any()
    elif case == "one_run":
        assert int(count[0]) == cap and paths["longest"] == cap
        assert paths["past_chunk"] >= 1 and (v[0] < cap).sum() >= cap // 2 - 1
    elif case == "tiles":
        assert cap > 2 * TILE and int(count[3]) < 2 * TILE
        assert paths["carried"] >= 6 and paths["carry_vote"] >= 1
        assert paths["unsorted"] >= 2 and paths["longest"] == TILE
        assert (v[0] < cap).sum() >= cap // 2 - 1 and (v[1] < cap).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_conflict_limit_equals_brute_force(dtype):
    """d < d*  <=>  f(d) < thr for every d in [-n, n] (f(d) = d / sr in the
    working type), at sr = 302 and n = 196,608, for thresholds at the edges
    (NaN, +-inf, +-0, negative, tiny, huge) and at f(d), one step below and
    one above, for distances across the range."""
    T = np.dtype(dtype).type
    n, sr = 196_608, T(302)
    d = np.arange(-n, n + 1)
    f = d.astype(T) / sr
    assert (np.diff(f) >= 0).all()
    thresholds = [T(v) for v in (np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, 0.28, 1e-30,
                                 -1e-30, 1e30)]
    for x in (-n, -302, -7, -1, 1, 15, 85, 302, 4097, 65_537, n):
        fx = f[x + n]
        thresholds += [fx, np.nextafter(fx, T(-np.inf)), np.nextafter(fx, T(np.inf))]
    for thr in thresholds:
        np.testing.assert_array_equal(d < conflict_limit(thr, sr, T), f < thr,
                                      err_msg=repr(thr))


def test_rhythm_wrapper_takes_the_plain_version_on_the_cpu():
    pos, amp, count, threshold = _rhythm_cases("float32")["conflicts"]
    before = build.launches["rhythm_scan"]
    written, victim = tcorr.rhythm_scan(pos, amp, count, threshold, 18120, SR)
    w_exp, v_exp = tcorr.rhythm_scan_plain(pos, amp, count, threshold, SR)
    assert build.launches["rhythm_scan"] == before
    assert torch.equal(written, w_exp) and torch.equal(victim, v_exp)
