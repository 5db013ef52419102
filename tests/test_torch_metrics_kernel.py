"""The metrics kernel (``csrc/metrics.cu``) on the CPU: its design emulated in
numpy and held bit for bit against ``models/analytics.compute_metrics_plain``,
and the seam that chooses between the two.

The emulation follows the kernel's order of work for one recording (one
block): the beat times; the valid diffs compacted in order; each slot's
smoothing window from the shifted compares and its sum in ascending slot
order from 0; the HRV windows' sums as one warp's shuffle tree; the summary
means as the shared-memory tree over the row padded to a power of two; the
curve's plateau maxima and minima from run starts and ends; the first 256
candidates; the distance suppression as the sequential greedy walk in rank
order over windows from torch's own binary searches of the float32
positions; prominences by the linear scans; the steepest slopes and the
heart-rate recovery with torch's binary searches and argmax; the slope lists
ranked by a stable count.  The kernel's divisions by a configuration number
are multiplies by the reciprocal the host rounds to the dtype, as ATen
divides a CUDA tensor by a Python number, and its square roots are correctly
rounded; with ``card=False`` the emulation divides and takes torch's CPU
square root, as the plain version does here.  With ``card=True`` it is held
against the plain version run under ``CardArithmetic``, which gives the
plain version the card's division by a Python number and square root on
the CPU: that checks that the kernel knows every such operation.

The cases are ``chip_smoke.metrics_cases`` (the card test runs the same
ones); each asserts that it reaches what it is named for.  Beside them: HRV
windows past 64 intervals, whose warp folds its columns in bit-reversed
order; and a smoothing window the configuration leaves unbounded, whose
edges the kernel counts by the compares up to the first that fails, equal
to the plain version's bounded form at M = cap - 1 and near its prefix-sum
form.  The seam: CPU tensors take the plain version, every other device
the kernel (the ``meta`` device stands in for the card), and the wrapper
refuses what it cannot take.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke
from bpm_analysis_tpu_torch.config import AnalyzerConfig, CompatConfig
from bpm_analysis_tpu_torch.models import analytics
from bpm_analysis_tpu_torch.ops.cuda import metrics_kernel

torch.set_num_threads(1)

CAP = 1536
WORK, SLOPES, LANES = metrics_kernel.WORK, metrics_kernel.SLOPES, 32
CASES = chip_smoke.metrics_cases(CAP)


class CardArithmetic(TorchFunctionMode):
    """The two operations of the plain version whose CPU and CUDA kernels
    differ, as ATen runs them on a card: a division of a floating tensor by a
    Python number is a multiply by the reciprocal rounded to the tensor's
    dtype, and ``torch.sqrt`` is the correctly rounded square root (the
    CPU's vectorized one may be an ulp off)."""

    DIVISIONS = (torch.Tensor.__truediv__, torch.Tensor.div, torch.div, torch.true_divide)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.sqrt, torch.Tensor.sqrt) and not kwargs:
            return torch.from_numpy(np.sqrt(args[0].numpy()))
        if (func in self.DIVISIONS and len(args) == 2 and not kwargs
                and isinstance(args[1], (int, float)) and not isinstance(args[1], bool)
                and isinstance(args[0], torch.Tensor) and args[0].is_floating_point()):
            npd = np.float32 if args[0].dtype == torch.float32 else np.float64
            return args[0] * float(npd(1.0) / npd(args[1]))
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# torch's primitives as the kernel repeats them
# ---------------------------------------------------------------------------

def lower_bound(at, n: int, vals):
    """ATen's cus_lower_bound over at[0..n-1] for each of ``vals``."""
    vals = np.atleast_1d(vals)
    start, end = np.zeros(len(vals), np.int64), np.full(len(vals), n, np.int64)
    while np.any(start < end):
        act = start < end
        mid = start + ((end - start) >> 1)
        go = act & ~(at[np.minimum(mid, n - 1)] >= vals)
        start = np.where(go, mid + 1, start)
        end = np.where(act & ~go, mid, end)
    return start


def upper_bound(at, n: int, vals):
    vals = np.atleast_1d(vals)
    start, end = np.zeros(len(vals), np.int64), np.full(len(vals), n, np.int64)
    while np.any(start < end):
        act = start < end
        mid = start + ((end - start) >> 1)
        go = act & ~(at[np.minimum(mid, n - 1)] > vals)
        start = np.where(go, mid + 1, start)
        end = np.where(act & ~go, mid, end)
    return start


def sort_less(a, b):
    """torch's ascending order, NaN last (broadcasting)."""
    return (a < b) | (np.isnan(b) & ~np.isnan(a))


def tree_width(n: int) -> int:
    w = 1
    while w < n:
        w <<= 1
    return w


def tree_sum(x, T):
    """``tree_sum``: element i plus element i + half over x zero-padded to a
    power of two."""
    n = len(x)
    width = tree_width(n)
    if width == 1:
        return x[0]
    a = np.concatenate([x, np.zeros(width - n, T)])
    while len(a) > 1:
        half = len(a) // 2
        a = a[:half] + a[half:]
    return a[0]


def warp_tree(x, T):
    """``warp_tree`` over the last axis: lane l takes x[l] + x[l + 32] when
    the width is 64; past 64 it folds its column x[l + 32k] in bit-reversed
    order of k with the kernel's stack of partial sums; then it adds the
    lane ``off`` above it for off = 16, 8, ..., 1 (lanes past the row read
    their own value)."""
    n = x.shape[-1]
    width = tree_width(n)
    pad = np.concatenate([x, np.zeros(x.shape[:-1] + (max(width, 64) - n,), T)], axis=-1)
    if width == 64:
        a = pad[..., :LANES] + pad[..., LANES:2 * LANES]
    elif width > 64:
        cols = width // LANES
        bits = cols.bit_length() - 1
        stack = [None] * (bits + 1)
        for m in range(cols):
            k = int(format(m, f"0{bits}b")[::-1], 2)
            v = pad[..., LANES * k:LANES * (k + 1)]
            level, mm = 0, m
            while mm & 1:
                v = stack[level] + v
                level, mm = level + 1, mm >> 1
            stack[level] = v
        a = stack[bits]
    else:
        a = pad[..., :LANES]
    off = min(width, LANES) >> 1
    while off > 0:
        src = np.minimum(np.arange(LANES) + off, LANES - 1)
        shifted = np.where(np.arange(LANES) + off < LANES, a[..., src], a)
        a = a + shifted
        off >>= 1
    return a[..., 0]


# ---------------------------------------------------------------------------
# One recording as one block of csrc/metrics.cu
# ---------------------------------------------------------------------------

def emulate_row(pos_row, cnt: int, sr: int, cfg: AnalyzerConfig, T, card: bool):
    """The kernel's outputs for one row as a dict of the Metrics fields, and
    what the row reached (``info``)."""
    cap = len(pos_row)
    o = cfg.output
    nan, inf = T(np.nan), T(np.inf)
    info = {}

    def sdiv(x, c):   # a division by a configuration number
        return x * T(T(1) / T(c)) if card else x / T(c)

    def sqrt(x, where):   # the device's square root of x at the windows ``where``
        if card:
            return np.sqrt(x)
        full = np.zeros(len(where), T)
        full[where] = x
        return torch.sqrt(torch.from_numpy(full)[None]).numpy()[0][where]

    idx = np.arange(cap)
    # bpm_series: beat times, the valid diffs compacted in order.
    t = sdiv(np.where(idx < cnt, pos_row.astype(np.int64), 2 ** 31 - 1).astype(T), sr)
    d = t[1:] - t[:-1]
    dvalid = (idx[:-1] < cnt - 1) & (d > T(1e-6))
    v = int(dvalid.sum())
    info["dropped_diffs"] = int(((idx[:-1] < cnt - 1) & ~dvalid).sum())
    ct = np.full(cap, nan, T)
    ci = np.full(cap, nan, T)
    ct[:v] = t[1:][dvalid]
    ci[:v] = (T(1) / d[dvalid]) * T(60)

    # The time window: compares (unbounded, up to the first that fails),
    # then the sum in slot order from 0.
    M = analytics.smoothing_slot_bound(sr, cfg)
    bounded = M is not None and M < cap
    half, big = T(o.output_smoothing_window_sec / 2.0), np.finfo(T).max
    tb = np.where(idx < v, ct, big).astype(T)
    i = np.arange(v)
    thi, tlo = ct[:v] + half, ct[:v] - half
    cn, cp = np.zeros(v, np.int64), np.zeros(v, np.int64)
    going_n, going_p = np.ones(v, bool), np.ones(v, bool)
    for m in range(1, M + 1 if bounded else cap):
        j, k = i + m, i - m
        up = (j < cap) & (tb[np.minimum(j, cap - 1)] <= thi)
        down = (k >= 0) & (ct[np.maximum(k, 0)] > tlo)
        if not bounded:
            going_n &= up
            going_p &= down
            up, down = going_n, going_p
        cn += up
        cp += down
    info["bounded_window"] = bounded
    hi = np.minimum(np.maximum(i + 1 + cn, 0), v)
    lo = np.minimum(np.maximum(i - cp, 0), v)
    acc = np.zeros(v, T)
    for k in range(int((hi - lo).max()) if v else 0):
        j = lo + k
        acc = np.where(j < hi, acc + ci[np.minimum(j, cap - 1)], acc)
    n = (hi - lo).astype(T)
    sm = np.full(cap, nan, T)
    sm[:v] = np.where(n > 0, acc / np.maximum(n, T(1)), nan)

    # windowed_hrv: one warp a valid window.
    w, step, hcap = o.hrv_window_size_beats, o.hrv_step_size_beats, analytics.HRV_CAPACITY
    n_rr = max(cnt - 1, 0)
    starts = np.arange(hcap) * step
    wvalid = (starts + w <= n_rr) & (cnt >= w)
    kk = np.clip(starts[wvalid][:, None] + np.arange(w + 1)[None, :], 0, cap - 2)
    rr = (t[kk + 1] - t[kk]) * T(1000.0)            # (windows, w + 1)
    win = rr[:, :w]
    mean = sdiv(warp_tree(win, T), w)
    sdnn = sqrt(sdiv(warp_tree((win - mean[:, None]) * (win - mean[:, None]), T), w), wvalid)
    sd = win[:, 1:] - win[:, :-1]
    rmssd = sqrt(sdiv(warp_tree(sd * sd, T), w - 1), wvalid)
    msec = sdiv(mean, 1000.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rmssdc = np.where(msec > 0, rmssd / msec, T(0))
        wbpm = np.where(msec > 0, (T(1) / msec) * T(60), T(0))
    sv = starts[wvalid]
    mid = sdiv(t[np.minimum(sv, cap - 1)] + t[np.minimum(sv + w, cap - 1)], 2.0)
    hrv = {f: np.full(hcap, nan, T) for f in ("time", "rmssdc", "sdnn", "bpm")}
    for f, x in (("time", mid), ("rmssdc", rmssdc), ("sdnn", sdnn), ("bpm", wbpm)):
        hrv[f][wvalid] = x
    nwin = int(wvalid.sum())
    info["hrv_windows"] = nwin

    def nanmean(x):
        ok = ~np.isnan(x)
        with np.errstate(invalid="ignore", divide="ignore"):
            return tree_sum(np.where(ok, x, T(0)), T) / T(ok.sum())

    out = {"bpm.times": ct, "bpm.smoothed": sm, "bpm.instant": ci, "bpm.count": v,
           **{f"hrv.{f}": x for f, x in hrv.items()}, "hrv.count": nwin}
    fin_sm = sm[~np.isnan(sm)]
    out["avg_bpm"] = nanmean(sm) if v > 0 else nan
    out["min_bpm"] = fin_sm.min() if v > 0 and len(fin_sm) else nan
    out["max_bpm"] = fin_sm.max() if v > 0 and len(fin_sm) else nan
    out["avg_rmssdc"] = nanmean(hrv["rmssdc"]) if nwin > 0 else nan
    out["avg_sdnn"] = nanmean(hrv["sdnn"]) if nwin > 0 else nan

    # slope_extrema: the distance, the plateau maxima and minima.
    tt = np.where(idx < v, ct, inf).astype(T)
    with np.errstate(invalid="ignore"):
        dt = tt[1:] - tt[:-1]
    dok = (idx[:-1] < v - 1) & ~np.isnan(dt)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_dt = tree_sum(np.where(dok, dt, T(0)), T) / T(dok.sum())
        safe = T(1) if mean_dt == 0 else mean_dt
        dist = 5 if (np.isnan(mean_dt) or mean_dt == 0) else int((T(1) / safe) * T(
            o.incline_min_duration_sec / 2))
    fill = sm[v - 1] if v > 0 else nan
    vv = np.where(idx < v, sm, fill).astype(T)
    neq_prev = np.concatenate([[True], vv[1:] != vv[:-1]])
    neq_next = np.concatenate([vv[:-1] != vv[1:], [True]])
    rs = np.maximum.accumulate(np.where(neq_prev, idx, -1))
    re = np.minimum.accumulate(np.where(neq_next, idx, cap)[::-1])[::-1]
    ok = (rs >= 1) & (re <= cap - 2) & (idx == (rs + re) // 2)
    xl, xs = vv[np.maximum(rs - 1, 0)], vv[np.maximum(rs, 0)]
    xr, xe = vv[np.minimum(re + 1, cap - 1)], vv[np.minimum(re, cap - 1)]
    masks = (ok & (xl < xs) & (xr < xe), ok & (xl > xs) & (xr > xe))
    info["plateau_extrema"] = int((masks[0] | masks[1])[re > rs].sum())

    fin = []
    distf = np.ceil(np.float32(dist))
    for kind, mask in enumerate(masks):
        x = -vv if kind else vv
        cand = np.flatnonzero(mask)[:WORK]
        K = len(cand)
        info.setdefault("work_truncated", []).append(int(mask.sum()) > WORK)
        # Distance suppression: the greedy walk in rank order.
        slots = np.arange(WORK, dtype=np.float32)
        top = np.float32(cand[-1]) if K else np.float32(-np.inf)
        base = top + distf + np.float32(1.0)
        posf = np.where(np.arange(WORK) < K, np.concatenate(
            [cand.astype(np.float32), np.zeros(WORK - K, np.float32)]),
            base + slots * (distf + np.float32(1.0))).astype(np.float32)
        prio = x[cand].astype(np.float32)
        los = upper_bound(posf, WORK, posf[:K] - distf)
        his = lower_bound(posf, WORK, posf[:K] + distf) - 1
        jj = np.arange(K)
        before = sort_less(prio[:, None], prio[None, :]) | (   # [j, i]: i goes first
            (jj[None, :] > jj[:, None]) & ~sort_less(prio[None, :], prio[:, None]))
        rank = before.sum(axis=1)              # rank[j]: candidates processed before j
        order = np.empty(K, np.int64)
        order[rank] = jj
        ties = 0
        flag = np.zeros(WORK, np.int8)
        for j in order:
            if flag[j]:
                continue
            lo_, hi_ = max(los[j], 0), min(his[j], WORK - 1)
            ties += int(np.sum(prio[lo_:min(hi_, K - 1) + 1] == prio[j])) - 1
            flag[lo_:hi_ + 1] = np.where(flag[lo_:hi_ + 1] == 0, 1, flag[lo_:hi_ + 1])
            flag[j] = 2
        info.setdefault("equal_priorities", []).append(ties)
        surv = cand[flag[:K] == 2]
        # Prominences by the linear scans.
        keep = []
        for pp in surv:
            val = x[pp]
            left = np.flatnonzero(~(x[:pp] <= val))
            lb = left[-1] + 1 if len(left) else 0
            right = np.flatnonzero(~(x[pp + 1:] <= val))
            rb = pp + right[0] if len(right) else cap - 1
            prom = val - max(x[lb:pp + 1].min(), x[pp:rb + 1].min())
            keep.append(prom >= T(o.slope_peak_prominence))
        peaks = surv[np.asarray(keep, bool)] if len(surv) else surv
        info.setdefault("slope_truncated", []).append(len(peaks) > SLOPES)
        fin.append(peaks[:SLOPES])

    # steepest_slope twice, hrr.
    vneg = np.where(idx < v, sm, -inf).astype(T)
    imax = int(np.argmax(vneg))
    window = T(o.slope_window_sec)
    for name, direction, start in (("peak_exertion", 1, 0), ("peak_recovery", -1, imax)):
        e = lower_bound(tt, cap, tt + window)
        ec = np.clip(e, 0, cap - 1)
        te = tt[ec]
        with np.errstate(invalid="ignore", divide="ignore"):
            dur = te - tt
            okk = (idx < v) & (idx >= start) & (e < v) & (dur > 0) & (idx < v - 1)
            ve = sm[ec]
            slope = (ve - sm) / np.where(okk, dur, T(1))
            eff = np.where(okk, slope * T(direction), -inf)
        best = int(np.argmax(eff))
        t0, last_t = tt[min(start, cap - 1)], tt[max(v - 1, 0)]
        with np.errstate(invalid="ignore"):
            long_enough = v - start >= 2 and last_t - t0 >= window
        out[f"{name}.found"] = bool(long_enough and eff[best] > 0)
        for f, x in (("start_time", tt), ("end_time", te), ("start_bpm", sm),
                     ("end_bpm", ve), ("slope", slope), ("duration", dur)):
            out[f"{name}.{f}"] = x[best]
    peak_bpm, peak_time = vneg[imax], tt[imax]
    check = peak_time + T(o.hrr_interval_sec)
    last_i = max(v - 1, 0)
    tq = np.where(idx < v, ct, tt[last_i]).astype(T)
    if cfg.compat.hrr_truncated_interp:
        tq = np.floor(tq)
    vq = np.where(idx < v, sm, vneg[last_i]).astype(T)
    q = int(np.clip(upper_bound(tq, cap, check)[0], 1, cap - 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        f_lo, f_hi, x_lo, x_hi = vq[q - 1], vq[q], tq[q - 1], tq[q]
        df, dx, delta = f_hi - f_lo, x_hi - x_lo, check - x_lo
        eps = T(np.spacing(np.finfo(T).eps))
        dx0 = abs(dx) <= eps
        f = f_lo if dx0 else f_lo + (delta / dx) * df
        if check < tq[0]:
            f = vq[0]
        if check > tq[cap - 1]:
            f = vq[cap - 1]
        out.update({"hrr.found": bool(v >= 2 and check <= tt[last_i]),
                    "hrr.peak_bpm": peak_bpm, "hrr.peak_time": peak_time,
                    "hrr.recovery_bpm": f, "hrr.hrr": peak_bpm - f})

    # major_slopes: inclines (troughs to peaks), declines (peaks to troughs).
    for name, decl in (("inclines", False), ("declines", True)):
        starts_, ends_ = (fin[0], fin[1]) if decl else (fin[1], fin[0])
        ns, ne = len(starts_), len(ends_)
        s = np.arange(SLOPES)
        s_pos = np.where(s < ns, np.pad(starts_, (0, SLOPES - ns)), cap)
        e_pad = np.where(s < ne, np.pad(ends_, (0, SLOPES - ne)), cap)
        nxt = upper_bound(e_pad, SLOPES, s_pos)
        e_pos = e_pad[np.clip(nxt, 0, SLOPES - 1)]
        sc_, ec_ = np.clip(s_pos, 0, cap - 1), np.clip(e_pos, 0, cap - 1)
        with np.errstate(invalid="ignore", divide="ignore"):
            ts, te, vs, ve = tt[sc_], tt[ec_], sm[sc_], sm[ec_]
            dur, change = te - ts, ve - vs
            mag = -change if decl else change
            okk = ((s < ns) & (nxt < ne) & (ne > 0) & (ns > 0)
                   & (dur >= T(o.incline_min_duration_sec))
                   & (mag >= T(o.incline_min_bpm_change)) & (v >= 2))
            slope = change / np.where(dur > 0, dur, T(1))
            key = np.where(okk, slope if decl else -slope, inf)
        rank = (sort_less(key[None, :], key[:, None])
                | ((s[None, :] < s[:, None]) & ~sort_less(key[:, None], key[None, :]))).sum(1)
        n_ok = int(okk.sum())
        out[f"{name}.count"] = n_ok
        for f, x in zip(metrics_kernel.LIST_FIELDS, (ts, te, vs, ve, dur, change, slope)):
            col = np.full(SLOPES, nan, T)
            sel = rank < n_ok
            col[rank[sel]] = x[sel]
            out[f"{name}.{f}"] = col
    return out, info


def flatten(m: analytics.Metrics) -> dict:
    """Metrics as {"group.field": numpy (B, ...) array}."""
    return {k: x.numpy() for k, x in chip_smoke.metrics_fields(m).items()}


def emulate(positions, count, sr, cfg, T, card):
    rows = [emulate_row(positions[r], int(count[r]), sr, cfg, T, card)
            for r in range(len(count))]
    got = {k: np.stack([np.asarray(r[0][k]) for r in rows]) for k in rows[0][0]}
    return got, [r[1] for r in rows]


def assert_same(got: dict, exp: dict, label: str):
    assert set(got) == set(exp), label
    for k in exp:
        g, e = np.asarray(got[k]), np.asarray(exp[k])
        assert g.shape == e.shape, (label, k, g.shape, e.shape)
        if e.dtype.kind == "f":
            assert g.dtype == e.dtype, (label, k)
            same = (g == e) | (np.isnan(g) & np.isnan(e))
            assert same.all(), (label, k, np.flatnonzero(~same.ravel())[:5],
                                g.ravel()[~same.ravel()][:5], e.ravel()[~same.ravel()][:5])
        else:
            np.testing.assert_array_equal(g.astype(np.int64), e.astype(np.int64),
                                          err_msg=f"{label} {k}")


REACHES = {
    "counts": lambda info: [i["hrv_windows"] for i in info][:5] == [0, 0, 0, 0, 1],
    "close_beats": lambda info: all(i["dropped_diffs"] > 0 for i in info),
    "plateaus": lambda info: (sum(i["plateau_extrema"] for i in info) > 0
                              and sum(sum(i["equal_priorities"]) for i in info) > 0),
    "many_maxima": lambda info: all(any(i["work_truncated"]) for i in info),
    "many_peaks": lambda info: all(any(i["slope_truncated"]) for i in info),
    "vulpine": lambda info: all(i["hrv_windows"] > 0 for i in info),
    "fleet": lambda info: all(i["hrv_windows"] > 0 for i in info),
}


@pytest.mark.parametrize("card", [False, True], ids=["cpu_division", "card_division"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_emulation_equals_plain_version(case, dtype, card):
    """Every field bit for bit (NaN where the plain version has NaN) against
    ``compute_metrics_plain`` on the CPU, dividing as the CPU does or as the
    card does, on each case; the case reaches its path."""
    name, sr, positions, count = next(c for c in CASES if c[0] == case)
    cfg = AnalyzerConfig()
    T = np.float32 if dtype == torch.float32 else np.float64
    got, info = emulate(positions, count, sr, cfg, T, card)
    mode = CardArithmetic() if card else None
    if mode is not None:
        with mode:
            exp = analytics.compute_metrics_plain(torch.from_numpy(positions),
                                                  torch.from_numpy(count), sr, cfg, dtype)
    else:
        exp = analytics.compute_metrics_plain(torch.from_numpy(positions),
                                              torch.from_numpy(count), sr, cfg, dtype)
    assert_same(got, flatten(exp), f"{case} {dtype} card={card}")
    assert REACHES[case](info), (case, info)


def test_emulation_equals_plain_version_with_exact_hrr_interpolation():
    cfg = AnalyzerConfig(compat=CompatConfig(hrr_truncated_interp=False))
    _, sr, positions, count = next(c for c in CASES if c[0] == "vulpine")
    got, _ = emulate(positions, count, sr, cfg, np.float64, False)
    exp = analytics.compute_metrics_plain(torch.from_numpy(positions), torch.from_numpy(count),
                                          sr, cfg, torch.float64)
    assert_same(got, flatten(exp), "exact hrr")


def _with_output(**change) -> AnalyzerConfig:
    cfg = AnalyzerConfig()
    return dataclasses.replace(cfg, output=dataclasses.replace(cfg.output, **change))


@pytest.mark.parametrize("card", [False, True], ids=["cpu_division", "card_division"])
@pytest.mark.parametrize("window", [100, 300])
def test_emulation_equals_plain_version_with_wide_hrv_windows(window, card):
    """HRV windows past 64 intervals (tree widths 128 and 512): the warp's
    columns folded in bit-reversed order give the plain version's tree."""
    cfg = _with_output(hrv_window_size_beats=window, hrv_step_size_beats=window // 8)
    _, sr, positions, count = next(c for c in CASES if c[0] == "fleet")
    got, info = emulate(positions, count, sr, cfg, np.float32, card)
    with CardArithmetic() if card else contextlib.nullcontext():
        exp = analytics.compute_metrics_plain(torch.from_numpy(positions),
                                              torch.from_numpy(count), sr, cfg, torch.float32)
    assert_same(got, flatten(exp), f"hrv window {window}")
    assert all(i["hrv_windows"] > 0 for i in info)


# Beats allowed 10 ms apart put 253 slots in half the 5 s window: unbounded.
FINE = dataclasses.replace(AnalyzerConfig(), features=dataclasses.replace(
    AnalyzerConfig().features, min_peak_distance_sec=0.01))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("cfg, cap", [(FINE, CAP), (AnalyzerConfig(), 40)],
                         ids=["past_128_slots", "window_past_cap"])
def test_emulation_with_an_unbounded_window(cfg, cap, dtype, monkeypatch):
    """An unbounded smoothing window (more than 128 slots, or not below the
    capacity): the kernel's edges, the compares up to the first that fails,
    and its slot-order sums equal the plain version's bounded form at M =
    cap - 1 bit for bit, and its prefix-sum form within
    ``chip_smoke.METRICS_UNBOUNDED_RTOL``."""
    sr = chip_smoke.SR
    positions, count = chip_smoke.metrics_fleet_rows(3, cap, sr, seed=5)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    got, info = emulate(positions, count, sr, cfg, dtype, False)
    assert not any(i["bounded_window"] for i in info)
    pos_t, cnt_t = torch.from_numpy(positions), torch.from_numpy(count)
    prefix = flatten(analytics.compute_metrics_plain(pos_t, cnt_t, sr, cfg, tdtype))
    monkeypatch.setattr(analytics, "smoothing_slot_bound", lambda *a: cap - 1)
    bounded = flatten(analytics.compute_metrics_plain(pos_t, cnt_t, sr, cfg, tdtype))
    assert_same(got, bounded, "unbounded window against the bounded form")
    g, e = got["bpm.smoothed"], prefix["bpm.smoothed"]
    assert np.array_equal(np.isnan(g), np.isnan(e))
    ok = ~np.isnan(e)
    rtol = chip_smoke.METRICS_UNBOUNDED_RTOL[tdtype]
    assert np.all(np.abs(g[ok] - e[ok]) <= rtol * np.abs(e[ok]))


# ---------------------------------------------------------------------------
# The seam
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(metrics_kernel, "compute", refuse)
    _, sr, positions, count = CASES[0]
    cfg = AnalyzerConfig()
    got = analytics.compute_metrics(torch.from_numpy(positions), torch.from_numpy(count), sr,
                                    cfg, torch.float32)
    exp = analytics.compute_metrics_plain(torch.from_numpy(positions),
                                          torch.from_numpy(count), sr, cfg, torch.float32)
    assert_same(flatten(got), flatten(exp), "cpu")


def _kernel_calls(monkeypatch) -> list:
    """Record the wrapper's calls; each gives planes of its shapes on the
    ``meta`` device, which stands in for the card here."""
    calls = []

    def record(positions, count, sample_rate, cfg, dtype, max_window_slots, hrv_capacity):
        calls.append((positions.shape, dtype, max_window_slots))
        bsz, cap = positions.shape
        empty = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
        return metrics_kernel.Planes(
            series=empty(3, bsz, cap), hrv=empty(4, bsz, hrv_capacity),
            slopes=empty(2, len(metrics_kernel.LIST_FIELDS), bsz, metrics_kernel.SLOPES),
            scalars=empty(len(metrics_kernel.SCALARS), bsz),
            counts=empty(4, bsz, dt=torch.int32), found=empty(3, bsz, dt=torch.bool))

    monkeypatch.setattr(metrics_kernel, "compute", record)
    return calls


def _on_the_card(cap: int, cfg: AnalyzerConfig, sr: int, dtype) -> analytics.Metrics:
    positions = torch.zeros((2, cap), dtype=torch.int64, device="meta")
    count = torch.zeros(2, dtype=torch.int64, device="meta")
    return analytics.compute_metrics(positions, count, sr, cfg, dtype)


def _cell_config(name: str):
    from bench_port import core

    return core.program_config(core.load_json(core.HERE, "configs", f"{name}.json")["runtime"])


@pytest.mark.parametrize("config, dtype, rate", [
    ("engine-302hz", torch.float32, 302), ("exact-f64", torch.float64, 302),
    ("native-44k", torch.float32, 44100)])
def test_every_cell_takes_the_kernel_on_a_card(config, dtype, rate, monkeypatch):
    """Each benchmark configuration, at its analysis rate, capacity and
    dtype, runs the kernel on a card with its smoothing window bounded below
    the capacity (the plain version's bits), and the plain version on the
    CPU."""
    from bpm_analysis_tpu_torch import host

    cfg = _cell_config(config)
    assert host.compute_dtype(cfg) == dtype
    sr = host.post_rate(rate, cfg)
    cap = cfg.runtime.max_candidates
    calls = _kernel_calls(monkeypatch)
    m = _on_the_card(cap, cfg, sr, dtype)
    assert calls == [((2, cap), dtype, analytics.smoothing_slot_bound(sr, cfg))]
    assert calls[0][2] is not None and calls[0][2] < cap
    assert m.bpm.smoothed.shape == (2, cap) and m.inclines.count.dtype == torch.int32
    analytics.compute_metrics(torch.zeros((1, cap), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), sr, cfg, dtype)
    assert len(calls) == 1


def test_unbounded_window_and_oversized_rows_take_the_kernel(monkeypatch):
    """On a card every configuration takes the kernel: a smoothing window of
    more than 128 slots or not below the capacity, rows past a block's
    shared memory, an HRV window past 64 intervals."""
    cfg = AnalyzerConfig()
    assert analytics.smoothing_slot_bound(302, cfg) == 52
    assert analytics.smoothing_slot_bound(302, FINE) is None
    calls = _kernel_calls(monkeypatch)
    _on_the_card(1536, FINE, 302, torch.float32)
    _on_the_card(40, cfg, 302, torch.float32)
    _on_the_card(16384, cfg, 302, torch.float64)
    _on_the_card(1536, _with_output(hrv_window_size_beats=100), 302, torch.float32)
    assert calls == [((2, 1536), torch.float32, None), ((2, 40), torch.float32, 52),
                     ((2, 16384), torch.float64, 52), ((2, 1536), torch.float32, 52)]


@pytest.mark.parametrize("dtype, shape, change, what", [
    (torch.float32, (2, 64), {}, "CUDA"),
    (torch.float16, (2, 64), {}, "dtype"),
    (torch.int32, (2, 64), {}, "dtype"),
    (torch.float32, (64,), {}, "expected"),
    (torch.float32, (2, 1), {}, "capacity"),
    (torch.float32, (2, 64), {"hrv_window_size_beats": 0}, "HRV window"),
], ids=["cpu_tensors", "float16", "int32", "one_axis", "capacity_1", "hrv_window_0"])
def test_wrapper_rejects_what_the_kernel_does_not_take(dtype, shape, change, what):
    """CPU tensors, dtypes other than float32 and float64, positions that
    are not (B, cap), a capacity below 2, an HRV window below 1."""
    positions = torch.zeros(shape, dtype=torch.int32)
    count = torch.zeros(shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        metrics_kernel.compute(positions, count, 302, _with_output(**change), dtype, 52,
                               analytics.HRV_CAPACITY)
