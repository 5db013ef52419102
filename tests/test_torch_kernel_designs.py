"""The algorithms of the two CUDA kernels, emulated in numpy on the CPU and
held bit for bit against their plain versions.

The kernels run only on a card (tests/test_torch_cuda.py).  These tests
keep their designs checkable here: each emulation repeats its kernel's
float32 operations and its order of work, and must give the plain
version's anchors exactly (NaN positions equal, every other value equal).

* ``csrc/knot_quantile.cu``: a group of 8 lanes per anchor, lane l taking
  the window's segments m_lo + l, m_lo + l + 8, ...; each count pass sums a
  lane's segments in that order, then the group's partials by the xor
  butterfly (offsets 4, 2, 1); a segment's count in the kernel's one-floor
  form; the descent started below the key bits that the window's smallest
  and largest knot values share; the next value is the group's minimum.
  Against ``ops/knot_quantile.rolling_quantile_knots`` (float32).  numpy
  divides exactly; the kernel's fast division is held against IEEE
  division on the card (tests/test_torch_cuda.py).
* ``csrc/strided_quantile.cu``: tiles of up to 16 anchors staged once with
  missing keys mapped to one sentinel, each lane counting over its
  contiguous (odd-length) share of the window (runs of equal digits in the
  8-bit rounds over the window, key by key in the 16-bit one), a 512-bin
  histogram select with the warp's prefix scan: the top 16 bits in one
  round when the tile's keys span fewer than 512 of them (else two 8-bit
  rounds), then bits 15-8 and 7-0 over a compact list of the keys with
  v_lo's 16-bit prefix (or over the window when they are more than 128),
  and the v_hi rule (a tie in round 4's bin, its next non-empty bin, the
  smallest key above v_lo in the compact list, or the min pass).  Against
  ``ops/quantile.strided_quantile_anchors_f32_plain``.

The cases are chip_smoke.py's (the card's), the engine shapes cut to two
rows of 30,000 samples.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu_torch.ops import knot_quantile as kq
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.ops.rolling import centered_bounds

torch.set_num_threads(1)

F32 = np.float32
U32 = np.uint32
INF_BITS = 0x7F800000
MISSING = 0xFFFFFFFF
REDUCED_N = 30000


# ---------------------------------------------------------------------------
# The knot-quantile kernel
# ---------------------------------------------------------------------------
LANES, SEGS_IN_REGS = 8, 7


def _key_to_float(u):
    u = u.astype(U32)
    bits = np.where(u & U32(0x80000000), u ^ U32(0x80000000), ~u)
    return bits.astype(U32).view(F32)


def _float_to_key(f):
    bits = np.ascontiguousarray(f, F32).view(U32)
    return np.where(bits & U32(0x80000000), ~bits, bits | U32(0x80000000)).astype(U32)


def _pack(sg):
    """pack(): the registers of a count pass (the reciprocal aside)."""
    v0, dv, safe_dv, denom, sf, ef, p0f, lenf = sg
    up, down = dv > 0, dv < 0
    return (v0, np.where(up, safe_dv, np.where(down, -safe_dv, F32(1))).astype(F32),
            np.where(up | down, denom, F32(0)).astype(F32),
            np.where(up, F32(1), -p0f).astype(F32),
            np.where(up, p0f - sf, ef).astype(F32), lenf)


def _seg_count(packed, v):
    """count_at: one floor of (v - v0) / |dv| * denom serves both sloped
    kinds, as clip((f + alpha) + beta, 0, lenf) (the falling count drops the
    plain version's max with sf and takes ceil(rel) as -floor(-rel))."""
    v0, adv, denom, alpha, beta, lenf = packed
    v = v.reshape(v.shape + (1,) * (v0.ndim - 1))
    f = np.floor((v - v0) / adv * denom)
    sloped = np.minimum(np.maximum(f + alpha + beta, F32(0)), lenf)
    return np.where(denom == 0, np.where(v0 <= v, lenf, F32(0)), sloped)


def _seg_next(sg, v):
    v0, dv, safe_dv, denom, sf, ef, p0f, lenf = sg
    v = v.reshape(v.shape + (1,) * (v0.ndim - 1))
    inf = F32(np.inf)
    rel = (v - v0) / safe_dv * denom
    i_up = np.maximum(np.floor(rel) + F32(1) + p0f, sf)
    i_dn = np.minimum(np.ceil(rel) + p0f, ef) - F32(1)
    up = np.where(i_up < ef, v0 + (i_up - p0f) / denom * dv, inf)
    down = np.where(i_dn >= sf, v0 + (i_dn - p0f) / denom * dv, inf)
    cand = np.where(dv > 0, up, np.where(dv < 0, down, np.where(v0 > v, v0, inf)))
    return np.where(cand > v, cand, inf)


def _group_reduce(part, op):
    """The xor butterfly over the last axis (the group's 8 lanes); every
    lane must end with the same value."""
    lane = np.arange(LANES)
    for o in (4, 2, 1):
        part = op(part, part[..., lane ^ o])
    first = part[..., :1]
    assert ((part == first) | (np.isnan(part) & np.isnan(first))).all()
    return part[..., 0]


def emulate_knot_kernel(pos, val, count, n, window, q, min_periods, stride, min_spacing,
                        n_valid, stats):
    bsz, cap = pos.shape
    left, right = centered_bounds(window)
    n_anchor = -(-n // stride)
    nseg = min(cap + 1, window // max(min_spacing, 1) + 3)
    out = np.full((bsz, n_anchor), np.nan, F32)
    qf = F32(q)
    for b in range(bsz):
        cnt_b = min(int(count[b]), cap)
        if cnt_b == 0:
            continue
        hi_cap = n if n_valid is None else min(int(n_valid[b]), n)
        slot = np.arange(cap)
        P = np.where(slot < cnt_b, np.clip(pos[b].astype(np.int64), 0, n - 1), n)
        V = np.where(slot < cnt_b, val[b], F32(0)).astype(F32)
        a = np.arange(n_anchor)
        apos = np.minimum(a * stride, n - 1)
        w_lo = np.maximum(apos - left, 0)
        w_hi = np.minimum(apos + right + 1, hi_cap)
        base = np.searchsorted(P, w_lo, side="right") - 1
        m_lo = np.where(base < 0, -base, 0)
        m_hi = np.maximum(m_lo, np.minimum(nseg, np.searchsorted(P, w_hi, side="left") - base))
        n_j = max(1, -(-int((m_hi - m_lo).max()) // LANES))
        # Segment m_lo + lane + j * LANES of each anchor: (A, J, LANES).
        m = (m_lo[:, None, None] + np.arange(LANES)[None, None, :]
             + LANES * np.arange(n_j)[None, :, None])
        live = m < m_hi[:, None, None]
        kidx = np.clip(base[:, None, None] + m, 0, cap - 1)
        has_next = base[:, None, None] + m + 1 < cnt_b
        p0 = P[kidx]
        v0 = V[kidx]
        p1 = np.where(has_next, P[np.minimum(kidx + 1, cap - 1)], hi_cap)
        v1 = np.where(has_next, V[np.minimum(kidx + 1, cap - 1)], v0)
        s = np.maximum(p0, w_lo[:, None, None])
        e = np.minimum(p1, w_hi[:, None, None])
        ln = np.maximum(e - s, 0)
        ok = ln > 0
        dv = np.where(ok, v1 - v0, F32(0)).astype(F32)
        sg = (np.where(ok, v0, F32(np.inf)).astype(F32), dv,
              np.where(dv == 0, F32(1), dv).astype(F32),
              np.maximum(p1 - p0, 1).astype(F32), s.astype(F32), e.astype(F32),
              p0.astype(F32), ln.astype(F32))
        stats["spilled"] += int(((m_hi - m_lo) > LANES * SEGS_IN_REGS).sum())
        stats["flat"] += int((live & ok & (dv == 0)).sum())
        stats["base_below_0"] += int((base < 0).sum())

        cnt = _group_reduce((ln * live).sum(axis=1), np.add)

        packed = _pack(sg)

        def count_le(v):
            per = np.where(live, _seg_count(packed, v), F32(0))
            acc = np.zeros((n_anchor, LANES), F32)
            for j in range(n_j):             # a lane's segments, in order
                acc = acc + per[:, j, :]
            return _group_reduce(acc, np.add)


        p = qf * np.maximum(cnt - 1, 0).astype(F32)
        k_lo = np.floor(p)
        frac = p - k_lo
        target = k_lo + F32(1)
        # The descent starts below the bits that the keys of the window's
        # smallest and largest knot values share, once a pass shows that
        # the count just below the smallest misses the target.
        seg = live & ok
        v_min = np.where(seg, np.minimum(v0, v1), F32(np.inf)).min(axis=(1, 2)).astype(F32)
        v_max = np.where(seg, np.maximum(v0, v1), -F32(np.inf)).max(axis=(1, 2)).astype(F32)
        finite = ~(seg & ~(np.isfinite(v0) & np.isfinite(v1))).any(axis=(1, 2))
        k_min, k_max = _float_to_key(v_min), _float_to_key(v_max)
        below_min = count_le(_key_to_float(k_min - U32(1)))
        use = finite & (cnt > 0) & (below_min < target)
        diff = (k_min ^ k_max).astype(np.float64)
        top = np.where(use, np.where(diff == 0, -1,
                                     np.floor(np.log2(np.maximum(diff, 1))).astype(np.int64)), 31)
        keep = ~((np.uint64(2) << np.maximum(top, 0).astype(np.uint64)) - np.uint64(1))
        prefix = np.where(use, np.where(top < 0, k_max, k_max & keep.astype(U32)), 0).astype(U32)
        stats["bracketed"] += int(use.sum())
        stats["passes_saved"] += int((31 - top[use]).sum())
        for i in range(31, -1, -1):
            bit = U32(1 << i)
            c = count_le(_key_to_float(prefix | (bit - U32(1))))
            step = (i <= top) & ~(c >= target)
            prefix = np.where(step, prefix | bit, prefix).astype(U32)
        v_lo = _key_to_float(prefix)
        nxt = np.where(live, _seg_next(sg, v_lo), F32(np.inf)).min(axis=1)
        nxt = _group_reduce(nxt, np.minimum)
        c_lo = count_le(v_lo)
        v_hi = np.where(c_lo >= target + F32(1), v_lo, np.where(np.isfinite(nxt), nxt, v_lo))
        res = np.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
        out[b] = np.where(cnt >= min_periods, res, F32(np.nan))
    return out


def _knot_cases():
    cases = []
    for case in chip_smoke.kernel_cases():
        name, pos, val, cnt, n, window, stride, ms, nv = case
        if name == "engine_shapes":            # two rows, the first 30,000 samples
            keep = (pos[:2] < REDUCED_N) & (np.arange(pos.shape[1]) < cnt[:2, None])
            cnt = keep.sum(axis=1).astype(np.int32)
            pos = np.where(keep, pos[:2], REDUCED_N).astype(np.int32)
            val = np.where(keep, val[:2], 0).astype(F32)
            case = (name, pos, val, cnt, REDUCED_N, window, stride, ms, nv)
        cases.append(case)
    return cases


KNOT_CASES = _knot_cases()


@pytest.mark.parametrize("case", KNOT_CASES, ids=[c[0] for c in KNOT_CASES])
def test_knot_kernel_design_equals_plain_version(case):
    name, pos, val, cnt, n, window, stride, ms, nv = case
    stats = {"spilled": 0, "flat": 0, "base_below_0": 0, "bracketed": 0, "passes_saved": 0}
    with np.errstate(all="ignore"):
        got = emulate_knot_kernel(pos, val, cnt, n, window, 0.2, 3, stride, ms, nv, stats)
    exp = kq.rolling_quantile_knots(
        torch.from_numpy(pos), torch.from_numpy(val), torch.from_numpy(cnt), n, window, 0.2,
        min_periods=3, stride=stride, min_spacing=ms,
        n_valid=None if nv is None else torch.from_numpy(nv), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, exp)
    # The edges each case is there for.
    if name == "dense_knots_w603":
        assert stats["spilled"] > 0
    if name == "all_flat":
        assert stats["flat"] > 0 and np.isfinite(got).any()
    if name == "first_knot_past_zero":
        assert stats["base_below_0"] > 0
    if name == "no_knots":
        assert np.isnan(got).all()
    if name == "engine_shapes":
        assert stats["bracketed"] > 0 and stats["passes_saved"] > 0


# ---------------------------------------------------------------------------
# The strided-quantile kernel
# ---------------------------------------------------------------------------
BINS, PER_LANE, COMPACT = 512, 16, 128
MAX_TILE, SMEM_LIMIT = 16, 200 * 1024


def _tile(window, stride):
    """The launcher's anchors a block: as many as fit, up to 16."""
    tile = MAX_TILE
    while tile > 1 and _smem_bytes(tile, window, stride) > SMEM_LIMIT:
        tile -= 1
    return tile


def _smem_bytes(tile, window, stride):
    return (2 + tile * (1 + BINS + COMPACT) + (tile - 1) * stride + window) * 4


def _lane_hist(wk, chunk, digit, runs=True):
    """count_digits over the 32 lanes: each lane's contiguous share of the
    window, runs of equal digits among its counted keys added at once (or,
    without ``runs``, every key by itself); ``digit`` (int64) at or above
    BINS skips a key."""
    d_all = digit(wk.astype(np.int64))
    idx = np.nonzero(d_all < BINS)[0]
    hist = np.zeros(BINS, np.int64)
    if idx.size == 0:
        return hist
    if not runs:
        np.add.at(hist, d_all[idx], 1)
        return hist
    d = d_all[idx]
    lane = idx // chunk
    assert lane.max() < 32
    new_run = np.ones(idx.size, bool)
    new_run[1:] = (d[1:] != d[:-1]) | (lane[1:] != lane[:-1])
    run_len = np.diff(np.append(np.nonzero(new_run)[0], idx.size))
    np.add.at(hist, d[new_run], run_len)
    return hist


def _find_bin(hist, k):
    """find_bin: lane l owns bins 16l..16l+15; the inclusive scan of the
    lanes' sums, the first lane past k, then that lane's walk."""
    own = hist.reshape(32, PER_LANE)
    incl = np.cumsum(own.sum(axis=1))
    src = int(np.nonzero(incl > k)[0][0])
    acc = int(incl[src] - own[src].sum())
    d = PER_LANE * src + PER_LANE - 1
    for i in range(PER_LANE):
        if acc + own[src, i] > k:
            d = PER_LANE * src + i
            break
        acc += int(own[src, i])
    return d, k - acc


def _next_bin(hist, d):
    later = np.nonzero(hist[d + 1:])[0]
    return d + 1 + int(later[0]) if later.size else BINS


def emulate_strided_kernel(x, window, q, min_periods, stride, stats):
    bsz, n = x.shape
    left, _ = centered_bounds(window)
    n_anchor = -(-n // stride)
    tile = _tile(window, stride)
    chunk = ((window + 31) // 32) | 1
    bits = np.ascontiguousarray(x, F32).view(U32)
    qf = F32(q)
    out = np.full((bsz, n_anchor), np.nan, F32)
    for b in range(bsz):
        for a0 in range(0, n_anchor, tile):
            n_here = min(tile, n_anchor - a0)
            span = (n_here - 1) * stride + window
            p = a0 * stride - left + np.arange(span)
            inrow = (p >= 0) & (p < n)
            keys = np.full(span, MISSING, U32)
            keys[inrow] = bits[b, p[inrow]]
            keys[keys >= U32(INF_BITS)] = U32(MISSING)
            valid16 = keys[keys != U32(MISSING)] >> U32(16)
            lo16 = int(valid16.min()) if valid16.size else MISSING
            hi16 = int(valid16.max()) if valid16.size else 0
            fused = lo16 <= hi16 and hi16 - lo16 < BINS
            for w in range(n_here):
                wk = keys[w * stride: w * stride + window]
                if fused:
                    hist = _lane_hist(wk, chunk, lambda k: (k >> 16) - lo16, runs=False)
                    count = int(hist.sum())
                else:
                    hist = _lane_hist(wk, chunk, lambda k: k >> 24)
                    count = window - int(hist[255])
                if count == 0 or count < min_periods:
                    continue
                stats["fused" if fused else "split"] += 1
                pos = qf * F32(count - 1)
                kf = np.floor(pos)
                frac = pos - kf
                k = int(kf)
                d, k = _find_bin(hist, k)
                if fused:
                    p16 = lo16 + d
                else:
                    d1 = d
                    hist = _lane_hist(
                        wk, chunk, lambda key: np.where(key >> 24 == d1, (key >> 16) & 0xFF, BINS))
                    d, k = _find_bin(hist, k)
                    p16 = (d1 << 8) | d
                group = int(hist[d])
                compacted = group <= COMPACT
                stats["compacted" if compacted else "full_scans"] += 1
                cbuf = wk[(wk >> U32(16)) == U32(p16)].astype(np.int64)
                assert cbuf.size == group
                if compacted:
                    hist = np.bincount((cbuf >> 8) & 0xFF, minlength=BINS)
                else:
                    hist = _lane_hist(
                        wk, chunk, lambda key: np.where(key >> 16 == p16, (key >> 8) & 0xFF, BINS))
                d3, k = _find_bin(hist, k)
                above3 = _next_bin(hist, d3) < BINS
                p24 = (p16 << 8) | d3
                if compacted:
                    hist = np.bincount(cbuf[(cbuf >> 8) == p24] & 0xFF, minlength=BINS)
                else:
                    hist = _lane_hist(
                        wk, chunk, lambda key: np.where(key >> 8 == p24, key & 0xFF, BINS))
                d4, k = _find_bin(hist, k)
                prefix = (p24 << 8) | d4
                v_lo = U32(prefix).view(F32)
                res = v_lo
                if frac > 0:
                    if k + 1 < hist[d4]:
                        nxt, rule = prefix, "tie"
                    elif _next_bin(hist, d4) < BINS:
                        nxt, rule = (p24 << 8) | _next_bin(hist, d4), "next_bin"
                    elif compacted and above3:
                        nxt, rule = int(cbuf[cbuf > prefix].min()), "group_min"
                    else:
                        above = wk[wk > U32(prefix)]
                        nxt = min(int(above.min()) if above.size else MISSING, INF_BITS)
                        rule = "min_pass"
                    stats[rule] += 1
                    res = v_lo + frac * (U32(nxt).view(F32) - v_lo)
                out[b, a0 + w] = res
    return out


def _strided_cases():
    cases = []
    for case in chip_smoke.strided_kernel_cases():
        name, x, window, stride, q, mp = case
        if name == "engine_shapes":
            case = (name, np.ascontiguousarray(x[:2, :REDUCED_N]), window, stride, q, mp)
        cases.append(case)
    return cases


STRIDED_CASES = _strided_cases()
STATS = ("fused", "split", "compacted", "full_scans", "tie", "next_bin", "group_min",
         "min_pass")


@pytest.mark.parametrize("case", STRIDED_CASES, ids=[c[0] for c in STRIDED_CASES])
def test_strided_kernel_design_equals_plain_version(case):
    name, x, window, stride, q, mp = case
    stats = dict.fromkeys(STATS, 0)
    got = emulate_strided_kernel(x, window, q, mp, stride, stats)
    exp = tq.strided_quantile_anchors_f32_plain(torch.from_numpy(x), window, q, mp, stride).numpy()
    np.testing.assert_array_equal(got, exp)
    # The edges each case is there for.
    if name == "ragged_tile_w301":
        assert got.shape[1] % MAX_TILE != 0 and np.isnan(got[1]).any()
    if name == "row_shorter_than_tile":
        assert got.shape[1] < MAX_TILE
    if name == "widest_w24575":            # above 48 KB: the dynamic attribute
        tile = _tile(window, stride)
        assert (tile * BINS + (tile - 1) * stride + window) * 4 > 48 * 1024
    if name == "ties_at_v_lo":                 # groups too big for the compact list
        assert stats["tie"] > 0 and stats["full_scans"] > 0
    if name == "prefix_boundary":
        assert stats["next_bin"] > 0 and stats["min_pass"] > 0
    if name == "pallas_w603":                  # keys spanning > 512 16-bit prefixes
        assert stats["split"] > 0
    if name == "engine_shapes":
        assert stats["fused"] > 0 and stats["compacted"] > 0 and stats["group_min"] > 0


def test_strided_design_ties_and_missing_windows():
    """A window of all-equal keys gives that key (v_hi = v_lo, one bin in
    every round) and a window of only missing keys gives NaN."""
    x = np.full((1, 400), 7.25, F32)
    x[0, 250:] = np.nan
    stats = dict.fromkeys(STATS, 0)
    got = emulate_strided_kernel(x, 61, 0.3, 3, 8, stats)
    exp = tq.strided_quantile_anchors_f32_plain(torch.from_numpy(x), 61, 0.3, 3, 8).numpy()
    np.testing.assert_array_equal(got, exp)
    assert (got[0, :25] == F32(7.25)).all() and np.isnan(got[0, -10:]).all()
    assert stats["tie"] > 0 and stats["next_bin"] == stats["min_pass"] == 0
    assert stats["fused"] > 0
