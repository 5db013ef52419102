"""scipy.signal.find_peaks semantics over (B, n) tensors, fixed capacity.

Port of ``bpm_analysis_tpu/ops/find_peaks.py``: the shared extrema
decomposition and its extrema-domain prominences (the default trough and
raw-peak finders), and the dense sparse-table prominences (the
``prominence_backend="dense"`` finders, which share one table pair, and the
BPM-curve slope search on its short series).  Semantics, as in the JAX
package:

* local maxima use strict neighbors with plateau support — a flat top emits
  one peak at ``(left_edge + right_edge) // 2``,
* filter order is height → distance → prominence (the raw-peak height
  filter applies to the shared extrema's candidates, ``pipeline.raw_peaks``),
* the distance filter is the greedy highest-first suppression with
  ``ceil(distance)`` spacing, strict ``<``, and equal priorities processed
  later-slot first (docs/ARCHITECTURE.md item 14).  The priority keys are
  made unique by that slot rule; no sort order among equal values is relied
  on.  On the card it is one launch of ``csrc/distance_nms.cu`` with every
  round on the device; on the CPU the plain rounds with a host read each.
* prominence of a peak is ``x[p] - max(min(x[lb..p]), min(x[p..rb]))``
  (``wlen=None``), falling back to the signal edges.

Every capacity truncates with the ``overflowed`` flag set.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda import nms_kernel
from .indexing import arange, scatter_drop, take
from .quantile import _sortable_key
from ..device import upload
from ..utils.profiling import host_read, span


class Peaks(NamedTuple):
    positions: torch.Tensor   # (B, capacity) int32; slots >= count hold n
    count: torch.Tensor       # (B,) int32
    overflowed: torch.Tensor  # (B,) bool: a capacity truncated the population


def _shift_right(a: torch.Tensor, m: int, fill) -> torch.Tensor:
    """a[:, i - m] (float ``a``) with out-of-range slots = fill."""
    if m >= a.shape[1]:
        return torch.full_like(a, fill)
    return torch.nn.functional.pad(a[:, :-m], (m, 0), value=fill)


def _shift_left(a: torch.Tensor, m: int, fill) -> torch.Tensor:
    """a[:, i + m] (float ``a``) with out-of-range slots = fill."""
    if m >= a.shape[1]:
        return torch.full_like(a, fill)
    return torch.nn.functional.pad(a[:, m:], (0, m), value=fill)


def _shifted(a: torch.Tensor, m: int, fill) -> torch.Tensor:
    """a[:, i + m] for any sign of m, out-of-range slots = fill."""
    if abs(m) >= a.shape[1]:
        return torch.full_like(a, fill)
    if m < 0:
        return torch.cat([torch.full((a.shape[0], -m), fill, dtype=a.dtype,
                                     device=a.device), a[:, :m]], dim=1)
    if m > 0:
        return torch.cat([a[:, m:], torch.full((a.shape[0], m), fill,
                                               dtype=a.dtype, device=a.device)], dim=1)
    return a


def _run_geometry(x: torch.Tensor):
    """Plateau runs of each row: (neq_prev, neq_next, ok, midpoint flag,
    prev value, next value), shared by both kinds of extremum."""
    n = x.shape[1]
    idx = arange(n, x)[None, :]
    ones = torch.ones(x.shape[0], 1, dtype=torch.bool, device=x.device)
    neq_prev = torch.cat([ones, x[:, 1:] != x[:, :-1]], dim=1)
    neq_next = torch.cat([x[:, :-1] != x[:, 1:], ones], dim=1)
    run_start = torch.cummax(torch.where(neq_prev, idx, -1), dim=1).values
    run_end = torch.cummin(torch.where(neq_next, idx, n).flip(1), dim=1).values.flip(1)
    rs = torch.clamp(run_start, min=0)
    re = torch.clamp(run_end, max=n - 1)
    ok = (rs >= 1) & (re <= n - 2)
    prev_v = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    next_v = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    midpoint = ok & (idx == (rs + re) // 2)
    return idx, neq_prev, neq_next, midpoint, prev_v, next_v


def _boundary(idx, neq_prev, neq_next, prev_lower, next_lower):
    """Whether the sample before each run start / after each run end is
    lower, carried across the run with the ``2*i + bit`` cummax trick."""
    lcode = torch.where(neq_prev, 2 * idx + prev_lower.long(), -1)
    left = (torch.cummax(lcode, dim=1).values & 1) == 1
    rcode = torch.where(neq_next.flip(1), 2 * idx + next_lower.flip(1).long(), -1)
    right = ((torch.cummax(rcode, dim=1).values & 1) == 1).flip(1)
    return left & right


def local_maxima_mask(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of plateau-midpoint local maxima (scipy semantics)."""
    idx, neq_prev, neq_next, midpoint, prev_v, next_v = _run_geometry(x)
    return midpoint & _boundary(idx, neq_prev, neq_next, prev_v < x, next_v < x)


def local_extrema_masks(x: torch.Tensor):
    """(maxima mask, minima mask) in one pass over the run geometry."""
    idx, neq_prev, neq_next, midpoint, prev_v, next_v = _run_geometry(x)
    mmax = midpoint & _boundary(idx, neq_prev, neq_next, prev_v < x, next_v < x)
    mmin = midpoint & _boundary(idx, neq_prev, neq_next, prev_v > x, next_v > x)
    return mmax, mmin


def _compact_values(mask: torch.Tensor, values: torch.Tensor, k: int, fill):
    """The first ``k`` entries of ``values`` where ``mask`` holds, in order
    (rank scatter), padded with ``fill``; plus the full masked count."""
    rank = torch.cumsum(mask.long(), dim=1) - 1
    write = torch.where(mask, rank, k)
    out = scatter_drop(k, write, values, fill, values.dtype)
    return out, mask.long().sum(dim=1)


def _pad_to(a: torch.Tensor, width: int, fill) -> torch.Tensor:
    if a.shape[1] >= width:
        return a
    return torch.cat([a, torch.full((a.shape[0], width - a.shape[1]), fill,
                                    dtype=a.dtype, device=a.device)], dim=1)


def _compact_mask(mask: torch.Tensor, capacity: int) -> Peaks:
    """Stable compaction of each row's mask indices into ``capacity`` slots
    (fill n), with the overflow flag."""
    n = mask.shape[1]
    k = min(capacity, n)
    idx = arange(n, mask, torch.int32)[None, :].expand_as(mask)
    out, total = _compact_values(mask, idx, k, n)
    count = torch.clamp(total, max=capacity)
    return Peaks(_pad_to(out, capacity, n), count.to(torch.int32), total > capacity)


def _sparse_table(x: torch.Tensor, op, levels: Optional[int] = None) -> torch.Tensor:
    """Table (B, L, n) with T[:, k, i] = op-reduction of x[:, i : i + 2^k]
    (clamped at the end)."""
    n = x.shape[1]
    if levels is None:
        levels = max(1, (n - 1).bit_length())
    levels = max(1, min(levels, (n - 1).bit_length() or 1))
    rows = [x]
    cur = x
    for k in range(1, levels):
        shift = 1 << (k - 1)
        shifted = torch.cat([cur[:, shift:], cur[:, -1:].expand(-1, shift)], dim=1)
        cur = op(cur, shifted)
        rows.append(cur)
    return torch.stack(rows, dim=1)


def _table_at(table: torch.Tensor, k: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """table[b, k, i] for per-query level ``k`` and index ``i`` (B, q),
    clamped as a JAX gather clamps."""
    _, levels, n = table.shape
    k = torch.clamp(k, 0, levels - 1)
    i = torch.clamp(i, 0, n - 1)
    return take(table.reshape(table.shape[0], -1), k * n + i)


def _range_query(table: torch.Tensor, a: torch.Tensor, b: torch.Tensor, op) -> torch.Tensor:
    """op-reduction over x[a..b] inclusive via two overlapping power-of-two
    windows; ``a``, ``b`` (B, q)."""
    levels = table.shape[1]
    length = torch.clamp(b - a + 1, min=1)
    # floor(log2(length)): length <= n <= 2^levels, so counting the powers
    # up to 2^levels is exact.
    k = torch.zeros_like(length)
    for j in range(1, levels + 1):
        k += (length >= (1 << j)).long()
    left = _table_at(table, k, a)
    right = _table_at(table, k, torch.clamp(
        b - torch.bitwise_left_shift(torch.ones_like(k), k) + 1, min=0))
    return op(left, right)


def _last_above(max_table: torch.Tensor, v: torch.Tensor, r: torch.Tensor,
                flip: bool = False) -> torch.Tensor:
    """Largest i in [0, r] with x[i] > v, or -1 — dyadic sparse-table
    descent.  ``flip=True`` reads the table as the MIN-table of ``-x`` (and
    ``v`` as ``-v``)."""
    levels = max_table.shape[1]
    pos = r + 1
    for k in reversed(range(levels)):
        step = 1 << k
        seg = take(max_table[:, k], torch.clamp(pos - step, min=0))
        move = (pos >= step) & ((seg >= v) if flip else (seg <= v))
        pos = torch.where(move, pos - step, pos)
    return pos - 1


def _first_above(max_table: torch.Tensor, v: torch.Tensor, l: torch.Tensor,
                 flip: bool = False) -> torch.Tensor:
    """Smallest i in [l, n-1] with x[i] > v, or n — mirror descent."""
    _, levels, n = max_table.shape
    pos = l
    for k in reversed(range(levels)):
        step = 1 << k
        seg = take(max_table[:, k], torch.clamp(pos, max=n - 1))
        move = (pos < n) & ((seg >= v) if flip else (seg <= v))
        pos = torch.clamp(torch.where(move, pos + step, pos), max=n)
    return pos


def peak_prominences(x: torch.Tensor, positions: torch.Tensor,
                     valid: torch.Tensor, max_table: Optional[torch.Tensor] = None,
                     min_table: Optional[torch.Tensor] = None,
                     tables_negated: bool = False) -> torch.Tensor:
    """Prominence of each valid peak position (B, q), scipy ``wlen=None``,
    via sparse-table descents over the dense signal.

    ``max_table``/``min_table``: precomputed (B, L, n) tables of ``x``, or
    with ``tables_negated=True`` of ``-x`` (the trough finder on ``-env``
    reusing the envelope's pair): descents then flip their comparisons and
    range results flip sign, so no table is negated."""
    n = x.shape[1]
    if max_table is None or min_table is None:
        max_table = _sparse_table(x, torch.maximum)
        min_table = _sparse_table(x, torch.minimum)
        tables_negated = False
    p = torch.clamp(positions.long(), 0, n - 1)
    v = take(x, p)
    if tables_negated:
        # max of x over a block == -(min of -x); min of x == -(max of -x).
        lb = _last_above(min_table, -v, p, flip=True) + 1
        rb = _first_above(min_table, -v, p, flip=True) - 1
        left_min = -_range_query(max_table, torch.clamp(lb, min=0), p, torch.maximum)
        right_min = -_range_query(max_table, p, torch.clamp(rb, max=n - 1),
                                  torch.maximum)
    else:
        lb = _last_above(max_table, v, p) + 1
        rb = _first_above(max_table, v, p) - 1
        left_min = _range_query(min_table, torch.clamp(lb, min=0), p, torch.minimum)
        right_min = _range_query(min_table, p, torch.clamp(rb, max=n - 1),
                                 torch.minimum)
    prom = v - torch.maximum(left_min, right_min)
    return torch.where(valid, prom, torch.zeros_like(prom))


class Extrema(NamedTuple):
    """Shared extrema decomposition of a (B, n) signal for
    ``extrema_prominences`` (see the JAX package's ``Extrema``): slot 0 of
    each heights array holds ``x[0]`` and slot ``count+1`` holds ``x[n-1]``;
    ``max_heights`` pads with -inf and ``min_heights`` with +inf."""
    max_heights: torch.Tensor    # (B, cap)
    min_heights: torch.Tensor    # (B, cap)
    max_positions: torch.Tensor  # (B, cap-2) int32 real maxima, fill n
    min_positions: torch.Tensor  # (B, cap-2) int32 real minima, fill n
    first_is_max: torch.Tensor   # (B,) bool
    max_count: torch.Tensor      # (B,) int32
    min_count: torch.Tensor      # (B,) int32
    union_rank: torch.Tensor     # (B, n) 1-based rank among ALL extrema
    max_table: torch.Tensor      # (B, L, cap) sparse MAX table of max_heights
    min_table: torch.Tensor      # (B, L, cap) sparse MIN table of min_heights
    overflowed: torch.Tensor     # (B,) bool


def build_extrema(x: torch.Tensor, capacity: int) -> Extrema:
    """Extrema arrays of ``x`` (edge-held already, if padded).  ``capacity``
    includes the two virtual edge slots.  Extrema strictly alternate, so the
    per-kind arrays split off the compacted union by slot parity."""
    bsz, n = x.shape
    real_cap = capacity - 2
    union_cap = 2 * real_cap
    mmax, mmin = local_extrema_masks(x)
    both = mmax | mmin

    idx = arange(n, x)[None, :]
    rank_u1 = torch.cumsum(both.long(), dim=1)
    uk = min(union_cap, n)
    enc, u_total = _compact_values(both, 2 * idx + mmax.long(), uk, 2 * n)
    enc = _pad_to(enc, union_cap, 2 * n)
    u_count = torch.clamp(u_total, max=union_cap)
    first_is_max = (u_count > 0) & ((enc[:, 0] & 1) == 1)

    neg_inf, pos_inf = float("-inf"), float("inf")
    even, odd = enc[:, 0::2], enc[:, 1::2]
    fim = first_is_max[:, None]
    enc_max = torch.where(fim, even, odd)
    enc_min = torch.where(fim, odd, even)
    cm = (u_count + first_is_max.long()) // 2
    cv = u_count - cm
    slot_r = arange(real_cap, x)[None, :]

    def unpack(enc_k, cnt, fill_h):
        ok = slot_r < cnt[:, None]
        pos = torch.where(ok, enc_k >> 1, n)
        hts = torch.where(ok, take(x, torch.clamp(pos, 0, n - 1)),
                          torch.full_like(x[:, :1], fill_h))
        return pos, hts

    max_pos, max_h = unpack(enc_max, cm, neg_inf)
    min_pos, min_h = unpack(enc_min, cv, pos_inf)

    def with_virtuals(hts, cnt, fill):
        out = torch.cat([x[:, :1], hts, torch.full((bsz, 1), fill, dtype=x.dtype,
                                                   device=x.device)], dim=1)
        return out.scatter(1, (cnt + 1)[:, None], x[:, n - 1:n])

    mh = with_virtuals(max_h, cm, neg_inf)
    vh = with_virtuals(min_h, cv, pos_inf)
    return Extrema(
        max_heights=mh, min_heights=vh,
        max_positions=max_pos.to(torch.int32), min_positions=min_pos.to(torch.int32),
        first_is_max=first_is_max, max_count=cm.to(torch.int32),
        min_count=cv.to(torch.int32), union_rank=rank_u1,
        max_table=_sparse_table(mh, torch.maximum),
        min_table=_sparse_table(vh, torch.minimum),
        overflowed=u_total > union_cap,
    )


def compact_slots(keep: torch.Tensor, capacity: int, arrays_with_fills):
    """Stable compaction of several aligned (B, n) arrays by one mask.
    Returns (list, count, overflow)."""
    n = keep.shape[1]
    k = min(capacity, n)
    slot = arange(n, keep)[None, :].expand_as(keep)
    src, total = _compact_values(keep, slot, k, 0)
    count = torch.clamp(total, max=capacity)
    ok = arange(k, keep)[None, :] < count[:, None]
    outs = []
    for arr, fill in arrays_with_fills:
        o = torch.where(ok, take(arr, src), upload("fill", fill, arr.dtype, arr.device))
        outs.append(_pad_to(o, capacity, fill))
    return outs, count.to(torch.int32), total > capacity


def extrema_prominences(
    ext: Extrema,
    positions: torch.Tensor,
    valid: torch.Tensor,
    negated: bool = False,
    sweep_window: int = 64,
    residual_capacity: int = 2048,
):
    """Prominences of peaks that are local maxima of the signal ``ext`` was
    built on (``negated=False``) or of its negation (troughs), bit-identical
    to ``peak_prominences`` on the dense signal.  The nearest-taller search
    runs as ``sweep_window`` shifted compares; slots taller than their whole
    window fall to a sparse-table descent over at most
    ``residual_capacity`` slots (overflow sets the returned flag).
    Returns ``(prominences_at_positions, overflowed)``."""
    W = sweep_window
    cap = ext.max_heights.shape[1]
    if negated:
        peak_h, valley_h = ext.min_heights, ext.max_heights
        fim = ~ext.first_is_max
        peak_count = ext.min_count
        fillP, fillV = float("inf"), float("-inf")
        taller = torch.lt
        vred = torch.maximum
        desc_table, desc_flip = ext.min_table, True
        valley_table, valley_op = ext.max_table, torch.maximum
    else:
        peak_h, valley_h = ext.max_heights, ext.min_heights
        fim = ext.first_is_max
        peak_count = ext.max_count
        fillP, fillV = float("-inf"), float("inf")
        taller = torch.gt
        vred = torch.minimum
        desc_table, desc_flip = ext.max_table, False
        valley_table, valley_op = ext.min_table, torch.minimum

    slot = arange(cap, peak_h)[None, :]
    fim_b = fim[:, None]
    VL = torch.where(fim_b, _shift_right(valley_h, 1, fillV), valley_h)
    VR = torch.where(fim_b, valley_h, _shift_left(valley_h, 1, fillV))

    def sweep(shift, vsel):
        found = torch.zeros_like(peak_h, dtype=torch.bool)
        res = torch.full_like(peak_h, fillV)
        acc = vsel
        for m in range(1, W + 1):
            t = taller(shift(peak_h, m, fillP), peak_h)
            res = torch.where(t & ~found, acc, res)
            found = found | t
            acc = vred(acc, shift(vsel, m, fillV))
        return res, found, acc

    l_res, l_found, l_acc = sweep(_shift_right, VL)
    r_res, r_found, r_acc = sweep(_shift_left, VR)
    left_min = torch.where(l_found, l_res, l_acc)
    right_min = torch.where(r_found, r_res, r_acc)
    l_resolved = l_found | (slot <= W)
    r_resolved = r_found | (slot + W >= peak_count.long()[:, None] + 1)

    # Position -> peak slot: one union-rank gather, then parity arithmetic.
    n = ext.union_rank.shape[1]
    u = take(ext.union_rank, torch.clamp(positions.long(), 0, n - 1)) - 1
    off = 1 - fim_b.long()
    ranks_at = torch.clamp(u - off, min=0) // 2 + 1
    ranks_at = torch.where(valid, ranks_at, cap)
    is_peak = scatter_drop(cap, ranks_at, True, False, torch.bool)
    fim_off = fim_b.long()

    def residual(resolved, desc, vlo, vhi):
        need = is_peak & ~resolved
        sel = _compact_mask(need, residual_capacity)
        sp = sel.positions.long()
        s = torch.clamp(sp, 0, cap - 1)
        v = take(peak_h, s)
        j = desc(v, s)
        val = _range_query(valley_table, vlo(s, j), vhi(s, j), valley_op)
        ok = arange(residual_capacity, s)[None, :] < sel.count.long()[:, None]
        return (torch.where(ok, val, torch.full_like(val, fillV)),
                torch.where(ok, sp, cap), sel.overflowed)

    lv, ls, lo = residual(
        l_resolved,
        lambda v, s: _last_above(desc_table, v, s - W - 1, flip=desc_flip),
        lambda s, j: torch.clamp(j + 1 - fim_off, min=0),
        lambda s, j: s - fim_off)
    rv, rs, ro = residual(
        r_resolved,
        lambda v, s: _first_above(desc_table, v, s + W + 1, flip=desc_flip),
        lambda s, j: s + 1 - fim_off,
        lambda s, j: torch.clamp(j - fim_off, max=cap - 1))
    left_min = scatter_drop(left_min.shape[1], ls, lv, base=left_min)
    right_min = scatter_drop(right_min.shape[1], rs, rv, base=right_min)

    if negated:
        prom_slots = torch.minimum(left_min, right_min) - peak_h
    else:
        prom_slots = peak_h - torch.maximum(left_min, right_min)
    prom = take(prom_slots, torch.clamp(ranks_at, 0, cap - 1))
    prom = torch.where(valid, prom, torch.zeros_like(prom))
    return prom, lo | ro | ext.overflowed


def _window_slots(distance, cap: int) -> int:
    """The slots a window spans on each side in the plain version's shifted
    compares: ``ceil(distance) // 2 + 2`` for a static distance (candidates
    are local maxima, at least 2 samples apart), the whole row for a
    per-row one."""
    if isinstance(distance, (int, float)):
        return int(-(-distance // 1)) // 2 + 2
    return cap


def _select_by_distance(positions: torch.Tensor, priority: torch.Tensor,
                        valid: torch.Tensor, distance, length: int) -> torch.Tensor:
    """scipy ``_select_by_peak_distance`` per row: the keep mask of the
    greedy keep-highest suppression (:func:`_select_by_distance_plain`).
    Positions lie below ``length`` and are sorted ascending over the valid
    slots, each row's prefix.  A CPU tensor takes the plain version; any
    other launches the distance-NMS kernel (``ops/cuda/nms_kernel``,
    bit-equal to the plain version, every round on the card, no host read),
    with a static ``distance`` by value and a per-row one as float32."""
    if positions.device.type == "cpu":
        return _select_by_distance_plain(positions, priority, valid, distance)
    bsz, cap = positions.shape
    if isinstance(distance, torch.Tensor):
        distance = distance.to(device=positions.device, dtype=torch.float32) \
            .reshape(-1).expand(bsz).contiguous()
    win = _window_slots(distance, cap)
    # Windows of up to 128 slots come from the shifted compares, which
    # reach ``win`` slots; wider ones from binary searches over the row.
    return nms_kernel.select_by_distance(
        positions.contiguous(), priority.contiguous(), valid.contiguous(), distance,
        win if win <= 128 else cap, length)


def _select_by_distance_plain(positions: torch.Tensor, priority: torch.Tensor,
                              valid: torch.Tensor, distance) -> torch.Tensor:
    """The plain version of :func:`_select_by_distance`: the fixed point of
    "survives iff no surviving higher-ranked peak lies within ``distance``"
    by parallel rounds (each round keeps every alive peak that wins its
    whole neighborhood and kills the neighbors it beats), one host read a
    round.  ``distance`` is a static number or a (B,) tensor.  Returns the
    keep mask."""
    bsz, cap = positions.shape
    dev = positions.device
    static = isinstance(distance, (int, float))
    dist = torch.ceil(upload("distance", distance, torch.float32, dev))
    dist = dist.reshape(-1, 1).expand(bsz, 1) if dist.dim() else dist.reshape(1, 1)
    f32min = torch.finfo(torch.float32).min
    prio = torch.where(valid, priority.to(torch.float32),
                       torch.full((), f32min, device=dev))
    slots_f = torch.arange(cap, dtype=torch.float32, device=dev)[None, :]
    posf_v = positions.to(torch.float32)
    base = torch.where(valid, posf_v, torch.full((), float("-inf"), device=dev)) \
        .amax(dim=1, keepdim=True) + dist + 1.0
    # Padding slots spread beyond every real window (pairwise gaps > dist).
    posf = torch.where(valid, posf_v, base + slots_f * (dist + 1.0))
    win = _window_slots(distance, cap)
    slot_idx = arange(cap, positions)[None, :]
    if win <= 128:
        cnt_prev = torch.zeros(bsz, cap, dtype=torch.int64, device=dev)
        cnt_next = torch.zeros_like(cnt_prev)
        for m in range(1, win + 1):
            prev_m = _shift_right(posf, m, float("-inf"))
            cnt_prev += (prev_m > posf - dist).long()
            next_m = _shift_left(posf, m, float("inf"))
            cnt_next += (next_m < posf + dist).long()
        lo = slot_idx - cnt_prev
        hi = slot_idx + cnt_next
    else:
        lo = torch.searchsorted(posf, posf - dist, right=True)
        hi = torch.searchsorted(posf, posf + dist, right=False) - 1
    nms_levels = (2 * int(-(-distance // 1)) + 1).bit_length() if static else None

    if win <= 32:
        # Each window's winner is the lexicographic max of (key, slot); the
        # key is the priority's sortable bit pattern (unsigned, held in
        # int64), and +0.0 flushes -0.0 so key equality is float equality.
        # Key 0 sits below every real key and marks masked-out candidates.
        key = _sortable_key(prio + 0.0).long() & 0xFFFFFFFF
        offs = range(-win, win + 1)
        i_ms = [slot_idx + m for m in offs]
        ok_ms = [(i_m >= lo) & (i_m <= hi) for i_m in i_ms]

        def body(keep, alive):
            akey = torch.where(alive, key, 0)
            best = torch.zeros_like(key)
            winner = torch.full_like(key, -1)
            for m, i_m, ok in zip(offs, i_ms, ok_ms):
                k_m = torch.where(ok, _shifted(akey, m, 0), 0)
                better = (k_m > best) | ((k_m == best) & (i_m > winner) & (k_m > 0))
                best = torch.where(better, k_m, best)
                winner = torch.where(better, i_m, winner)
            new_keep = alive & (winner == slot_idx)
            killed = torch.zeros_like(alive)
            for m, ok in zip(offs, ok_ms):
                killed = killed | (ok & _shifted(new_keep, m, False))
            return keep | new_keep, alive & ~new_keep & ~killed
    else:
        # Explicit processing-order ranks (stable argsort descending, later
        # slot first among equal priorities) + sparse-table range-min rounds.
        order = torch.argsort(prio, dim=1, stable=True).flip(1)
        rank = torch.empty_like(order).scatter_(
            1, order, arange(cap, order)[None, :].expand(bsz, cap))
        big = cap

        def body(keep, alive):
            t_alive = _sparse_table(torch.where(alive, rank, big), torch.minimum,
                                    levels=nms_levels)
            new_keep = alive & (_range_query(t_alive, lo, hi, torch.minimum) == rank)
            t_keep = _sparse_table(torch.where(new_keep, rank, big), torch.minimum,
                                   levels=nms_levels)
            killed = _range_query(t_keep, lo, hi, torch.minimum) < big
            return keep | new_keep, alive & ~new_keep & ~killed

    keep = torch.zeros_like(valid)
    alive = valid
    while host_read("nms", alive.any()):      # one host sync per round
        with span("bpm.nms.round"):
            keep, alive = body(keep, alive)
    return keep & valid


def distance_capacity_bound(n: int, distance) -> int:
    """Static upper bound on distance-NMS survivors: spacing >= ceil(distance)
    caps them at n/ceil(distance)+1 (rounded up to a multiple of 128)."""
    return -(-(n // max(int(-(-distance // 1)), 1) + 2) // 128) * 128


def _recompact(pos: torch.Tensor, keep: torch.Tensor, n: int):
    cap = pos.shape[1]
    out, count = _compact_values(keep, pos, cap, n)
    return out, count


def find_peaks(
    x: torch.Tensor,
    capacity: int,
    height=None,
    prominence=None,
    distance=None,
    work_capacity: Optional[int] = None,
    prominence_capacity: Optional[int] = None,
    extrema: Optional[Extrema] = None,
    extrema_negated: bool = False,
    prominence_sweep_window: int = 64,
    prominence_residual_capacity: int = 2048,
    candidates: Optional[Peaks] = None,
    priorities: Optional[torch.Tensor] = None,
    max_table: Optional[torch.Tensor] = None,
    min_table: Optional[torch.Tensor] = None,
    tables_negated: bool = False,
) -> Peaks:
    """scipy.signal.find_peaks(x[r], height=..., prominence=...,
    distance=...) for every row of ``x`` (B, n), with fixed output capacity.

    ``height``: scalar, (B,) or a per-sample (B, n) threshold evaluated at
    the peak positions (the raw-peak finder's noise floor); ``prominence``:
    scalar or (B,); ``distance``: static number or (B,).
    ``candidates``/``priorities``: pre-compacted candidate maxima from a
    shared :class:`Extrema` (height already applied), replacing the dense
    local-maxima mask.  ``extrema``: prominences in the extrema domain
    instead of dense sparse tables; ``max_table``/``min_table``
    (``tables_negated``): shared dense tables for ``peak_prominences``.
    ``work_capacity`` bounds the candidate
    population and ``prominence_capacity`` the prominence slot axis; both
    truncate with the overflow flag set."""
    bsz, n = x.shape
    if candidates is not None:
        work_capacity = candidates.positions.shape[1]
        peaks = candidates
        prio_arr = priorities
    else:
        work_capacity = work_capacity or 4 * capacity
        mask = local_maxima_mask(x)
        if height is not None:
            h = upload("height", height, x.dtype, x.device)
            mask = mask & (x >= (h[:, None] if h.dim() == 1 else h))
        peaks = _compact_mask(mask, work_capacity)
        prio_arr = None
    slot = arange(work_capacity, x)[None, :]
    valid = slot < peaks.count.long()[:, None]
    pos = torch.where(valid, peaks.positions.long(), n - 1)
    truncated = peaks.overflowed

    if distance is not None:
        prio = take(x, pos) if prio_arr is None else prio_arr
        keep = _select_by_distance(pos, prio, valid, distance, n)
        pos, count = _recompact(pos, keep, n)
        if isinstance(distance, (int, float)):
            # Static survivor bound: spacing >= ceil(distance).
            bound = n // max(int(-(-distance // 1)), 1) + 2
            lim = min(work_capacity, -(-bound // 128) * 128)
            if prominence_capacity is not None:
                lim = min(lim, -(-prominence_capacity // 128) * 128)
            pos = pos[:, :lim]
            truncated = truncated | (count > lim)
            count = torch.clamp(count, max=lim)
        slot = arange(pos.shape[1], x)[None, :]
        valid = slot < count[:, None]
        pos = torch.where(valid, pos, n - 1)
    else:
        count = peaks.count.long()

    if prominence is not None:
        if extrema is not None:
            prom, prom_ovf = extrema_prominences(
                extrema, pos, valid, negated=extrema_negated,
                sweep_window=prominence_sweep_window,
                residual_capacity=prominence_residual_capacity)
            truncated = truncated | prom_ovf
        else:
            prom = peak_prominences(x, pos, valid, max_table=max_table,
                                    min_table=min_table,
                                    tables_negated=tables_negated)
        thr = upload("prominence", prominence, x.dtype, x.device)
        if thr.dim() == 1:
            thr = thr[:, None]
        keep = valid & (prom >= thr)
        pos, count = _recompact(pos, keep, n)
        valid = slot < count[:, None]
        pos = torch.where(valid, pos, n - 1)

    out = torch.where(valid, pos, n)
    out_pos = _pad_to(out, capacity, n)[:, :capacity].to(torch.int32)
    overflowed = truncated | (count > capacity)
    return Peaks(out_pos, torch.clamp(count, max=capacity).to(torch.int32), overflowed)
