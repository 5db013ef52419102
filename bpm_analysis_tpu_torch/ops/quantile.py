"""Exact order statistics and anchor-grid helpers for the noise floor.

Port of ``bpm_analysis_tpu/ops/quantile.py``: sortable float keys, the
radix-bisection ``select_kth``/``quantile_exact`` (pandas/numpy
linear-interpolation quantiles without a sort), the dense rolling quantiles
(the exact wavelet-tree ``rolling_quantile_centered`` and the strided
row-select ``rolling_quantile_centered_strided``), the anchor expansion
``interp_anchors`` and the NaN fills.  Every function works on the rows of
a (B, n) batch.

Keys are held in signed integer tensors of the float's width (int32 for
float32, int64 for float64) carrying the unsigned key's bit pattern; only
bitwise operations and equality touch them, so signedness never matters.
"""
from __future__ import annotations

import torch

from .indexing import arange, take
from .rolling import centered_bounds

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def _key_info(dtype: torch.dtype):
    """(integer storage dtype, key width in bits) of a float dtype."""
    if dtype not in _INT_OF:
        raise TypeError(f"unsupported float dtype {dtype}")
    itype = _INT_OF[dtype]
    return itype, torch.iinfo(itype).bits


def _signed(c: int, nbits: int) -> int:
    """An unsigned ``nbits`` constant as the signed value of the same bits."""
    c &= (1 << nbits) - 1
    return c - (1 << nbits) if c >> (nbits - 1) else c


def _sortable_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone float → key (IEEE trick: flip all bits of negatives, flip
    the sign bit of non-negatives)."""
    itype, nbits = _key_info(x.dtype)
    bits = x.contiguous().view(itype)
    sign = _signed(1 << (nbits - 1), nbits)
    return torch.where(bits < 0, ~bits, bits ^ sign)


def _key_to_float(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    _, nbits = _key_info(dtype)
    sign = _signed(1 << (nbits - 1), nbits)
    bits = torch.where(u < 0, u ^ sign, ~u)    # u < 0 <=> key's top bit set
    return bits.contiguous().view(dtype)


def select_kth(x: torch.Tensor, valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th smallest valid element of each row of ``x`` (B, n) —
    radix bisection over 4-bit digits of the sortable key.  ``k`` (B,) must
    be < the row's number of valid elements.  The per-round digit counts are
    a 16-bin histogram of the still-matching keys (integer, so exact)."""
    itype, nbits = _key_info(x.dtype)
    bsz = x.shape[0]
    keys = torch.where(valid, _sortable_key(x),
                       torch.full_like(x, 0, dtype=itype) - 1)   # all ones
    k = k.long()
    R = 4
    prefix = torch.zeros(bsz, dtype=itype, device=x.device)
    r_idx = arange(1 << R, x)
    for i in range(nbits // R):
        sh = nbits - R * (i + 1)
        high_mask = 0 if i == 0 else _signed(~((1 << (sh + R)) - 1), nbits)
        cand = (keys & high_mask) == (prefix & high_mask)[:, None]
        digit = ((keys >> sh) & ((1 << R) - 1)).long()
        hist = torch.zeros(bsz, 1 << R, dtype=torch.int64, device=x.device)
        hist.scatter_add_(1, digit, cand.long())
        cnt = torch.cumsum(hist, dim=1)[:, :-1]          # (B, 15) boundary counts
        d = (cnt <= k[:, None]).long().sum(dim=1)         # digit of the k-th
        below = torch.where(r_idx[None, 1:] == d[:, None], cnt,
                            torch.zeros_like(cnt)).sum(dim=1)
        k = k - below
        prefix = prefix | (d.to(itype) << sh)
    return _key_to_float(prefix, x.dtype)


def quantile_exact(x: torch.Tensor, q: float, valid=None) -> torch.Tensor:
    """``np.quantile(x[r][valid[r]], q)`` (linear interpolation) per row of
    (B, n) ``x`` without sorting; NaN for a row with no valid element."""
    if valid is None:
        valid = ~torch.isnan(x)
    n = valid.long().sum(dim=1)
    pos = torch.tensor(q, dtype=x.dtype, device=x.device) \
        * torch.clamp(n - 1, min=0).to(x.dtype)
    k_lo = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0),
                         torch.clamp(n - 1, min=0))
    frac = pos - k_lo.to(x.dtype)
    v_lo = select_kth(x, valid, k_lo)
    cnt_le = (valid & (x <= v_lo[:, None])).long().sum(dim=1)
    above = torch.where(valid & (x > v_lo[:, None]), x,
                        torch.full_like(x, float("inf")))
    nxt = above.amin(dim=1)
    v_hi = torch.where((cnt_le >= k_lo + 2) | (k_lo + 1 >= n), v_lo, nxt)
    out = torch.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def _build_wavelet_levels(x: torch.Tensor):
    """Wavelet tree over the ranks of each row of ``x`` (B, n), NaN ranking
    as +inf.  Returns (levels, sorted_vals, L): ``levels`` (B, L, n+1) holds
    each level's prefix sums of its bit plane (ones counts), level d laid
    out as the stable partition of the positions by the top d rank bits.
    The rank order is a stable argsort, so ties keep the JAX package's
    order and the selected ranks index the same ``sorted_vals``."""
    bsz, n = x.shape
    L = max(1, (n - 1).bit_length())
    big = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    order = torch.argsort(big, dim=1, stable=True)
    p = arange(n, x)[None, :].expand(bsz, n)
    ranks = torch.empty_like(order).scatter_(1, order, p)
    sorted_vals = torch.gather(big, 1, order)

    levels = torch.empty((bsz, L, n + 1), dtype=torch.int64, device=x.device)
    zero = torch.zeros((bsz, 1), dtype=torch.int64, device=x.device)
    true = torch.ones((bsz, 1), dtype=torch.bool, device=x.device)
    R = ranks
    for d in range(L):
        bit = (R >> (L - 1 - d)) & 1
        C = torch.cat([zero, torch.cumsum(bit, dim=1)], dim=1)
        levels[:, d] = C
        # Stable partition by this bit within each node (a run of equal top
        # d bits) gives the next level's order.
        g = R >> (L - d)
        neq_prev = torch.cat([true, g[:, 1:] != g[:, :-1]], dim=1)
        neq_next = torch.cat([g[:, :-1] != g[:, 1:], true], dim=1)
        nlo = torch.cummax(torch.where(neq_prev, p, -1), dim=1).values
        nhi = torch.cummin(torch.where(neq_next, p, n).flip(1), dim=1).values.flip(1) + 1
        c_p, c_nlo, c_nhi = C[:, :n], take(C, nlo), take(C, nhi)
        zeros_before = (p - nlo) - (c_p - c_nlo)
        ones_before = c_p - c_nlo
        nzeros = (nhi - nlo) - (c_nhi - c_nlo)
        newpos = torch.where(bit == 0, nlo + zeros_before, nlo + nzeros + ones_before)
        R = torch.empty_like(R).scatter_(1, newpos, R)
    return levels, sorted_vals, L


def _wavelet_select(levels, sorted_vals, L, lo, hi, k):
    """Range k-th smallest per query: for (B, m) ``lo``/``hi``/``k``, the
    k-th smallest element (by rank) of each row's positions [lo, hi)."""
    n = sorted_vals.shape[1]
    nlo = torch.zeros_like(lo)
    nhi = torch.full_like(lo, n)
    rank = torch.zeros_like(lo)
    for d in range(L):
        C = levels[:, d]
        c_lo, c_hi, c_nlo, c_nhi = take(C, lo), take(C, hi), take(C, nlo), take(C, nhi)
        cnt0 = (hi - lo) - (c_hi - c_lo)
        nzeros = (nhi - nlo) - (c_nhi - c_nlo)
        zeros_lo = (lo - nlo) - (c_lo - c_nlo)
        zeros_hi = (hi - nlo) - (c_hi - c_nlo)
        ones_lo = c_lo - c_nlo
        ones_hi = c_hi - c_nlo
        go_left = k < cnt0
        lo = torch.where(go_left, nlo + zeros_lo, nlo + nzeros + ones_lo)
        hi = torch.where(go_left, nlo + zeros_hi, nlo + nzeros + ones_hi)
        new_nhi = torch.where(go_left, nlo + nzeros, nhi)
        nlo = torch.where(go_left, nlo, nlo + nzeros)
        nhi = new_nhi
        k = torch.where(go_left, k, k - cnt0)
        rank = rank * 2 + (~go_left).long()
    return take(sorted_vals, torch.clamp(rank, 0, n - 1))


def rolling_quantile_centered(x: torch.Tensor, window: int, q: float,
                              min_periods: int = 1) -> torch.Tensor:
    """pandas ``rolling(window, min_periods, center=True).quantile(q)`` of
    each row of ``x`` (B, n), exact: NaN is missing, the quantile
    interpolates linearly between the two straddling order statistics of the
    window's valid values, and a window with fewer than ``min_periods`` is
    NaN.  A wavelet tree over the value ranks answers every window's range
    selection in L = ceil(log2 n) gather rounds."""
    bsz, n = x.shape
    left, right = centered_bounds(window)
    levels, sorted_vals, L = _build_wavelet_levels(x)
    idx = arange(n, x)[None, :].expand(bsz, n)
    lo = torch.clamp(idx - left, min=0)
    hi = torch.clamp(idx + right + 1, max=n)
    vsum = torch.cat([torch.zeros((bsz, 1), dtype=torch.int64, device=x.device),
                      torch.cumsum((~torch.isnan(x)).long(), dim=1)], dim=1)
    cnt = take(vsum, hi) - take(vsum, lo)
    pos = torch.tensor(q, dtype=x.dtype, device=x.device) \
        * torch.clamp(cnt - 1, min=0).to(x.dtype)
    k_lo = torch.floor(pos).long()
    k_hi = torch.minimum(k_lo + 1, torch.clamp(cnt - 1, min=0))
    frac = pos - k_lo.to(x.dtype)
    v_lo = _wavelet_select(levels, sorted_vals, L, lo, hi, k_lo)
    v_hi = _wavelet_select(levels, sorted_vals, L, lo, hi, k_hi)
    out = torch.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
    return torch.where(cnt >= min_periods, out, torch.full_like(out, float("nan")))


def _rowwise_select_kth(wins: torch.Tensor, valid: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """k-th smallest valid element along the last axis of ``wins``, for
    every leading index, by a bit-at-a-time descent over the sortable key:
    one masked count per bit plane.  The count of still-matching keys with
    a 0 at bit b is a single compare of ``key >> b`` with ``prefix >> b``
    (the prefix's bit b is still 0 then; an arithmetic shift on both sides
    leaves the compare exact), and invalid keys (all ones) never match."""
    itype, nbits = _key_info(wins.dtype)
    keys = torch.where(valid, _sortable_key(wins),
                       torch.full_like(wins, 0, dtype=itype) - 1)
    k = k.long()
    prefix = torch.zeros(keys.shape[:-1], dtype=itype, device=keys.device)
    for b in range(nbits - 1, -1, -1):
        c0 = ((keys >> b) == (prefix >> b)[..., None]).sum(dim=-1)
        take1 = k >= c0
        k = torch.where(take1, k - c0, k)
        prefix = torch.where(take1, prefix | _signed(1 << b, nbits), prefix)
    return _key_to_float(prefix, wins.dtype)


def strided_quantile_anchors(x: torch.Tensor, window: int, q: float,
                             min_periods: int = 1, stride: int = 8,
                             chunk: int = 512) -> torch.Tensor:
    """Exact pandas centered rolling quantiles of each row of ``x`` (B, n)
    at the anchors ``j * stride``: (B, ceil(n / stride)) in ``x``'s dtype.
    NaN is missing and so is everything past the row's ends.  The anchor
    windows are gathered ``chunk`` anchors at a time, which bounds memory
    to ``B * chunk * window`` elements, and reduced by the row-wise radix
    select; the next order statistic is v_lo itself when its duplicates
    reach rank k+1, else the smallest valid value above it."""
    bsz, n = x.shape
    left, right = centered_bounds(window)
    n_anchor = -(-n // stride)
    nan = float("nan")
    # Window of anchor a in padded coordinates: [a*stride, a*stride + window);
    # the anchors' last position (n_anchor-1)*stride never passes n-1.
    xpad = torch.nn.functional.pad(x, (left, right), value=nan)
    all_wins = xpad.unfold(1, window, stride)           # (B, n_anchor, window)
    qf = torch.tensor(q, dtype=x.dtype, device=x.device)
    out = []
    for a0 in range(0, n_anchor, chunk):
        wins = all_wins[:, a0:a0 + chunk]
        valid = ~torch.isnan(wins)
        counts = valid.sum(dim=-1)
        pos = qf * torch.clamp(counts - 1, min=0).to(x.dtype)
        k_lo = torch.clamp(torch.floor(pos).long(), 0, window - 1)
        frac = pos - k_lo.to(x.dtype)
        v_lo = _rowwise_select_kth(wins, valid, k_lo)
        cnt_le = (valid & (wins <= v_lo[..., None])).sum(dim=-1)
        above = torch.where(valid & (wins > v_lo[..., None]), wins,
                            torch.full_like(wins, float("inf")))
        v_hi = torch.where(cnt_le >= k_lo + 2, v_lo, above.amin(dim=-1))
        res = torch.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
        out.append(torch.where(counts >= min_periods, res, torch.full_like(res, nan)))
    if not out:
        return x.new_empty((bsz, 0))
    return torch.cat(out, dim=1)


def rolling_quantile_centered_strided(x: torch.Tensor, window: int, q: float,
                                      min_periods: int = 1, stride: int = 8,
                                      chunk: int = 512) -> torch.Tensor:
    """Strided sliding quantile of each row of ``x`` (B, n): the exact
    pandas values at the anchors ``j * stride``
    (:func:`strided_quantile_anchors`), linearly interpolated between
    them."""
    anchors = strided_quantile_anchors(x, window, q, min_periods, stride, chunk)
    return interp_anchors(anchors, x.shape[1], stride)


def interp_anchors(anchors: torch.Tensor, n: int, stride: int) -> torch.Tensor:
    """Expand per-stride anchors (B, n_anchor) to the dense grid (B, n) by
    linear interpolation; NaN anchors propagate to their span."""
    bsz, n_anchor = anchors.shape
    nxt = torch.cat([anchors[:, 1:], anchors[:, -1:]], dim=1)
    frac = torch.arange(stride, dtype=anchors.dtype, device=anchors.device) / stride
    a0 = anchors[:, :, None]
    a1 = nxt[:, :, None]
    dense = torch.where(frac > 0, a0 + frac * (a1 - a0), a0)
    return dense.reshape(bsz, n_anchor * stride)[:, :n]


def bfill_ffill(x: torch.Tensor) -> torch.Tensor:
    """pandas ``.bfill().ffill()`` per row (bpm_analysis.py:1086): the first
    valid value at or after i, else the row's last valid value."""
    n = x.shape[1]
    idx = arange(n, x)[None, :]
    valid = ~torch.isnan(x)
    # rmax[k] = max k' <= k with valid[n-1-k']  ==>  first valid >= i, or n.
    rmax = torch.cummax(torch.where(valid.flip(1), idx, -1), dim=1).values
    nxt = torch.where(rmax >= 0, (n - 1) - rmax, n).flip(1)
    last = torch.where(valid, idx, -1).amax(dim=1, keepdim=True)
    j = torch.where(nxt < n, nxt, torch.clamp(last, min=0))
    out = take(x, j)
    return torch.where((nxt < n) | (last >= 0), out, torch.full_like(x, float("nan")))


def edge_fill(x: torch.Tensor) -> torch.Tensor:
    """``bfill().ffill()`` specialized to edge-NaN runs: the leading NaN run
    takes the first valid value, the trailing run the last.  All-NaN rows
    stay all-NaN."""
    n = x.shape[1]
    idx = arange(n, x)[None, :]
    valid = ~torch.isnan(x)
    any_valid = valid.any(dim=1, keepdim=True)
    first = torch.argmax(valid.to(torch.int8), dim=1, keepdim=True)
    last = (n - 1) - torch.argmax(valid.flip(1).to(torch.int8), dim=1, keepdim=True)
    head = take(x, first)
    tail = take(x, last)
    out = torch.where(idx < first, head, torch.where(idx > last, tail, x))
    return torch.where(any_valid, out, x)
