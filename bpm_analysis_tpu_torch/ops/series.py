"""Sparse-series primitives over fixed-capacity (B, cap) arrays.

Port of ``bpm_analysis_tpu/ops/series.py``: stable compaction, the dense
piecewise-linear ``interpolate_dense`` of knot series, ``asof`` lookups,
masked quantiles, and the forward/backward fills of (value, valid) pairs
(``lax.associative_scan`` in the JAX package; a ``cummax`` over the index
of the last valid entry here).
"""
from __future__ import annotations

import torch

from .indexing import arange, scatter_drop, take


def _ffill_pairs(value: torch.Tensor, valid: torch.Tensor):
    """Forward-fill (value, valid) along the last axis, as the JAX package's
    associative scan combines them: each slot takes the value of the nearest
    valid slot at or before it (the row's first value when there is none);
    the flag says whether one exists."""
    n = value.shape[-1]
    idx = arange(n, value)[None, :]
    src = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    return take(value, torch.clamp(src, min=0)), src >= 0


def _bfill_pairs(value: torch.Tensor, valid: torch.Tensor):
    """Backward-fill (value, valid): the nearest valid slot at or after (the
    row's last value when there is none)."""
    v, f = _ffill_pairs(value.flip(-1), valid.flip(-1))
    return v.flip(-1), f.flip(-1)


def compact_valid(idx: torch.Tensor, valid: torch.Tensor, fill: int):
    """Stable-compact the valid entries of each row of ``idx`` to the front.
    Returns (compacted_idx, count); invalid slots hold ``fill``."""
    n = idx.shape[1]
    rank1 = torch.cumsum(valid.long(), dim=1)
    write = torch.where(valid, rank1 - 1, n + 1)
    compacted = scatter_drop(n, write, idx, fill, idx.dtype)
    return compacted, rank1[:, -1].to(torch.int32)


def interpolate_dense(knot_pos: torch.Tensor, knot_val: torch.Tensor,
                      count: torch.Tensor, n: int, dtype=torch.float32,
                      min_spacing=None) -> torch.Tensor:
    """Dense piecewise-linear interpolation (B, n) of each row's knots,
    ``pd.Series(val, index=pos).reindex(arange(n)).interpolate()``: linear
    between knots, NaN before the first knot, the last value after the last.

    ``knot_pos`` (B, cap) holds each row's sorted positions in its first
    ``count`` (B,) slots.  ``min_spacing`` (static) asserts adjacent knots
    are at least that far apart (trough series are, by the distance NMS)
    and selects the block form: the last knot at or before each 128-sample
    block start, then the <= K+2 knots that can bracket the block's samples
    (K bounded by the spacing), resolved by broadcast compares; otherwise a
    ``searchsorted`` over the whole grid."""
    bsz, cap = knot_pos.shape
    dev = knot_pos.device
    cnt = count.long()[:, None]
    slot = arange(cap, knot_pos)[None, :]
    kvalid = slot < cnt
    pos = torch.where(kvalid, torch.clamp(knot_pos.long(), 0, n - 1), 0)
    val = torch.where(kvalid, knot_val, torch.zeros_like(knot_val)).to(dtype)
    pos_sorted = torch.where(kvalid, pos, n)          # padded tail: n
    nan = float("nan")

    if min_spacing is None or min_spacing < 1:
        grid = arange(n, knot_pos)[None, :].expand(bsz, n).contiguous()
        # j = index of the last knot at or before each grid position.
        j = torch.searchsorted(pos_sorted.contiguous(), grid, right=True) - 1
        has_next = (j + 1) < cnt
        j0 = torch.clamp(j, 0, cap - 1)
        p0, v0 = take(pos_sorted, j0), take(val, j0)
        j1 = torch.clamp(j + 1, 0, cap - 1)
        p1 = torch.where(has_next, take(pos_sorted, j1), p0)
        v1 = torch.where(has_next, take(val, j1), v0)
        denom = torch.clamp(p1 - p0, min=1).to(dtype)
        frac = (grid - p0).to(dtype) / denom
        out = v0 + frac * (v1 - v0)            # past the last knot: frac*(0)
        out = torch.where(j >= 0, out, torch.full_like(out, nan))
        return torch.where(cnt > 0, out, torch.full_like(out, nan))

    S = 128
    K = (S - 1) // min_spacing + 2         # knots possibly inside one block
    nc = K + 2                              # candidates m = 0..K+1
    nb = -(-n // S)
    # jb[b] = last knot at or before block start b*S: seed block
    # ceil(pos/S) with the knot's index (max-combining; knots past the last
    # block start drop) and carry the max across blocks.
    b_first = -(-pos_sorted // S)
    seed = torch.full((bsz, nb + 1), -1, dtype=torch.int64, device=dev)
    seed.scatter_reduce_(1, torch.clamp(b_first, max=nb),
                         torch.where(kvalid, slot.expand(bsz, cap), -1), reduce="amax")
    jb = torch.cummax(seed[:, :nb], dim=1).values
    starts = torch.arange(nb, device=dev) * S

    m = torch.arange(nc, device=dev)
    cand = jb[:, :, None] + m                                # (B, nb, nc) knot slots
    cvalid = (cand >= 0) & (cand < cnt[:, :, None])
    candc = torch.clamp(cand, 0, cap - 1).reshape(bsz, -1)
    cpos = torch.where(cvalid, take(pos_sorted, candc).reshape(cand.shape), n)
    cval = torch.where(cvalid, take(val, candc).reshape(cand.shape),
                       torch.zeros((), dtype=dtype, device=dev))

    i = starts[:, None] + torch.arange(S, device=dev)[None, :]   # (nb, S)
    # Of the candidates m >= 1, how many knots are <= i: j(i) = jb + inc.
    le = (cpos[:, :, None, :] <= i[None, :, :, None]) & (m >= 1)
    inc = le.sum(dim=-1)                                    # (B, nb, S)
    j = jb[:, :, None] + inc

    def pick(sel):  # candidate ``sel`` of each block; 0 past the last one
        in_range = sel < nc
        selc = torch.clamp(sel, max=nc - 1)
        p = torch.where(in_range, torch.gather(cpos, 2, selc), 0)
        v = torch.where(in_range, torch.gather(cval, 2, selc),
                        torch.zeros((), dtype=dtype, device=dev))
        return p, v

    p0, v0 = pick(inc)
    has_next = (j + 1) < cnt[:, :, None]
    p1n, v1n = pick(inc + 1)
    p1 = torch.where(has_next, p1n, p0)
    v1 = torch.where(has_next, v1n, v0)
    denom = torch.clamp(p1 - p0, min=1).to(dtype)
    frac = (i - p0).to(dtype) / denom
    out = v0 + frac * (v1 - v0)
    out = torch.where((j >= 0) & (cnt[:, :, None] > 0), out, torch.full_like(out, nan))
    return out.reshape(bsz, nb * S)[:, :n]


def asof(index: torch.Tensor, values: torch.Tensor, count: torch.Tensor,
         query: torch.Tensor) -> torch.Tensor:
    """``pd.Series(values, index).asof(query)`` per row: value at the last
    index <= query; NaN if the query precedes the first index."""
    cap = index.shape[1]
    big = torch.finfo(torch.float32).max
    slot = arange(cap, index)[None, :]
    if not index.is_floating_point():
        index = index.to(torch.float32)
    idxf = torch.where(slot < count.long()[:, None], index,
                       torch.full_like(index, big))
    q = query.to(idxf.dtype).reshape(index.shape[0], -1)
    j = torch.searchsorted(idxf.contiguous(), q.contiguous(), right=True) - 1
    out = take(values, torch.minimum(torch.clamp(j, min=0),
                                     torch.clamp(count.long()[:, None] - 1, min=0)))
    out = torch.where(j < 0, torch.full_like(out, float("nan")), out)
    return out.reshape(query.shape)


def masked_quantile(x: torch.Tensor, valid: torch.Tensor, q) -> torch.Tensor:
    """``np.quantile(x[r][valid[r]], q)`` with linear interpolation per row.
    NaN for a row with no valid entry."""
    big = torch.finfo(x.dtype).max
    s = torch.sort(torch.where(valid, x, torch.full_like(x, big)), dim=1).values
    n = valid.long().sum(dim=1)
    pos = q * (n - 1).to(x.dtype)
    top = torch.clamp(n - 1, min=0)
    lo = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0), top)
    hi = torch.minimum(torch.clamp(torch.ceil(pos).long(), min=0), top)
    frac = pos - lo.to(x.dtype)
    out = take(s, lo) * (1 - frac) + take(s, hi) * frac
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``np.median`` over each row's valid entries (= quantile 0.5, linear)."""
    return masked_quantile(x, valid, 0.5)
