"""Sparse-series primitives over fixed-capacity (B, cap) arrays.

Port of the main-path parts of ``bpm_analysis_tpu/ops/series.py``: stable
compaction, ``asof`` lookups, masked quantiles, and the forward/backward
fills of (value, valid) pairs (``lax.associative_scan`` in the JAX package;
a ``cummax`` over the index of the last valid entry here).  The dense
``interpolate_dense`` belongs to the stride-1 floor (ROADMAP.md A11).
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
