"""Exact order statistics and anchor-grid helpers for the noise floor.

Port of the main-path parts of ``bpm_analysis_tpu/ops/quantile.py``:
sortable float keys, the radix-bisection ``select_kth``/``quantile_exact``
(pandas/numpy linear-interpolation quantiles without a sort), the anchor
expansion ``interp_anchors`` and the NaN fills.  The dense rolling
quantiles (wavelet tree, strided row select) are ROADMAP.md queue A items
11-12.

Keys are held in signed integer tensors of the float's width (int32 for
float32, int64 for float64) carrying the unsigned key's bit pattern; only
bitwise operations and equality touch them, so signedness never matters.
"""
from __future__ import annotations

import torch

from .indexing import arange, take

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
