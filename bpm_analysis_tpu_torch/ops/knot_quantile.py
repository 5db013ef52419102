"""Rolling quantile computed directly in the knot domain — plain version.

Port of ``bpm_analysis_tpu/ops/knot_quantile.py``, batched.  The noise floor
is a centered rolling quantile of the piecewise-linear interpolation of
~2k trough knots over ~181k samples.  Per anchor, the window's samples lie
on the <= ``window // min_spacing + 3`` knot segments that can meet it, and
``#{i : y(i) <= v}`` on one segment is a floor/ceil expression, so the k-th
order statistic comes from a bit-prefix descent over the float's sortable
key space with one closed-form count pass per step — the dense series is
never built.

:func:`rolling_quantile_knots` is the plain PyTorch version of the CUDA
kernel in ``csrc/knot_quantile.cu`` (wrapper ``ops/cuda/knot_kernel.py``):
the CPU path and the reference the kernel is held against on the card.  It
repeats the kernel's arithmetic operation for operation (no fused
multiply-adds on either side).  :func:`knot_quantile_anchors_f32` makes the
CPU-or-card choice for the kernel's float32 contract.
"""
from __future__ import annotations

import torch

from ..device import upload
from .cuda import knot_kernel
from .indexing import arange, take
from .quantile import _key_info, _key_to_float, _signed
from .rolling import centered_bounds


def _clip(x, lo, hi):
    """``jnp.clip``: max then min, NaN propagating."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def rolling_quantile_knots(
    knot_pos: torch.Tensor,
    knot_val: torch.Tensor,
    count: torch.Tensor,
    n: int,
    window: int,
    q: float,
    min_periods: int = 1,
    stride: int = 8,
    min_spacing: int = 1,
    n_valid=None,
    chunk: int = 1024,
    dtype=None,
) -> torch.Tensor:
    """Anchor values (B, ``ceil(n / stride)``) of the centered rolling
    quantile of the dense piecewise-linear interpolation of each row's knots.

    ``knot_pos`` (B, cap) holds each row's sorted knot positions in its first
    ``count`` slots (the rest are ignored); adjacent knots are
    >= ``min_spacing`` apart.  ``n_valid`` (B,) marks each row's valid dense
    prefix: positions past it are missing.  Expand with ``interp_anchors``.
    """
    bsz, cap = knot_pos.shape
    dev = knot_pos.device
    if dtype is None:
        dtype = knot_val.dtype
    left, right = centered_bounds(window)
    nseg = min(cap + 1, window // max(min_spacing, 1) + 3)

    cnt_b = count.long().reshape(bsz, 1, 1)
    kvalid = arange(cap, knot_pos)[None, :] < count.long()[:, None]
    pos_sorted = torch.where(kvalid, torch.clamp(knot_pos.long(), 0, n - 1), n)
    val = torch.where(kvalid, knot_val.to(dtype), torch.zeros((), dtype=dtype, device=dev))
    n_anchor = -(-n // stride)
    if n_valid is None:
        hi_cap = torch.full((bsz, 1, 1), n, dtype=torch.int64, device=dev)
    else:
        hi_cap = torch.clamp(n_valid.long(), max=n).reshape(bsz, 1, 1)

    itype, nbits = _key_info(dtype)
    qf = upload("quantile", q, dtype, dev)
    m = arange(nseg, knot_pos)
    inf = upload("quantile", float("inf"), dtype, dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    out = []
    for c0 in range(0, n_anchor, chunk):
        a = arange(min(chunk, n_anchor - c0), knot_pos) + c0
        apos = torch.clamp(a * stride, max=n - 1)[None, :]
        w_lo = torch.clamp(apos - left, min=0).expand(bsz, -1).contiguous()
        w_hi = torch.minimum(apos[:, :, None] + right + 1, hi_cap)      # (B, A, 1)

        # Last knot at or before the window start; candidate segments follow.
        base = torch.searchsorted(pos_sorted, w_lo, right=True) - 1
        kidx = base[:, :, None] + m                                     # (B, A, nseg)
        in_range = (kidx >= 0) & (kidx < cnt_b)
        kc = torch.clamp(kidx, 0, cap - 1)
        p0 = torch.where(in_range, take(pos_sorted, kc), n)
        v0 = torch.where(in_range, take(val, kc), zero)
        has_next = (kidx + 1) < cnt_b
        kn = torch.clamp(kidx + 1, 0, cap - 1)
        # Final segment: constant v0 up to the validity horizon.
        p1 = torch.where(has_next, take(pos_sorted, kn), hi_cap)
        v1 = torch.where(has_next, take(val, kn), v0)

        s = torch.maximum(p0, w_lo[:, :, None])
        e = torch.minimum(p1, w_hi)
        seg_len = torch.clamp(e - s, min=0)
        seg_ok = in_range & (seg_len > 0)
        seg_len = torch.where(seg_ok, seg_len, 0)

        dv = torch.where(seg_ok, v1 - v0, zero)
        safe_dv = torch.where(dv == 0, torch.ones((), dtype=dtype, device=dev), dv)
        denom = torch.clamp(p1 - p0, min=1).to(dtype)
        sf = s.to(dtype)
        ef = e.to(dtype)
        p0f = p0.to(dtype)
        lenf = seg_len.to(dtype)

        def cnt_le(v):
            """#window samples <= v per anchor (v: (B, A)) — closed form."""
            vb = v[:, :, None]
            rel = (vb - v0) / safe_dv * denom
            up = _clip(torch.floor(rel) + 1 + (p0f - sf), 0, lenf)
            down = _clip(ef - torch.maximum(torch.ceil(rel) + p0f, sf), 0, lenf)
            const = torch.where(v0 <= vb, lenf, zero)
            per = torch.where(dv > 0, up, torch.where(dv < 0, down, const))
            return torch.where(seg_ok, per, zero).sum(dim=2)

        cnt = seg_len.sum(dim=2)
        p = qf * torch.clamp(cnt - 1, min=0).to(dtype)
        k_lo = torch.floor(p)
        frac = p - k_lo
        target = k_lo + 1                                  # cnt_le >= k+1

        prefix = torch.zeros(cnt.shape, dtype=itype, device=dev)
        for i in range(nbits):
            b = nbits - 1 - i
            probe = prefix | _signed((1 << b) - 1, nbits)  # bit=0, ones below
            c = cnt_le(_key_to_float(probe, dtype))
            prefix = torch.where(c >= target, prefix, prefix | _signed(1 << b, nbits))
        v_lo = _key_to_float(prefix, dtype)

        # Next distinct sample value above v_lo, per segment, closed form.
        vb = v_lo[:, :, None]
        rel = (vb - v0) / safe_dv * denom
        i_up = torch.maximum(torch.floor(rel) + 1 + p0f, sf)   # first y > v, +slope
        i_dn = torch.minimum(torch.ceil(rel) + p0f, ef) - 1    # last y > v, -slope

        def y_at(i):
            return v0 + (i - p0f) / denom * dv

        cand_up = torch.where(i_up < ef, y_at(i_up), inf)
        cand_dn = torch.where(i_dn >= sf, y_at(i_dn), inf)
        cand_const = torch.where(v0 > vb, v0, inf)
        cand = torch.where(dv > 0, cand_up, torch.where(dv < 0, cand_dn, cand_const))
        cand = torch.where(seg_ok & (cand > vb), cand, inf)
        nxt = cand.amin(dim=2)

        v_hi = torch.where(cnt_le(v_lo) >= target + 1, v_lo,
                           torch.where(torch.isfinite(nxt), nxt, v_lo))
        res = torch.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
        out.append(torch.where(cnt >= min_periods, res,
                               torch.full_like(res, float("nan"))))
    anchors = torch.cat(out, dim=1)
    return torch.where(count.long()[:, None] > 0, anchors,
                       torch.full_like(anchors, float("nan")))


def knot_quantile_anchors_f32(knot_pos: torch.Tensor, knot_val: torch.Tensor,
                              count: torch.Tensor, n: int, window: int, q: float,
                              min_periods: int = 1, stride: int = 8, min_spacing: int = 1,
                              n_valid=None) -> torch.Tensor:
    """:func:`rolling_quantile_knots`'s anchors in float32, as the TPU kernel
    computes them, from ``knot_pos`` (B, cap) int32, ``knot_val`` (B, cap)
    float32 and ``count`` (B,) int32: the plain version for CPU tensors, the
    knot-quantile kernel (``ops/cuda/knot_kernel``) for CUDA ones."""
    if knot_pos.device.type == "cpu":
        return rolling_quantile_knots(
            knot_pos, knot_val, count, n, window, q, min_periods=min_periods,
            stride=stride, min_spacing=min_spacing, n_valid=n_valid, dtype=torch.float32)
    return knot_kernel.knot_quantile_anchors(knot_pos, knot_val, count, n, window, q,
                                             min_periods, stride, min_spacing, n_valid)


def anchors_at(anchors: torch.Tensor, query: torch.Tensor, n: int,
               stride: int, n_valid=None) -> torch.Tensor:
    """Evaluate the dense expansion of ``anchors`` (B, n_anchor) —
    ``interp_anchors`` semantics, including the pin past the last
    full-stride anchor of a valid prefix — at integer ``query`` positions
    (B, q): two gathers instead of a dense expansion."""
    n_anchor = anchors.shape[1]
    dtype = anchors.dtype
    qpos = torch.clamp(query.long(), 0, n - 1)
    j = qpos // stride
    if n_valid is not None:
        last = (n_valid.long()[:, None] - 1) // stride
        j = torch.minimum(j, last)
        in_tail = qpos >= last * stride
    else:
        in_tail = torch.zeros_like(qpos, dtype=torch.bool)
    j0 = torch.clamp(j, 0, n_anchor - 1)
    j1 = torch.clamp(j + 1, 0, n_anchor - 1)
    a0 = take(anchors, j0)
    a1 = take(anchors, j1)
    frac = (qpos - j0 * stride).to(dtype) / stride
    out = torch.where(frac > 0, a0 + frac * (a1 - a0), a0)
    return torch.where(in_tail, a0, out)
