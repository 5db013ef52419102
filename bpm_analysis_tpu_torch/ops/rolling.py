"""Rolling-window means with exact pandas semantics over (B, n) tensors.

Port of ``bpm_analysis_tpu/ops/rolling.py``.  Pandas' centered integer window
of size ``w`` covers ``[i - w//2, i + (w-1)//2]`` truncated at the edges, and
its time-based centered window ``'Xs'`` is the half-open interval
``(t - X/2, t + X/2]``.  Windowed sums are shifted adds in ascending sample
order (the JAX package's fixed-order formulation), so float results do not
depend on the padded length.
"""
from __future__ import annotations

import torch

from .indexing import arange, take


def centered_bounds(window: int) -> tuple[int, int]:
    """Pandas center=True window extents: (left, right) s.t. the window at
    position i is [i-left, i+right]."""
    return window // 2, (window - 1) // 2


def _window_sums_of_padded(xp: torch.Tensor, window: int, n: int) -> torch.Tensor:
    """``sum(xp[..., i + k] for k in range(window))`` for i < n, as
    ``window`` shifted adds in ascending order: the window sums of a series
    that ``xp`` holds with its left and right context in place."""
    acc = xp[..., 0:n]
    for k in range(1, window):
        acc = acc + xp[..., k:k + n]
    return acc


def _windowed_sum_fixed_order(x: torch.Tensor, window: int, left: int,
                              right: int) -> torch.Tensor:
    """Windowed sum along the last axis as ``window`` shifted adds in
    ascending sample order (zero padding outside the array)."""
    return _window_sums_of_padded(torch.nn.functional.pad(x, (left, right)), window,
                                  x.shape[-1])


def rolling_mean_centered(x: torch.Tensor, window: int) -> torch.Tensor:
    """pandas ``rolling(window, min_periods=1, center=True).mean()`` along
    the last axis, no NaNs.  Edge windows are truncated (count shrinks)."""
    left, right = centered_bounds(window)
    n = x.shape[-1]
    sums = _windowed_sum_fixed_order(x, window, left, right)
    idx = arange(n, x)
    counts = (torch.clamp(idx + right, max=n - 1)
              - torch.clamp(idx - left, min=0) + 1).to(x.dtype)
    return sums / counts


def rolling_mean_centered_masked(x: torch.Tensor, valid: torch.Tensor,
                                 window: int) -> torch.Tensor:
    """Same as :func:`rolling_mean_centered` but invalid entries are excluded
    from both sum and count.  NaN where a window holds no valid value."""
    left, right = centered_bounds(window)
    xz = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
    sums = _windowed_sum_fixed_order(xz, window, left, right)
    counts = _windowed_sum_fixed_order(valid.to(x.dtype), window, left, right)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                       torch.full_like(sums, float("nan")))


def _window_sum(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, before: int,
                after: int) -> torch.Tensor:
    """Sum of ``x[b, j]`` over ``lo[b, i] <= j < hi[b, i]`` for every slot i
    of (B, n) ``x``, where each window lies within ``[i - before, i +
    after]``: shifted adds in ascending slot order.  The association depends
    on neither the batch nor the row length, so a recording's windowed sums
    are the same bits in any batch; a prefix-sum difference would take its
    association from the library scan, which picks it from the whole shape
    on the card."""
    n = x.shape[-1]
    idx = arange(n, x)[None, :]
    acc = torch.zeros_like(x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for m in range(max(-before, 1 - n), min(after, n - 1) + 1):
        if m < 0:
            shifted = torch.nn.functional.pad(x[:, :n + m], (-m, 0))
        else:
            shifted = torch.nn.functional.pad(x[:, m:], (0, m))
        j = idx + m
        acc = acc + torch.where((j >= lo) & (j < hi), shifted, zero)
    return acc


def rolling_mean_dynamic_window(x: torch.Tensor, valid: torch.Tensor,
                                window: torch.Tensor, max_window: int) -> torch.Tensor:
    """Centered rolling mean over (B, n) with a per-row window (B,) int of
    at most ``max_window``: masked sums, truncated to the valid prefix (the
    deviation-series smoothing, bpm_analysis.py:99)."""
    n = x.shape[-1]
    window = window.long()[:, None]
    left = window // 2
    right = (window - 1) // 2
    xz = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
    zero = torch.zeros(x.shape[0], 1, dtype=torch.int64, device=x.device)
    ccnt = torch.cat([zero, torch.cumsum(valid.long(), dim=1)], dim=1)
    idx = arange(n, x)[None, :]
    nvalid = valid.long().sum(dim=1, keepdim=True)
    lo = torch.minimum(torch.clamp(idx - left, min=0), nvalid)
    hi = torch.minimum(torch.clamp(idx + right + 1, min=0), nvalid)
    sums = _window_sum(xz, lo, hi, max_window // 2, (max_window - 1) // 2)
    counts = take(ccnt, hi) - take(ccnt, lo)
    nan = torch.full_like(sums, float("nan"))
    out = torch.where(counts > 0, sums / torch.clamp(counts, min=1).to(x.dtype), nan)
    return torch.where(valid, out, nan)


def rolling_mean_time_window(
    times: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
    window_sec: float, max_slots_in_half_window: int | None = None,
) -> torch.Tensor:
    """pandas time-based ``rolling('Xs', min_periods=1, center=True).mean()``
    over irregular samples (B, cap): window ``(t - X/2, t + X/2]``.

    ``times`` is sorted over its valid prefix.  With
    ``max_slots_in_half_window`` (a lower bound on the sample spacing turned
    into a slot bound) the window bounds come from shifted compares and the
    sums from :func:`_window_sum`, in an order that does not depend on the
    batch; without it, from searchsorted and a prefix sum."""
    half = window_sec / 2.0
    b, n = times.shape
    nvalid = valid.long().sum(dim=1, keepdim=True)
    big = torch.finfo(times.dtype).max
    t = torch.where(valid, times, torch.full_like(times, big))
    vz = torch.where(valid, values, torch.zeros_like(values))
    M = max_slots_in_half_window
    bounded = M is not None and M < n
    if bounded:
        idx = arange(n, times)[None, :]
        cnt_next = torch.zeros(b, n, dtype=torch.int64, device=times.device)
        cnt_prev = torch.zeros_like(cnt_next)
        t_hi = t + half
        t_lo = t - half
        for m in range(1, M + 1):
            nxt = torch.nn.functional.pad(t[:, m:], (0, m), value=float("inf"))
            cnt_next += (nxt <= t_hi).long()
            prv = torch.nn.functional.pad(t[:, :-m], (m, 0), value=float("-inf"))
            cnt_prev += (prv > t_lo).long()
        hi = idx + 1 + cnt_next
        lo = idx - cnt_prev
    else:
        lo = torch.searchsorted(t, t - half, right=True)
        hi = torch.searchsorted(t, t + half, right=True)
    hi = torch.minimum(torch.clamp(hi, min=0), nvalid)
    lo = torch.minimum(torch.clamp(lo, min=0), nvalid)
    if bounded:
        sums = _window_sum(vz, lo, hi, M, M)
    else:
        zero = torch.zeros(b, 1, dtype=values.dtype, device=values.device)
        csum = torch.cat([zero, torch.cumsum(vz, dim=1)], dim=1)
        sums = take(csum, hi) - take(csum, lo)
    counts = (hi - lo).to(values.dtype)
    nan = torch.full_like(sums, float("nan"))
    out = torch.where(counts > 0, sums / torch.clamp(counts, min=1), nan)
    return torch.where(valid, out, nan)
