"""A plain reference of the upstream analyzer's exact noise floor
(``pixeru/bpm_analysis``, bpm_analysis.py:1064-1117): the troughs
interpolated linearly over every sample, a pandas centered rolling quantile
of that series at every sample, then ``bfill().ffill()``.  Plain torch in
the series' own dtype; it imports neither JAX nor the program.

The rolling quantile sorts every window, ``block`` windows at a time, and
keeps pandas' semantics: the window at ``i`` is ``[i - w//2, i + (w-1)//2]``
cut at the series' ends, NaN is missing, a window with fewer than
``min_periods`` valid values is NaN, and the quantile interpolates linearly
between the two straddling order statistics, ``v_lo + frac * (v_hi -
v_lo)``, as pandas' ``roll_quantile`` does."""
import torch


def rolling_quantile_centered(x: torch.Tensor, window: int, q: float,
                              min_periods: int = 1, block: int = 1024) -> torch.Tensor:
    """pandas ``rolling(window, min_periods, center=True).quantile(q)`` of
    each row of ``x`` (B, n), by sorting each window."""
    bsz, n = x.shape
    left, right = window // 2, (window - 1) // 2
    nan = float("nan")
    xpad = torch.cat([x.new_full((bsz, left), nan), x, x.new_full((bsz, right), nan)], dim=1)
    out = torch.empty_like(x)
    for c0 in range(0, n, block):
        c1 = min(n, c0 + block)
        wins = xpad[:, c0:c1 + window - 1].unfold(1, window, 1)     # (B, c, window)
        valid = ~torch.isnan(wins)
        count = valid.sum(dim=-1)
        # Missing values sort last; a valid +inf ties with them, and any
        # order among equal values gives the same order statistics.
        ordered = torch.sort(torch.where(valid, wins, float("inf")), dim=-1).values
        last = torch.clamp(count - 1, min=0)
        pos = q * last.to(x.dtype)
        k_lo = torch.floor(pos).long()
        k_hi = torch.minimum(k_lo + 1, last)
        frac = pos - k_lo.to(x.dtype)
        v_lo = torch.gather(ordered, 2, k_lo[..., None])[..., 0]
        v_hi = torch.gather(ordered, 2, k_hi[..., None])[..., 0]
        res = torch.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
        keep = (count >= min_periods) & (count > 0)
        out[:, c0:c1] = torch.where(keep, res, torch.full_like(res, nan))
    return out


def interpolate(positions: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """``pd.Series(values, index=positions).reindex(range(n)).interpolate()``
    of one row's sorted knots: NaN before the first knot, linear between
    knots, the last value after the last."""
    i = torch.arange(n, device=positions.device)
    j = torch.searchsorted(positions, i, right=True) - 1        # last knot at or before i
    j0 = torch.clamp(j, min=0)
    j1 = torch.clamp(j + 1, max=len(positions) - 1)
    p0, p1 = positions[j0], positions[j1]
    v0, v1 = values[j0], values[j1]
    inside = p1 > p0
    frac = torch.where(inside, (i - p0).to(values.dtype)
                       / torch.where(inside, p1 - p0, 1).to(values.dtype), 0)
    out = v0 + frac * (v1 - v0)
    return torch.where(j >= 0, out, torch.full_like(out, float("nan")))


def bfill_ffill(x: torch.Tensor) -> torch.Tensor:
    """pandas ``.bfill().ffill()`` of one row: the first valid value at or
    after each sample, else the row's last valid value."""
    at = torch.nonzero(~torch.isnan(x))[:, 0]
    if len(at) == 0:
        return x.clone()
    j = torch.searchsorted(at, torch.arange(len(x), device=x.device))
    return x[at[torch.clamp(j, max=len(at) - 1)]]


def floor_of_troughs(envelope: torch.Tensor, positions: torch.Tensor, window: int,
                     q: float, min_periods: int = 3) -> torch.Tensor:
    """The noise floor of one envelope row (n,) from its troughs' sorted
    sample positions: their envelope values interpolated over every sample,
    the centered rolling quantile, then ``bfill().ffill()``."""
    dense = interpolate(positions, envelope[positions], len(envelope))
    return bfill_ffill(rolling_quantile_centered(dense[None], window, q, min_periods)[0])


def floors(envelope: torch.Tensor, positions: torch.Tensor, counts: torch.Tensor,
           window: int, q: float, min_periods: int = 3) -> torch.Tensor:
    """``floor_of_troughs`` of each row of ``envelope`` (B, n), the troughs
    being the first ``counts[r]`` entries of ``positions[r]``."""
    return torch.stack([
        floor_of_troughs(envelope[r], positions[r, :int(counts[r])].long(), window, q,
                         min_periods)
        for r in range(envelope.shape[0])])
