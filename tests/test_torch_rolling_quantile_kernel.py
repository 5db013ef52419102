"""The rolling-quantile kernel's surroundings on the CPU
(``ops/cuda/rolling_quantile_kernel``, ``csrc/rolling_quantile.cu``):
``ops/quantile.rolling_quantile_centered`` takes the plain version for a
CPU tensor, and the wrapper, for CUDA tensors alone, rejects what the kernel
does not take; the tile plan is a function of the window, the batch, the
row length and the SM count alone; and the kernel's design, the same for a
union in shared memory and one in global scratch,
emulated in numpy (tiles, the union's bitonic sort by value then position,
a wavelet matrix over the local ranks with per-word counts, the select and
the interpolation in the dtype), equals the plain version bit for bit on
``chip_smoke.rolling_quantile_cases``.  The kernel itself runs in
``tests/test_torch_cuda.py`` on a card."""
import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu_torch.kernels import build
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.ops.cuda import rolling_quantile_kernel as rk

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
H100_SMS = 132


def _network(vals: np.ndarray, pos: np.ndarray) -> None:
    """The kernel's bitonic network in place: stage k, stride j, pair
    (i, i | j) with bit j of i clear, ascending where bit k of i is clear;
    the later of the two by (value, position) moves up."""
    p = len(vals)
    c = np.arange(p // 2)
    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            i = ((c & ~(j - 1)) << 1) | (c & (j - 1))
            m = i | j
            vi, vm, ai, am = vals[i], vals[m], pos[i], pos[m]
            swap = ((vm < vi) | ((vm == vi) & (am < ai))) == ((i & k) == 0)
            vals[i], vals[m] = np.where(swap, vm, vi), np.where(swap, vi, vm)
            pos[i], pos[m] = np.where(swap, am, ai), np.where(swap, ai, am)
            j //= 2
        k *= 2


def _planes(seq: np.ndarray, levels: int):
    """The wavelet matrix's bit planes as 32-bit words (one spare zero
    word) with the ones before each word, top bit first."""
    p = len(seq)
    shifts = np.arange(32, dtype=np.uint64)
    planes, cur = [], seq
    for d in range(levels):
        bit = (cur >> (levels - 1 - d)) & 1
        words = np.append((bit.reshape(-1, 32).astype(np.uint64) << shifts).sum(1), 0)
        words = words.astype(np.uint32)
        pre = np.concatenate([[0], np.cumsum(np.bitwise_count(words))]).astype(np.int64)
        planes.append((words, pre))
        i = np.arange(p)
        ones = _rank1(words, pre, i)
        nxt = np.empty_like(cur)
        nxt[np.where(bit == 1, (p - pre[p // 32]) + ones, i - ones)] = cur
        cur = nxt
    return planes


def _rank1(words, pre, i):
    w = i >> 5
    mask = ((np.uint64(1) << (i & 31).astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
    return pre[w] + np.bitwise_count(words[w] & mask).astype(np.int64)


def _select(planes, p: int, levels: int, lo, hi, k):
    r = np.zeros_like(lo)
    for d, (words, pre) in enumerate(planes):
        olo, ohi = _rank1(words, pre, lo), _rank1(words, pre, hi)
        z = (hi - lo) - (ohi - olo)
        left = k < z
        zeros = p - pre[p // 32]
        lo, hi = np.where(left, lo - olo, zeros + olo), np.where(left, hi - ohi, zeros + ohi)
        k = np.where(left, k, k - z)
        r |= (~left).astype(r.dtype) << (levels - 1 - d)
    return r


def emulate(x: np.ndarray, window: int, q: float, min_periods: int, log_union: int,
            tile: int) -> np.ndarray:
    """The kernel's algorithm on one dtype's rows, block by block."""
    dt = x.dtype.type
    bsz, n = x.shape
    left, right = window // 2, (window - 1) // 2
    p = 1 << log_union
    out = np.empty_like(x)
    for b in range(bsz):
        for o0 in range(0, n, tile):
            o1 = min(n, o0 + tile)
            g0, g1 = max(0, o0 - left), min(n, o1 + right)
            u = g1 - g0
            assert u <= p
            seg = x[b, g0:g1]
            ok = np.zeros(p, dtype=bool)
            ok[:u] = ~np.isnan(seg)
            vals = np.full(p, np.inf, dtype=x.dtype)
            vals[:u] = np.where(ok[:u], seg, dt(np.inf))
            vpre = np.concatenate([[0], np.cumsum(ok)])
            pos = np.arange(p)
            _network(vals, pos)
            seq = np.empty(p, dtype=np.int64)
            seq[pos] = np.arange(p)
            planes = _planes(seq, log_union)
            o = np.arange(o0, o1)
            lo = np.maximum(0, o - left) - g0
            hi = np.minimum(n, o + right + 1) - g0
            cnt = vpre[hi] - vpre[lo]
            last = np.maximum(cnt - 1, 0)
            pos_q = dt(q) * last.astype(x.dtype)
            k_lo = np.floor(pos_q).astype(np.int64)
            frac = pos_q - k_lo.astype(x.dtype)
            v_lo = vals[_select(planes, p, log_union, lo, hi, k_lo)]
            v_hi = vals[_select(planes, p, log_union, lo, hi, np.minimum(k_lo + 1, last))]
            with np.errstate(invalid="ignore"):
                res = np.where(frac > 0, v_lo + frac * (v_hi - v_lo), v_lo)
            out[b, o0:o1] = np.where(cnt >= min_periods, res, dt(np.nan))
    return out


@pytest.mark.parametrize("sm_count", [H100_SMS, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1000, 12_000])
def test_kernel_design_equals_the_plain_version(n, dtype, sm_count):
    """Every case at each of its quantiles, bit for bit (NaN equal to NaN),
    on the tile plan the wrapper would launch: one short tile, several
    tiles of a 4096 union (the grid widened for 132 SMs), tiles of the
    8192 union (one SM), tiles of ``MIN_TILE`` outputs at the widest shared
    window, and unions of 16,384 (global scratch) one sample wider, at a
    384 kHz recording's window and at a window of the whole row."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    for name, x, window, qs, mp in chip_smoke.rolling_quantile_cases(n, 3):
        xt = torch.from_numpy(x.astype(np_dtype))
        for q in qs:
            exp = tq.rolling_quantile_centered_plain(xt, window, q, mp)
            log_union, tile = rk.tile_plan(window, 3, n, sm_count)
            got = emulate(x.astype(np_dtype), window, q, mp, log_union, tile)
            assert chip_smoke.same_values(torch.from_numpy(got), exp), (name, q, log_union, tile)


def test_cases_reach_every_regime():
    """The card's shapes put the cases in each regime: tiles of the 8192
    union at the exact cell's B=256, of the 4096 union at B=4 and B=1 (the
    grid widened to two blocks an SM), the widest shared window with tiles
    of ``MIN_TILE`` outputs in the 8192 union, a row shorter than a tile;
    in global scratch, tiles of the 16,384 union one sample wider and at a
    384 kHz recording's window, and a window of a whole row of 20,000."""
    assert rk.tile_plan(3020, 256, 181_200, H100_SMS) == (13, 5173)
    assert rk.tile_plan(3020, 4, 181_200, H100_SMS) == (12, 1077)
    assert rk.tile_plan(3020, 1, 229_825, H100_SMS) == (12, 1077)
    assert rk.tile_plan(rk.shared_window(), 4, 181_200, H100_SMS) == (13, rk.MIN_TILE)
    assert rk.tile_plan(3020, 3, 1000, H100_SMS) == (10, 1000)
    assert rk.tile_plan(rk.shared_window() + 1, 4, 181_200, H100_SMS) == (14, 8447)
    assert rk.tile_plan(12_800, 4, 181_200, H100_SMS) == (14, 3585)
    assert rk.tile_plan(12_800, 1, 768_000, H100_SMS) == (14, 3585)
    assert rk.tile_plan(20_007, 2, 20_000, H100_SMS) == (15, 20_000)
    names = [c[0] for c in chip_smoke.rolling_quantile_cases(20_000, 2)]
    assert {"window_ge_n", "widest_shared", "past_shared", "wide_window"} <= set(names)
    assert "window_ge_n" not in [c[0] for c in chip_smoke.rolling_quantile_cases(181_200, 4)]


def test_shared_memory_holds_every_window_up_to_shared_window():
    """The widest shared window fills the largest shared union, 8192
    positions, with a tile of ``MIN_TILE``; one sample more takes a union
    in global scratch on a row longer than 8192, whatever the batch, and a
    row of 8192 or fewer stays in shared memory at any window.  A union
    past 2^30 positions has no plan."""
    widest = rk.shared_window()
    assert widest == (1 << rk.MAX_SHARED_LOG_UNION) - rk.MIN_TILE + 1 == 7937
    for batch in (1, 4, 256):
        for n in (8193, 100_000, 229_825):
            assert rk.tile_plan(widest, batch, n, H100_SMS)[0] <= rk.MAX_SHARED_LOG_UNION
            assert rk.tile_plan(widest + 1, batch, n, H100_SMS)[0] > rk.MAX_SHARED_LOG_UNION
        assert rk.tile_plan(10 ** 6, batch, 8192, H100_SMS) == (13, 8192)
    with pytest.raises(ValueError):
        rk.tile_plan(1 << 30, 1, (1 << 30) + 1, H100_SMS)


@pytest.mark.parametrize("window", [1, 7, 64, 400, 3020, 3021, 7000, 7937, 7938, 12_800,
                                    300_000])
@pytest.mark.parametrize("batch", [1, 4, 256])
@pytest.mark.parametrize("n", [1, 255, 5_000, 229_825])
def test_tile_plan_holds_every_union(n, batch, window):
    """Each tile's union fits in the block's union, a tile is the row or at
    least ``MIN_TILE`` outputs, and the union only shrinks below the
    window's own (a tile at least its halo) to put two blocks on every
    SM."""
    log_union, tile = rk.tile_plan(window, batch, n, H100_SMS)
    assert rk.MIN_LOG_UNION <= log_union <= rk.MAX_LOG_UNION
    assert min(n, tile + window - 1) <= 1 << log_union
    assert 1 <= tile <= n and (tile == n or tile >= rk.MIN_TILE)
    halo = window - 1
    own = 1 << (max(2 * halo, halo + rk.MIN_TILE) - 1).bit_length()
    if window <= rk.shared_window():
        own = min(1 << rk.MAX_SHARED_LOG_UNION, own)
    if tile < n and (1 << log_union) < own:
        wider_tile = (1 << (log_union + 1)) - halo
        assert batch * -(-n // wider_tile) < 2 * H100_SMS


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the wrapper or loads the library:
    ``ops/quantile.rolling_quantile_centered`` gives the plain version's
    result, strided input included."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(rk, "rolling_quantile_centered", refuse)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 1000))
    before = build.launches["rolling_quantile"]
    for xs in (x, x[:, ::2]):
        exp = tq.rolling_quantile_centered_plain(xs.contiguous(), 64, 0.2, 3)
        assert chip_smoke.same_values(tq.rolling_quantile_centered(xs, 64, 0.2, 3), exp)
    assert build.launches["rolling_quantile"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    """Bad dtypes, shapes and parameters raise before the device is
    looked at, and a tensor off the card raises without loading the
    library."""
    def refuse(name):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(build, "load", refuse)
    x = torch.ones((2, 400), dtype=torch.float32)
    for bad in (x.to(torch.int32), x.half(), x[0], x[None]):
        with pytest.raises(ValueError, match="2-D float32 or float64"):
            rk.rolling_quantile_centered(bad, 64, 0.2, 3)
    for window, q, mp, what in ((0, 0.2, 3, "window"), (2.5, 0.2, 3, "window"),
                                (64, -0.1, 3, "q must"), (64, 1.5, 3, "q must"),
                                (64, float("nan"), 3, "q must"), (64, 0.2, 1.5, "min_periods")):
        with pytest.raises(ValueError, match=what):
            rk.rolling_quantile_centered(x, window, q, mp)
    for off_card in (x, x[:, ::2], x.to("meta")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            rk.rolling_quantile_centered(off_card, 64, 0.2, 3)
