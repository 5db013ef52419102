"""Sequence-sharded DSP front-end — the "SP/CP" analog for this workload.

Port of ``bpm_analysis_tpu/parallel/seqshard.py`` on ``torch.distributed``.
Every DSP stage ahead of the classifier is convolutional (band-pass,
rectified envelope, rolling windows) and so blockwise-shardable: each rank
of an sp row holds one contiguous block of the sample axis (rank ``s`` the
``s``-th block, every block the same length; :func:`shard_sequence` cuts
them) and exchanges only block edges and filter states with its row
through ``mesh.all_gather`` / ``mesh.all_reduce``.  The block's compute stays
on the rank's device.

Each function takes this rank's block, (blk,) or with ``batched=True``
(B, blk), and returns this rank's block of the result;
:func:`gather_sequence` assembles the whole series.  The envelope and the
quantile are bit-equal to the port's local ``ops.rolling`` /
``ops.quantile`` functions on the whole series (the same sums in the same
order, the same selections); the filter re-blocks its recurrence, so it
agrees with ``ops.filter.bandpass_filtfilt`` to rounding.

For ~300 Hz envelopes this is for the very-long-recording regime (hours of
Holter audio); a ten-minute recording is 181,200 samples.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import filter as filt
from ..ops.filter import (BlockFilter, _df2t_matrices, butter_bandpass, lfilter_zi,
                          ordered_matmul)
from ..ops.indexing import arange
from ..ops.quantile import _strided_anchors_of_padded
from ..ops.rolling import _window_sums_of_padded, centered_bounds
from .mesh import Mesh, all_gather, all_reduce

# The sharded float32 filtfilt against the local float32 ``bandpass_filtfilt``:
# the relay re-blocks the recurrence, so the rounding differs.  The largest
# absolute difference stays below this share of the output's peak
# (measured up to 2.3e-6 at sp=4 and sp=8 in tests/test_torch_parallel.py,
# which holds the bound, as does chip_smoke.py's phase 10 on the card).
FLOAT32_FILTFILT_BOUND = 1e-5


def shard_sequence(mesh: Mesh, x):
    """This rank's block of the last (sample) axis of ``x``: the ``s``-th of
    ``sp`` equal blocks for sp index ``s``."""
    n = x.shape[-1]
    if n % mesh.sp:
        raise ValueError(f"sample count {n} not divisible by sp={mesh.sp}")
    blk = n // mesh.sp
    return x[..., mesh.sp_index * blk:(mesh.sp_index + 1) * blk]


def gather_sequence(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """The whole series from every rank's block of the sp row, on every
    rank of the row."""
    parts = all_gather(mesh, block, "sp")
    return torch.cat(list(parts), dim=-1)


def _halo_exchange(mesh: Mesh, block: torch.Tensor, halo_left: int, halo_right: int,
                   fill=0.0):
    """(the left neighbour's right edge, ``halo_left`` samples; the right
    neighbour's left edge, ``halo_right`` samples) along sp, on the last
    axis of ``block``.  The global edges get ``fill`` — zeros for windowed
    sums, NaN for "missing" in quantile windows."""
    blk = block.shape[-1]
    edges = all_gather(mesh, torch.cat([block[..., blk - halo_left:],
                                        block[..., :halo_right]], dim=-1), "sp")
    lead = block.shape[:-1]
    i = mesh.sp_index
    from_left = (edges[i - 1][..., :halo_left] if i > 0
                 else block.new_full((*lead, halo_left), fill))
    from_right = (edges[i + 1][..., halo_left:] if i < mesh.sp - 1
                  else block.new_full((*lead, halo_right), fill))
    return from_left, from_right


def _check_halo(blk: int, left: int, right: int) -> None:
    if blk < max(left, right):
        raise ValueError(f"block length {blk} smaller than halo {max(left, right)}; "
                         f"use fewer sp shards for this window")


def sequence_sharded_envelope(mesh: Mesh, block: torch.Tensor, window: int,
                              batched: bool = False) -> torch.Tensor:
    """abs → centered rolling mean (``ops.rolling.rolling_mean_centered(|x|,
    window)`` of the whole series), sample axis sharded over sp.

    Each block sums its windows over [halo | block | halo] with the local
    function's ascending shifted adds (zero halos at the global edges, as
    the local function pads) and divides by the *global* edge-truncated
    counts, so the result is bit-equal to the local one."""
    x = (block if batched else block[None]).abs()
    left, right = centered_bounds(window)
    blk = x.shape[-1]
    _check_halo(blk, left, right)
    n = blk * mesh.sp
    from_left, from_right = _halo_exchange(mesh, x, left, right)
    sums = _window_sums_of_padded(torch.cat([from_left, x, from_right], dim=-1), window, blk)
    gpos = mesh.sp_index * blk + arange(blk, x)
    counts = (torch.clamp(gpos + right, max=n - 1) - torch.clamp(gpos - left, min=0)
              + 1).to(x.dtype)
    out = sums / counts
    return out if batched else out[0]


def _divisor_block(n: int, target: int = 256, lo: int = 8) -> int:
    """Largest divisor of ``n`` that is <= target (>= lo if one exists)."""
    best = 1
    for d in range(1, target + 1):
        if n % d == 0:
            best = d
    if best < lo:
        raise ValueError(f"no usable filter block length divides {n}")
    return best


def sequence_sharded_bandpass_filtfilt(mesh: Mesh, block: torch.Tensor, fs: float,
                                       low_hz: float, high_hz: float, order: int = 2,
                                       batched: bool = False) -> torch.Tensor:
    """Zero-phase Butterworth band-pass (``ops.filter.bandpass_filtfilt``)
    with the sample axis sharded over sp.

    An IIR's state reaches across the whole signal, so instead of a halo
    the ``2 * order`` filter state is relayed along the row: each rank
    reduces its block to per-block carry contributions once (``X @ U``),
    then in ``sp - 1`` steps each rank in turn runs the cheap carry scan
    from the entry state it was handed and passes its exit state on —
    left to right for the forward pass, right to left for the backward
    (time-reversed) one.  scipy's odd end extensions are reproduced: the
    first and last ``padlen + 1`` samples are broadcast from the edge ranks
    (a masked all-reduce sum), and every rank integrates the short
    extension recurrences itself to get the entry states.  The block pieces
    are ``ops.filter.contributions`` / ``carry_scan`` / ``apply``: the filter
    kernel's phase entry points on the card and ``BlockFilter``'s plain
    methods on the CPU; each is bit-equal to the plain one, so the result is
    the same on both."""
    b, a = butter_bandpass(order, low_hz, high_hz, fs)
    padlen = 3 * max(len(a), len(b))
    x = block if batched else block[None]
    bsz, blk = x.shape
    if blk <= padlen:
        raise ValueError(f"block length {blk} must exceed padlen {padlen}")
    L = _divisor_block(blk)
    nb = blk // L
    dtype, dev = x.dtype, x.device

    def table(t):
        return torch.as_tensor(t, dtype=dtype, device=dev)

    A_np, B_np, b0 = _df2t_matrices(b, a)
    bf = BlockFilter.build(b, a, L, dtype, dev)
    A_T, Bv = table(A_np).T, table(B_np)
    zi = table(lfilter_zi(b, a))[None, :]
    idx, ndev = mesh.sp_index, mesh.sp

    def edge_broadcast(values, src):
        """``values`` of rank ``src`` on every rank of the row."""
        contrib = values if idx == src else torch.zeros_like(values)
        return all_reduce(mesh, contrib, dist.ReduceOp.SUM, "sp")

    def steps(s, us):
        """The DF2T recurrence over a short (B, k) sample block: y = b0*u +
        s[0]; s' = A s + B u.  Returns (final state, outputs)."""
        ys = []
        for j in range(us.shape[1]):
            u = us[:, j:j + 1]
            ys.append(b0 * u[:, 0] + s[:, 0])
            s = ordered_matmul(s, A_T) + Bv * u
        return s, torch.stack(ys, dim=1)

    def relay(C, s_first, reverse):
        """The entry-state relay along the row, in sample order (reversed
        for the backward pass).  Each rank runs its carry scan once, when
        its entry state is final; at step i the rank whose turn it is
        passes its exit state on and the others pass zeros."""
        order_ = list(range(ndev))[::-1] if reverse else list(range(ndev))
        entry = s_first if idx == order_[0] else None
        mine = None
        for src, dst in zip(order_[:-1], order_[1:]):
            if idx == src:
                mine = filt.carry_scan(bf, C, entry)
            passed = all_gather(mesh, mine[0] if idx == src else torch.zeros_like(s_first),
                                "sp")
            if idx == dst:
                entry = passed[src]
        if idx == order_[-1]:
            mine = filt.carry_scan(bf, C, entry)
        return mine

    def local_apply(X, S0):
        return filt.apply(bf, X, S0).reshape(bsz, blk)

    # --- forward pass -------------------------------------------------------
    head = edge_broadcast(x[:, :padlen + 1], 0)               # x[0 .. padlen]
    tail = edge_broadcast(x[:, blk - padlen - 1:], ndev - 1)  # x[n-padlen-1 ..]
    front_ext = 2 * head[:, :1] - head[:, 1:].flip(1)
    s_fwd0, _ = steps(zi * front_ext[:, :1], front_ext)
    X = x.reshape(bsz, nb, L).contiguous()
    s_exit, S0 = relay(filt.contributions(bf, X), s_fwd0, reverse=False)
    y = local_apply(X, S0)

    # --- forward-filter the back extension (every rank) ---------------------
    back_ext = 2 * tail[:, -1:] - tail[:, :-1].flip(1)
    _, y_back = steps(edge_broadcast(s_exit, ndev - 1), back_ext)

    # --- backward pass over the reversed signal -----------------------------
    s_bwd0, _ = steps(zi * y_back[:, -1:], y_back.flip(1))
    Xr = y.flip(1).reshape(bsz, nb, L)
    _, S0r = relay(filt.contributions(bf, Xr), s_bwd0, reverse=True)
    z = local_apply(Xr, S0r).flip(1)
    return z if batched else z[0]


def sequence_sharded_rolling_quantile(mesh: Mesh, block: torch.Tensor, window: int,
                                      q: float, min_periods: int = 1, stride: int = 8,
                                      batched: bool = False) -> torch.Tensor:
    """The noise-floor quantile (``ops.quantile.rolling_quantile_centered_strided``
    of the whole series) with the sample axis sharded over sp.

    Each block gets a ``window // 2``-sample halo (NaN at the global edges,
    which is pandas' truncation), selects its exact anchors with the local
    function's row-wise select (512 anchors at a time, as it does), and
    interpolates densely; a block's last span needs its right neighbour's
    first anchor, fetched with a second small exchange.  Bit-equal to the
    local function."""
    x = block if batched else block[None]
    left, right = centered_bounds(window)
    bsz, blk = x.shape
    if blk % stride:
        raise ValueError(f"block length {blk} not divisible by stride={stride}")
    _check_halo(blk, left, right)
    from_left, from_right = _halo_exchange(mesh, x, left, right, fill=float("nan"))
    anchors = _strided_anchors_of_padded(torch.cat([from_left, x, from_right], dim=-1),
                                         window, q, min_periods, stride, chunk=512)
    # Dense interpolation: span j blends anchor j toward anchor j+1; the
    # global last block holds its last anchor, as ``interp_anchors`` does.
    _, nxt_first = _halo_exchange(mesh, anchors, 0, 1, fill=float("nan"))
    if mesh.sp_index == mesh.sp - 1:
        nxt_first = anchors[:, -1:]
    a_ext = torch.cat([anchors, nxt_first], dim=1)
    frac = torch.arange(stride, dtype=x.dtype, device=x.device) / stride
    a0, a1 = a_ext[:, :-1, None], a_ext[:, 1:, None]
    dense = torch.where(frac > 0, a0 + frac * (a1 - a0), a0).reshape(bsz, blk)
    return dense if batched else dense[0]
