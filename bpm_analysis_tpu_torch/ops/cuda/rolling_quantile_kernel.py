"""Wrapper of the CUDA rolling-quantile kernel (``csrc/rolling_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/quantile.py``'s
``rolling_quantile_centered``, an XLA computation (not a Pallas kernel):
pandas ``rolling(window, min_periods, center=True).quantile(q)`` of each row
of a (B, n) float32 or float64 CUDA batch, exact, at every sample, in one
launch a call inside the span ``bpm.rolling_exact``, at every window.
``ops/quantile.rolling_quantile_centered`` calls it for a CUDA tensor and
runs the plain version, ``rolling_quantile_centered_plain``, for a CPU one.

The kernel sorts the union of a tile's windows, ``tile + window - 1``
positions padded to a power of two ``2**log_union``; :func:`tile_plan`
chooses both from the window, the batch, the row length and the card's SM
count.  A union of up to 8,192 positions (:data:`MAX_SHARED_LOG_UNION`, a
block's 1024 threads of 8 positions) is sorted in shared memory, one block
a tile: 145,008 bytes in float64 and 108,144 in float32, so the dtype does
not enter the plan.  A wider window (above :func:`shared_window`) takes a
larger union, sorted in a global scratch region of each block, with one
block an SM looping over the tiles.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...kernels import build
from ...utils.profiling import span

MIN_LOG_UNION = 8           # csrc kMinLogUnion: one warp of 8 positions a thread
MAX_SHARED_LOG_UNION = 13   # csrc kMaxSharedLogUnion: 1024 threads, in shared memory
MAX_LOG_UNION = 30          # csrc kMaxLogUnion: in global scratch
MIN_TILE = 256              # the fewest outputs a block is given
SCRATCH_BYTES = 1 << 30     # the global scratch a call may take; at least one block's


LIBRARY = build.Library(
    "rolling_quantile",
    # x, out, B, n, window, q, min_periods, tile, log_union, blocks, scratch
    {f"rolling_quantile_{suffix}": [build.PTR, build.PTR, build.I32, build.I32, build.I32,
                                    real, build.I32, build.I32, build.I32, build.I32,
                                    build.PTR]
     for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double))},
    queries={"rolling_quantile_scratch_bytes": ([build.I32, build.I32], ctypes.c_longlong)})


def shared_window() -> int:
    """The widest window whose tiles are sorted in shared memory: a tile of
    :data:`MIN_TILE` outputs and its window's halo fill the largest shared
    union."""
    return (1 << MAX_SHARED_LOG_UNION) - MIN_TILE + 1


def tile_plan(window: int, batch: int, n: int, sm_count: int) -> tuple[int, int]:
    """(log_union, tile) for a (batch, n) call: a union of
    ``2**log_union`` positions and ``tile`` outputs a block.  The union is
    the smallest power of two that holds a tile at least as long as the
    window's halo (each sample read at most twice) and :data:`MIN_TILE`,
    kept in shared memory for a window up to :func:`shared_window`; a row
    no longer than that tile takes one tile, in the smallest union that
    holds it; and while the grid would not give every SM two tiles, the
    union halves as long as a tile of :data:`MIN_TILE` still fits."""
    halo = window - 1
    need = max(2 * halo, halo + MIN_TILE)
    lg = max(MIN_LOG_UNION, math.ceil(math.log2(need)))
    if window <= shared_window():
        lg = min(lg, MAX_SHARED_LOG_UNION)
    tile = (1 << lg) - halo
    if n <= tile:
        lg, tile = max(MIN_LOG_UNION, math.ceil(math.log2(max(n, 1)))), n
    else:
        while (batch * -(-n // tile) < 2 * sm_count and lg > MIN_LOG_UNION
               and (1 << (lg - 1)) - halo >= MIN_TILE):
            lg -= 1
            tile = (1 << lg) - halo
    if lg > MAX_LOG_UNION:
        raise ValueError(f"a union of 2^{lg} positions exceeds the kernel's 2^{MAX_LOG_UNION}")
    return lg, tile


def rolling_quantile_centered(x: torch.Tensor, window: int, q: float,
                              min_periods: int = 1) -> torch.Tensor:
    """pandas ``rolling(window, min_periods, center=True).quantile(q)`` of
    each row of ``x`` (B, n), a float32 or float64 CUDA tensor, in its
    dtype, exact; ``q`` in [0, 1] goes to the kernel by value, rounded to
    ``x``'s dtype."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x: expected a 2-D float32 or float64 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if int(window) != window or window < 1:
        raise ValueError(f"window must be a positive integer, got {window!r}")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must lie in [0, 1], got {q!r}")
    if int(min_periods) != min_periods:
        raise ValueError(f"min_periods must be an integer, got {min_periods!r}")
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    window, min_periods = int(window), int(min_periods)
    bsz, n = x.shape
    if n + window >= 1 << 31:
        raise ValueError(f"unsupported shape {(bsz, n)} at window {window}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if bsz == 0 or n == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    log_union, tile = tile_plan(window, bsz, n, sms)
    per_block = LIBRARY.load().rolling_quantile_scratch_bytes(log_union, x.element_size())
    jobs = bsz * -(-n // tile)
    scratch = None
    if per_block:
        blocks = max(1, min(jobs, sms, SCRATCH_BYTES // per_block))
        scratch = torch.empty(blocks * per_block, dtype=torch.uint8, device=x.device)
    else:
        blocks = jobs
    if x.dtype == torch.float32:
        entry, qv = "rolling_quantile_f32", ctypes.c_float(q)
    else:
        entry, qv = "rolling_quantile_f64", ctypes.c_double(q)
    with span("bpm.rolling_exact"):
        LIBRARY.launch(entry, x.device, x.data_ptr(), out.data_ptr(), bsz, n, window, qv,
                       min_periods, tile, log_union, blocks,
                       None if scratch is None else scratch.data_ptr())
    return out
