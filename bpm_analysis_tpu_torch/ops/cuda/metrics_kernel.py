"""Wrapper of the CUDA metrics kernel (``csrc/metrics.cu``).

Counterpart of ``bpm_analysis_tpu/models/analytics.py``'s
``compute_metrics`` (an XLA computation, not a Pallas kernel): the BPM
series and its centered smoothing, the windowed HRV, the summary numbers,
the steepest slopes, the heart-rate recovery and the major slope lists of a
(B, cap) batch of beat positions, in one launch a call.
``models/analytics.compute_metrics`` calls it for CUDA tensors, assembles
its planes into the ``Metrics`` tuples, and runs the plain version,
``compute_metrics_plain``, for CPU ones.

A block's arrays sit in shared memory up to a capacity of ~4,460 slots in
float64 and ~8,250 in float32; past that the library asks for a global
scratch region of each block (``metrics_scratch_bytes``), and at most
:data:`SCRATCH_BYTES` of it is taken, the blocks looping over the rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...kernels import build

LIBRARY = build.Library(
    "metrics",
    # positions, count, ints, reals, B, series, hrv, slopes, scalars, counts, found,
    # scratch, blocks
    {f"metrics_{suffix}": [build.PTR, build.PTR, build.PTR, build.PTR, build.I32, build.PTR,
                           build.PTR, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
                           build.I32]
     for suffix in ("f32", "f64")},
    queries={"metrics_scratch_bytes": ([build.I32, build.I32, build.I32], ctypes.c_longlong)})

WORK = 256               # csrc kWork: find_peaks' work capacity (4 x the slope capacity)
SLOPES = 64              # kSlopes: the slope lists' capacity
SCRATCH_BYTES = 1 << 27  # the global scratch a call may take; at least one block's
SCALARS = ("hrr.peak_bpm", "hrr.peak_time", "hrr.recovery_bpm", "hrr.hrr",
           *(f"{s}.{f}" for s in ("peak_exertion", "peak_recovery")
             for f in ("start_time", "end_time", "start_bpm", "end_bpm", "slope", "duration")),
           "avg_bpm", "min_bpm", "max_bpm", "avg_rmssdc", "avg_sdnn")
LIST_FIELDS = ("start_time", "end_time", "start_bpm", "end_bpm", "duration", "bpm_change",
               "slope")


class Planes(NamedTuple):
    """The kernel's outputs; each field of ``Metrics`` is a contiguous view."""
    series: torch.Tensor    # (3, B, cap): times, smoothed, instant
    hrv: torch.Tensor       # (4, B, hrv_capacity): time, rmssdc, sdnn, bpm
    slopes: torch.Tensor    # (2, 7, B, 64): inclines, declines x LIST_FIELDS
    scalars: torch.Tensor   # (21, B): SCALARS
    counts: torch.Tensor    # (4, B) int32: series, hrv, inclines, declines
    found: torch.Tensor     # (3, B) bool: hrr, peak_exertion, peak_recovery


def _reciprocal(x: float, np_dtype) -> float:
    """``1 / x`` rounded to the dtype, as ATen divides a CUDA tensor by a
    Python number: a multiply by this reciprocal."""
    return float(np_dtype(1.0) / np_dtype(x))


def compute(positions: torch.Tensor, count: torch.Tensor, sample_rate: int, cfg, dtype,
            max_window_slots: int | None, hrv_capacity: int) -> Planes:
    """Every metric of each row's first ``count`` beat ``positions`` (B, cap)
    int32 at ``sample_rate``, in ``dtype`` (float32 or float64), on the card:
    one launch.  ``cfg`` is the ``AnalyzerConfig`` (its ``output`` constants
    and ``compat.hrr_truncated_interp``); ``max_window_slots`` bounds the
    smoothing window's slots on each side (None, or not below ``cap``:
    unbounded); ``hrv_capacity`` is the HRV's window slots."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if positions.dim() != 2:
        raise ValueError(f"positions: expected (B, cap), got {tuple(positions.shape)}")
    bsz, cap = positions.shape
    o = cfg.output
    if cap < 2 or o.hrv_window_size_beats < 1 or hrv_capacity < 1:
        raise ValueError(f"unsupported capacity {cap}, HRV window {o.hrv_window_size_beats} "
                         f"or HRV capacity {hrv_capacity}")
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got ones on {device}")
    build.check_tensor("positions", positions, torch.int32, (bsz, cap), device)
    build.check_tensor("count", count, torch.int32, (bsz,), device)
    out = Planes(
        series=torch.empty((3, bsz, cap), dtype=dtype, device=device),
        hrv=torch.empty((4, bsz, hrv_capacity), dtype=dtype, device=device),
        slopes=torch.empty((2, len(LIST_FIELDS), bsz, SLOPES), dtype=dtype, device=device),
        scalars=torch.empty((len(SCALARS), bsz), dtype=dtype, device=device),
        counts=torch.empty((4, bsz), dtype=torch.int32, device=device),
        found=torch.empty((3, bsz), dtype=torch.bool, device=device))
    if bsz == 0:
        return out
    npd = np.float32 if dtype == torch.float32 else np.float64
    bounded = max_window_slots is not None and max_window_slots < cap
    w = o.hrv_window_size_beats
    ints = (ctypes.c_int * 6)(cap, max_window_slots if bounded else -1, w,
                              o.hrv_step_size_beats, hrv_capacity,
                              int(bool(cfg.compat.hrr_truncated_interp)))
    reals = (ctypes.c_double * 13)(
        _reciprocal(sample_rate, npd), o.output_smoothing_window_sec / 2.0, 1e-6,
        _reciprocal(w, npd), _reciprocal(w - 1, npd) if w > 1 else float("inf"),
        _reciprocal(1000.0, npd), o.slope_window_sec, o.hrr_interval_sec,
        float(np.spacing(np.finfo(npd).eps)), o.incline_min_duration_sec / 2,
        o.incline_min_duration_sec, o.incline_min_bpm_change, o.slope_peak_prominence)
    per_block = LIBRARY.load().metrics_scratch_bytes(cap, hrv_capacity, npd().itemsize)
    scratch, blocks = None, bsz
    if per_block:
        blocks = max(1, min(bsz, SCRATCH_BYTES // per_block))
        scratch = torch.empty(blocks * per_block, dtype=torch.uint8, device=device)
    entry = "metrics_f32" if dtype == torch.float32 else "metrics_f64"
    LIBRARY.launch(entry, device, positions.data_ptr(), count.data_ptr(), ints, reals, bsz,
                   *(t.data_ptr() for t in out),
                   None if scratch is None else scratch.data_ptr(), blocks)
    return out
