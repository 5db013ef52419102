"""Wrapper of the CUDA rhythm-correction scan (``csrc/rhythm_scan.cu``).

Counterpart of the ``lax.scan`` in ``bpm_analysis_tpu/models/corrections.py``
(stage 4's greedy conflict resolution) on CUDA tensors.
``models/corrections.rhythm_scan`` calls it for CUDA tensors and runs the
plain version, ``rhythm_scan_plain``, for CPU ones.  Each launch runs inside
the span ``bpm.scan``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...kernels import build
from ...utils.profiling import span

LIBRARY = build.Library(
    "rhythm_scan",
    # pos, amp, count, threshold, sample_rate, B, cap, written, victim
    {f"rhythm_scan_{suffix}": [build.PTR, build.PTR, build.PTR, build.PTR, real, build.I32,
                               build.I32, build.PTR, build.PTR]
     for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double))})


def rhythm_scan(pos: torch.Tensor, amp: torch.Tensor, count: torch.Tensor,
                threshold: torch.Tensor, n: int, sample_rate: int):
    """(written (B, cap) bool, victim (B, cap) int32) of the greedy scan over
    each row's ``count`` valid slots: ``pos`` (B, cap) int32 in [0, n],
    ``amp`` (B, cap), ``threshold`` (B,) in seconds, all on the card.  The
    kernel compares integer distances with a per-row integer threshold,
    which equals the plain version's division for positions in [0, n]
    (n < 2^24) and a positive sample rate."""
    device = amp.device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got ones on {device}")
    dtype = amp.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    bsz, cap = pos.shape
    build.check_tensor("pos", pos, torch.int32, (bsz, cap), device)
    build.check_tensor("amp", amp, dtype, (bsz, cap), device)
    build.check_tensor("count", count, torch.int32, (bsz,), device)
    build.check_tensor("threshold", threshold, dtype, (bsz,), device)
    if cap <= 0 or bsz <= 0:
        raise ValueError(f"unsupported shape {(bsz, cap)}")
    if n >= 1 << 24:
        raise ValueError("positions must stay below 2^24 (exact in float32)")
    if sample_rate <= 0:
        raise ValueError(f"unsupported sample rate {sample_rate}")
    written = torch.empty((bsz, cap), dtype=torch.bool, device=device)
    victim = torch.empty((bsz, cap), dtype=torch.int32, device=device)
    if dtype == torch.float32:
        entry, sr = "rhythm_scan_f32", ctypes.c_float(float(np.float32(sample_rate)))
    else:
        entry, sr = "rhythm_scan_f64", ctypes.c_double(float(sample_rate))
    with span("bpm.scan"):
        LIBRARY.launch(entry, device, pos.data_ptr(), amp.data_ptr(), count.data_ptr(),
                       threshold.data_ptr(), sr, bsz, cap, written.data_ptr(), victim.data_ptr())
    return written, victim
