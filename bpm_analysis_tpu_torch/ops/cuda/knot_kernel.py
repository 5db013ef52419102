"""Wrapper of the CUDA knot-quantile kernel (``csrc/knot_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/pallas/knot_kernel.py``: the batched
anchors of the knot-domain rolling quantile
(``ops/knot_quantile.rolling_quantile_knots`` semantics), float32, of
CUDA tensors.  ``ops/knot_quantile.knot_quantile_anchors_f32`` calls it for
CUDA tensors and runs the plain version for CPU ones.

A block stages its recording's knot table in shared memory, 8 bytes a slot,
where the device's opt-in shared memory holds it (29,056 slots on an
H100); a wider table (a two-hour recording's 32,768 troughs) is read from
global memory, with the same bits.  The library decides.
"""
from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from ..rolling import centered_bounds

LIBRARY = build.Library("knot_quantile", {
    "knot_quantile_anchors": [
        build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,  # pos, val, count, hi_cap, out
        *[build.I32] * 8,                                       # batch .. nseg
        ctypes.c_float, build.I32],                             # q, min_periods
    "knot_quantile_check_division": [
        ctypes.c_ulonglong, ctypes.c_uint, build.PTR]})         # n, seed, mismatches


def knot_quantile_anchors(
    knot_pos: torch.Tensor,   # (B, cap) int32, sorted valid prefix per row
    knot_val: torch.Tensor,   # (B, cap) float32
    count: torch.Tensor,      # (B,) int32 valid knots per row
    n: int,
    window: int,
    q: float,
    min_periods: int = 1,
    stride: int = 8,
    min_spacing: int = 1,
    n_valid=None,             # (B,) int, or None: valid dense prefix per row
) -> torch.Tensor:
    """(B, ceil(n / stride)) float32 anchors of the centered rolling
    quantile of each row's knot interpolation."""
    device = knot_pos.device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got ones on {device}")
    bsz, cap = knot_pos.shape
    build.check_tensor("knot_pos", knot_pos, torch.int32, (bsz, cap), device)
    build.check_tensor("knot_val", knot_val, torch.float32, (bsz, cap), device)
    build.check_tensor("count", count, torch.int32, (bsz,), device)
    if cap <= 0 or bsz > 65535:
        raise ValueError(f"unsupported shape {(bsz, cap)}")
    if n >= 1 << 24:
        raise ValueError("positions must stay below 2^24 (exact in float32)")
    if n_valid is None:
        hi_cap = torch.full((bsz,), n, dtype=torch.int32, device=device)
    else:
        hi_cap = torch.clamp(n_valid.to(device=device, dtype=torch.int32), max=n).contiguous()
    left, right = centered_bounds(window)
    n_anchor = -(-n // stride)
    nseg = min(cap + 1, window // max(min_spacing, 1) + 3)
    out = torch.empty((bsz, n_anchor), dtype=torch.float32, device=device)
    if bsz == 0 or n_anchor == 0:
        return out
    LIBRARY.launch("knot_quantile_anchors", device, knot_pos.data_ptr(), knot_val.data_ptr(),
                   count.data_ptr(), hi_cap.data_ptr(), out.data_ptr(), bsz, cap, n, left,
                   right, stride, n_anchor, nseg, ctypes.c_float(q), min_periods)
    return out


def division_mismatches(n_pairs: int, seed: int = 0) -> int:
    """How many of ``n_pairs`` pseudo-random operand pairs in the kernel's
    fast-division range give a quotient that differs from IEEE division
    (div.rn.f32) on the card; the kernel is bit-equal only if this is 0."""
    mismatches = torch.zeros(1, dtype=torch.int64, device="cuda")
    LIBRARY.check_division("knot_quantile_check_division", mismatches.device, n_pairs, seed,
                           mismatches.data_ptr())
    return int(mismatches.item())
