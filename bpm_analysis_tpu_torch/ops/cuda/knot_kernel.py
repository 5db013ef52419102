"""Wrapper of the CUDA knot-quantile kernel (``csrc/knot_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/pallas/knot_kernel.py``: the batched
anchors of the knot-domain rolling quantile
(``ops/knot_quantile.rolling_quantile_knots`` semantics), float32.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain version.
``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import knot_quantile as kq
from ..rolling import centered_bounds

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("knot_quantile")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.knot_quantile_anchors.argtypes = [
            ptr, ptr, ptr, ptr, ptr,                     # pos, val, count, hi_cap, out
            i32, i32, i32, i32, i32, i32, i32, i32,      # batch .. nseg
            ctypes.c_float, i32, ptr]                    # q, min_periods, stream
        lib.knot_quantile_anchors.restype = i32
        lib.knot_quantile_check_division.argtypes = [
            ctypes.c_ulonglong, ctypes.c_uint, ptr, ptr]  # n, seed, mismatches, stream
        lib.knot_quantile_check_division.restype = i32
        lib.knot_quantile_error_string.argtypes = [i32]
        lib.knot_quantile_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    if knot_pos.device.type == "cpu":
        return kq.rolling_quantile_knots(
            knot_pos, knot_val, count, n, window, q, min_periods=min_periods,
            stride=stride, min_spacing=min_spacing, n_valid=n_valid,
            dtype=torch.float32)
    if knot_pos.device.type != "cuda":
        raise ValueError(f"unsupported device {knot_pos.device}")
    bsz, cap = knot_pos.shape
    for name, t, dtype, shape in (("knot_pos", knot_pos, torch.int32, (bsz, cap)),
                                  ("knot_val", knot_val, torch.float32, (bsz, cap)),
                                  ("count", count, torch.int32, (bsz,))):
        if t.device != knot_pos.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape} on {knot_pos.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cap <= 0 or bsz > 65535:
        raise ValueError(f"unsupported shape {(bsz, cap)}")
    if n >= 1 << 24:
        raise ValueError("positions must stay below 2^24 (exact in float32)")
    if n_valid is None:
        hi_cap = torch.full((bsz,), n, dtype=torch.int32, device=knot_pos.device)
    else:
        hi_cap = torch.clamp(n_valid.to(device=knot_pos.device, dtype=torch.int32),
                             max=n).contiguous()
    left, right = centered_bounds(window)
    n_anchor = -(-n // stride)
    nseg = min(cap + 1, window // max(min_spacing, 1) + 3)
    out = torch.empty((bsz, n_anchor), dtype=torch.float32, device=knot_pos.device)
    if bsz == 0 or n_anchor == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(knot_pos.device).cuda_stream
    rc = lib.knot_quantile_anchors(
        knot_pos.data_ptr(), knot_val.data_ptr(), count.data_ptr(),
        hi_cap.data_ptr(), out.data_ptr(), bsz, cap, n, left, right, stride,
        n_anchor, nseg, ctypes.c_float(q), min_periods, stream)
    if rc != 0:
        msg = lib.knot_quantile_error_string(rc).decode()
        raise RuntimeError(f"knot_quantile kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return out


def division_mismatches(n_pairs: int, seed: int = 0) -> int:
    """How many of ``n_pairs`` pseudo-random operand pairs in the kernel's
    fast-division range give a quotient that differs from IEEE division
    (div.rn.f32) on the card; the kernel is bit-equal only if this is 0."""
    mismatches = torch.zeros(1, dtype=torch.int64, device="cuda")
    lib = _library()
    stream = torch.cuda.current_stream(mismatches.device).cuda_stream
    rc = lib.knot_quantile_check_division(n_pairs, seed, mismatches.data_ptr(), stream)
    if rc != 0:
        msg = lib.knot_quantile_error_string(rc).decode()
        raise RuntimeError(f"knot_quantile division check failed: {msg} ({rc})")
    return int(mismatches.item())
