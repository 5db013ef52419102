"""Wrapper of the CUDA strided-quantile kernel (``csrc/strided_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/pallas/quantile_kernel.py``: the
centered rolling quantile of a dense (B, n) float32 series at the anchors
``j * stride``, with the TPU kernel's contract — raw float32 bits as keys,
so a sample is missing unless it is a non-negative finite value (NaN, +inf,
negatives and -0.0 are missing).  A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version, :func:`plain_anchors`.
``launches`` counts kernel launches, so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import quantile
from ..rolling import centered_bounds

launches = 0
_lib = None

INF_BITS = 0x7F800000    # +inf: raw bits at or above it are missing
MAX_WINDOW = 1024 * 24   # the widest window the kernel takes


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("strided_quantile")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.strided_quantile_anchors.argtypes = [
            ptr, ptr,                                    # x, out
            i32, i32, i32, i32, i32, i32,                # batch .. n_anchor
            ctypes.c_float, i32, ptr]                    # q, min_periods, stream
        lib.strided_quantile_anchors.restype = i32
        lib.strided_quantile_error_string.argtypes = [i32]
        lib.strided_quantile_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def plain_anchors(x: torch.Tensor, window: int, q: float, min_periods: int = 1,
                  stride: int = 8, chunk: int = 512) -> torch.Tensor:
    """The kernel's plain version: ``quantile.strided_quantile_anchors`` at
    float32 with the raw-bit validity (a sample whose bits, as unsigned, are
    not below +inf's is missing).  For valid values, which are non-negative,
    the raw bits and the sortable keys order alike, so the selection and
    the float32 interpolation are the kernel's, operation for operation."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    x = torch.where((bits >= 0) & (bits < INF_BITS), x, torch.full_like(x, float("nan")))
    return quantile.strided_quantile_anchors(x, window, q, min_periods, stride, chunk)


def strided_quantile_anchors(x: torch.Tensor, window: int, q: float,
                             min_periods: int = 1, stride: int = 8) -> torch.Tensor:
    """(B, ceil(n / stride)) float32 anchors of the centered rolling
    quantile of each row of ``x`` (B, n), a contiguous float32 tensor.

    The values must be non-negative (NaN = missing): the keys are the raw
    float bits, which order non-negative floats only, and the wrapper does
    not scan the values."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x: expected a 2-D float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if window < 1 or stride < 1 or not 0.0 <= q <= 1.0:
        raise ValueError(f"unsupported window {window}, stride {stride} or q {q}")
    if x.device.type == "cpu":
        return plain_anchors(x, window, q, min_periods, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bsz, n = x.shape
    if bsz > 65535 or n >= 1 << 31 or window > MAX_WINDOW:
        raise ValueError(f"unsupported shape {(bsz, n)} or window {window}")
    left, _ = centered_bounds(window)
    n_anchor = -(-n // stride)
    out = torch.empty((bsz, n_anchor), dtype=torch.float32, device=x.device)
    if bsz == 0 or n_anchor == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.strided_quantile_anchors(
        x.data_ptr(), out.data_ptr(), bsz, n, window, left, stride, n_anchor,
        ctypes.c_float(q), min_periods, stream)
    if rc != 0:
        msg = lib.strided_quantile_error_string(rc).decode()
        raise RuntimeError(f"strided_quantile kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return out


def rolling_quantile_strided_cuda(x: torch.Tensor, window: int, q: float,
                                  min_periods: int = 1, stride: int = 8) -> torch.Tensor:
    """Dense (B, n) strided rolling quantile of a non-negative series of any
    float dtype (counterpart of ``rolling_quantile_strided_pallas``): the
    kernel's float32 anchors of ``x`` cast to float32, expanded by
    ``quantile.interp_anchors`` in ``x``'s dtype."""
    anchors = strided_quantile_anchors(x.to(torch.float32).contiguous(), window, q,
                                       min_periods, stride)
    return quantile.interp_anchors(anchors.to(x.dtype), x.shape[1], stride)
