"""Wrapper of the CUDA strided-quantile kernel (``csrc/strided_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/pallas/quantile_kernel.py``: the
centered rolling quantile of a dense (B, n) float32 CUDA series at the
anchors ``j * stride``, with the TPU kernel's contract — raw float32 bits
as keys, so a sample is missing unless it is a non-negative finite value
(NaN, +inf, negatives and -0.0 are missing).
``ops/quantile.strided_quantile_anchors_f32`` calls it for a CUDA tensor
and runs the plain version, ``strided_quantile_anchors_f32_plain``, for a
CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from ..rolling import centered_bounds

MAX_WINDOW = 1024 * 24   # the widest window the kernel takes

LIBRARY = build.Library("strided_quantile", {
    "strided_quantile_anchors": [
        build.PTR, build.PTR,                                     # x, out
        build.I32, build.I32, build.I32, build.I32, build.I32, build.I32,  # batch .. n_anchor
        ctypes.c_float, build.I32]})                              # q, min_periods


def check_inputs(x: torch.Tensor, window: int, q: float, stride: int) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous 2-D float32 tensor
    and the window, stride and ``q`` are in range: the kernel's contract,
    which the plain version is held to as well."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x: expected a 2-D float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if window < 1 or stride < 1 or not 0.0 <= q <= 1.0:
        raise ValueError(f"unsupported window {window}, stride {stride} or q {q}")


def strided_quantile_anchors(x: torch.Tensor, window: int, q: float,
                             min_periods: int = 1, stride: int = 8) -> torch.Tensor:
    """(B, ceil(n / stride)) float32 anchors of the centered rolling
    quantile of each row of ``x`` (B, n), a contiguous float32 CUDA tensor.

    The values must be non-negative (NaN = missing): the keys are the raw
    float bits, which order non-negative floats only, and the wrapper does
    not scan the values."""
    check_inputs(x, window, q, stride)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    bsz, n = x.shape
    if bsz > 65535 or n >= 1 << 31 or window > MAX_WINDOW:
        raise ValueError(f"unsupported shape {(bsz, n)} or window {window}")
    left, _ = centered_bounds(window)
    n_anchor = -(-n // stride)
    out = torch.empty((bsz, n_anchor), dtype=torch.float32, device=x.device)
    if bsz == 0 or n_anchor == 0:
        return out
    LIBRARY.launch("strided_quantile_anchors", x.device, x.data_ptr(), out.data_ptr(), bsz,
                   n, window, left, stride, n_anchor, ctypes.c_float(q), min_periods)
    return out
