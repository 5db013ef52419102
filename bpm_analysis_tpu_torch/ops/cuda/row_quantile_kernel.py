"""Wrapper of the CUDA row-quantile kernel (``csrc/row_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/quantile.py``'s ``quantile_exact``,
an XLA computation (not a Pallas kernel): ``np.quantile(x[r][valid[r]], q)``
with linear interpolation for each row of a (B, n) float32 or float64 CUDA
batch, in one launch a call at every batch size, inside the span
``bpm.quantile``.  ``ops/quantile.quantile_exact`` calls it for a CUDA
tensor and runs the plain version, ``quantile_exact_plain``, for a CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from ...utils.profiling import span

LIBRARY = build.Library(
    "row_quantile",
    # x, valid, out, B, n, q
    {f"row_quantile_{suffix}": [build.PTR, build.PTR, build.PTR, build.I32, build.I32, real]
     for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double))},
    queries={"row_quantile_split": ([build.I32], build.I32)})


def split(batch: int) -> int:
    """The blocks that share one row at ``batch`` rows on the current card:
    a cluster of up to 8 when the batch leaves SMs idle, else 1."""
    return LIBRARY.load().row_quantile_split(batch)


def check_inputs(x: torch.Tensor, valid=None) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous 2-D float32 or
    float64 tensor and ``valid`` None or a contiguous bool mask of its shape
    on its device: the kernel's contract, which the plain version is held
    to as well."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x: expected a 2-D float32 or float64 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if valid is not None:
        build.check_tensor("valid", valid, torch.bool, x.shape, x.device)


def quantile_exact(x: torch.Tensor, q: float, valid=None) -> torch.Tensor:
    """(B,) ``np.quantile(x[r][valid[r]], q)`` (linear interpolation) per row
    of ``x`` (B, n), a contiguous float32 or float64 CUDA tensor, in its
    dtype; NaN for a row with no valid element.  ``valid`` is a contiguous
    bool mask of ``x``'s shape, or None for ``~isnan(x)``.  ``q`` goes to
    the kernel by value, rounded to ``x``'s dtype."""
    check_inputs(x, valid)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    bsz, n = x.shape
    if bsz > 65535 or n >= 1 << 31:
        raise ValueError(f"unsupported shape {(bsz, n)}")
    out = torch.empty((bsz,), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    if x.dtype == torch.float32:
        entry, qv = "row_quantile_f32", ctypes.c_float(q)
    else:
        entry, qv = "row_quantile_f64", ctypes.c_double(q)
    with span("bpm.quantile"):
        LIBRARY.launch(entry, x.device, x.data_ptr(),
                       None if valid is None else valid.data_ptr(), out.data_ptr(), bsz, n,
                       qv)
    return out
