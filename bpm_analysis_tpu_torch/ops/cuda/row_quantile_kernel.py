"""Wrapper of the CUDA row-quantile kernel (``csrc/row_quantile.cu``).

Counterpart of ``bpm_analysis_tpu/ops/quantile.py``'s ``quantile_exact``,
an XLA computation (not a Pallas kernel): ``np.quantile(x[r][valid[r]], q)``
with linear interpolation for each row of a (B, n) float32 or float64
batch.  A CUDA tensor launches the kernel, inside the span
``bpm.quantile``, or raises; a CPU tensor takes the plain version,
``ops/quantile.quantile_exact_plain``.  ``launches`` counts kernel
launches, one a call at every batch size, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import quantile
from ...utils.profiling import span

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("row_quantile")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, real in (("row_quantile_f32", ctypes.c_float),
                           ("row_quantile_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i32, i32, real, ptr]   # x, valid, out, B, n, q, stream
            fn.restype = i32
        lib.row_quantile_split.argtypes = [i32]
        lib.row_quantile_split.restype = i32
        lib.row_quantile_error_string.argtypes = [i32]
        lib.row_quantile_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def split(batch: int) -> int:
    """The blocks that share one row at ``batch`` rows on the current card:
    a cluster of up to 8 when the batch leaves SMs idle, else 1."""
    return _library().row_quantile_split(batch)


def quantile_exact(x: torch.Tensor, q: float, valid=None) -> torch.Tensor:
    """(B,) ``np.quantile(x[r][valid[r]], q)`` (linear interpolation) per row
    of ``x`` (B, n), a contiguous float32 or float64 tensor, in its dtype;
    NaN for a row with no valid element.  ``valid`` is a contiguous bool
    mask of ``x``'s shape, or None for ``~isnan(x)``.  ``q`` goes to the
    kernel by value, rounded to ``x``'s dtype."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x: expected a 2-D float32 or float64 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != x.shape or valid.device != x.device:
            raise ValueError(f"valid: expected bool {tuple(x.shape)} on {x.device}, got "
                             f"{valid.dtype} {tuple(valid.shape)} on {valid.device}")
        if not valid.is_contiguous():
            raise ValueError("valid must be contiguous")
    if x.device.type == "cpu":
        return quantile.quantile_exact_plain(x, q, valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bsz, n = x.shape
    if bsz > 65535 or n >= 1 << 31:
        raise ValueError(f"unsupported shape {(bsz, n)}")
    out = torch.empty((bsz,), dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    lib = _library()
    if x.dtype == torch.float32:
        fn, qv = lib.row_quantile_f32, ctypes.c_float(q)
    else:
        fn, qv = lib.row_quantile_f64, ctypes.c_double(q)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with span("bpm.quantile"):
        rc = fn(x.data_ptr(), None if valid is None else valid.data_ptr(), out.data_ptr(),
                bsz, n, qv, stream)
    if rc != 0:
        msg = lib.row_quantile_error_string(rc).decode()
        raise RuntimeError(f"row_quantile kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return out
