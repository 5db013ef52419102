"""Wrapper of the CUDA blocked IIR filter (``csrc/block_filter.cu``).

Counterpart of ``ops/filter.lfilter_plain`` (scipy ``lfilter`` per row in
the blocked form, every product a sum in a fixed order): one kernel per
call.  A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

launches = 0
_lib = None
MAX_STATE = 8           # the kernel's kMaxM


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("block_filter")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, real in (("block_filter_f32", ctypes.c_float),
                           ("block_filter_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 5 + [i32] * 4 + [real, ptr]
            fn.restype = i32
        lib.block_filter_error_string.argtypes = [i32]
        lib.block_filter_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """scipy ``lfilter(b, a, x[r], zi=zi[r])[0]`` for every row of ``x``
    (B, n), with ``zi`` (B, m)."""
    from .. import filter as filt

    if x.device.type == "cpu":
        return filt.lfilter_plain(b, a, x, zi, block)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, n) tensor, got {tuple(x.shape)}")
    bsz, n = x.shape
    m = len(a) - 1
    if not 1 <= m <= MAX_STATE:
        raise ValueError(f"the filter kernel takes 1-{MAX_STATE} states, got {m}")
    if (zi.device != device or zi.dtype != dtype or tuple(zi.shape) != (bsz, m)
            or not zi.is_contiguous()):
        raise ValueError(f"zi: expected a contiguous {dtype} {(bsz, m)} on {device}, "
                         f"got {zi.dtype} {tuple(zi.shape)} on {zi.device}")
    y = torch.empty_like(x)
    if bsz == 0 or n == 0:
        return y
    L = min(block, max(8, n))
    bf = filt.BlockFilter.build(b, a, L, dtype, device)
    h = torch.as_tensor(bf.h + [0.0], dtype=dtype, device=device)
    tables = torch.cat([bf.U.reshape(-1), bf.GT.reshape(-1), h, bf.A_LT.reshape(-1)])
    carry = torch.empty((bsz, -(-n // L), m), dtype=dtype, device=device)
    lib = _library()
    if dtype == torch.float32:
        fn, b0 = lib.block_filter_f32, ctypes.c_float(float(np.float32(bf.b0)))
    else:
        fn, b0 = lib.block_filter_f64, ctypes.c_double(float(bf.b0))
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(x.data_ptr(), zi.data_ptr(), tables.data_ptr(), carry.data_ptr(), y.data_ptr(),
            bsz, n, L, m, b0, stream)
    if rc != 0:
        msg = lib.block_filter_error_string(rc).decode()
        raise RuntimeError(f"block_filter kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return y
