"""Wrapper of the CUDA blocked IIR filter (``csrc/block_filter.cu``).

Counterpart of ``ops/filter.lfilter_plain`` (scipy ``lfilter`` per row in
the blocked form, every product a sum in a fixed order) on CUDA tensors:
:func:`lfilter` runs the kernel's three phases (block contributions, carry
scan, apply) in one launch.  The phases are entry points too, the
counterparts of ``ops/filter.BlockFilter``'s plain pieces:
:func:`contributions`, :func:`carry_scan` and :func:`apply`.  Each takes the
filter as a ``BlockFilter`` (its tables in the working dtype on the card);
``ops/filter`` makes the CPU-or-card choice for all four.  The kernel's
table of a filter is packed and kept on the card (the last few filters),
so a call costs the launch alone.  Launches are counted under
``block_filter`` and, for the phases, ``block_filter_contributions``,
``block_filter_carry`` and ``block_filter_apply``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...kernels import build

MAX_STATE = 8           # the kernel's kMaxM
MAX_BLOCK = 256         # the contributions tile's shared memory holds 64 L-blocks
_KEEP = 16              # filters whose tables stay on the card
_by_filter: dict = {}   # id(BlockFilter) -> (that BlockFilter, kernel table)

_P, _I = build.PTR, build.I32
LIBRARY = build.Library("block_filter", {
    f"{name}_{suffix}": argtypes
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double))
    for name, argtypes in (
        ("block_filter", [_P] * 5 + [_I] * 4 + [real]),          # x, zi, tables, carry, y
        ("block_filter_contributions", [_P] * 3 + [_I] * 4),     # X, tables, C
        ("block_filter_carry", [_P] * 5 + [_I] * 4),             # C, s, tables, S0, s_out
        ("block_filter_apply", [_P] * 4 + [_I] * 4 + [real]))})  # X, S0, tables, y


def _launch(kernel: str, dtype, device, *args) -> None:
    suffix = "f32" if dtype == torch.float32 else "f64"
    LIBRARY.launch(f"{kernel}_{suffix}", device, *args, kernel=kernel)


def _device_and_dtype(t: torch.Tensor, bf):
    """(device, dtype) of a launch on ``t``: the dtype is ``bf``'s tables',
    which must lie on ``t``'s device, a card."""
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    dtype = bf.U.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if bf.U.device != t.device:
        raise ValueError(f"the filter's tables lie on {bf.U.device}, the input on {t.device}")
    return t.device, dtype


def _tables(bf) -> torch.Tensor:
    """The kernel's table of ``bf``: U (L, m), G^T (m, L), the lags h (L,
    the last 0), A_L^T (m, m), contiguous.  Kept with ``bf`` (the entry holds
    ``bf``, so its id is not reused while it is kept)."""
    hit = _by_filter.get(id(bf))
    if hit is not None:
        return hit[1]
    L, m = bf.U.shape
    if not 1 <= m <= MAX_STATE:
        raise ValueError(f"the filter kernel takes 1-{MAX_STATE} states, got {m}")
    if not 1 <= L <= MAX_BLOCK:
        raise ValueError(f"the filter kernel takes blocks of 1-{MAX_BLOCK} samples, got {L}")
    h = torch.as_tensor(bf.h + [0.0], dtype=bf.U.dtype, device=bf.U.device)
    table = torch.cat([bf.U.reshape(-1), bf.GT.reshape(-1), h, bf.A_LT.reshape(-1)])
    if len(_by_filter) >= _KEEP:
        _by_filter.pop(next(iter(_by_filter)))
    _by_filter[id(bf)] = (bf, table)
    return table


def _b0(bf, dtype):
    return (ctypes.c_float(float(np.float32(bf.b0))) if dtype == torch.float32
            else ctypes.c_double(float(bf.b0)))


def lfilter(bf, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """scipy ``lfilter(b, a, x[r], zi=zi[r])[0]`` for every row of ``x``
    (B, n), with ``zi`` (B, m), where ``bf`` is the filter (b, a) blocked at
    the length the kernel takes."""
    device, dtype = _device_and_dtype(x, bf)
    L, m = bf.U.shape
    if x.dim() != 2:
        raise ValueError(f"x must be a (B, n) tensor, got {tuple(x.shape)}")
    bsz, n = x.shape
    build.check_tensor("x", x, dtype, (bsz, n), device)
    build.check_tensor("zi", zi, dtype, (bsz, m), device)
    tables = _tables(bf)
    y = torch.empty_like(x)
    if bsz == 0 or n == 0:
        return y
    carry = torch.empty((bsz, -(-n // L), m), dtype=dtype, device=device)
    _launch("block_filter", dtype, device, x.data_ptr(), zi.data_ptr(), tables.data_ptr(),
            carry.data_ptr(), y.data_ptr(), bsz, n, L, m, _b0(bf, dtype))
    return y


def contributions(bf, X: torch.Tensor) -> torch.Tensor:
    """``bf.contributions(X)``: the (B, nb, m) carry contribution of each
    block of ``X`` (B, nb, L)."""
    device, dtype = _device_and_dtype(X, bf)
    L, m = bf.U.shape
    if X.dim() != 3:
        raise ValueError(f"X must be (B, nb, L), got {tuple(X.shape)}")
    bsz, nb = X.shape[:2]
    build.check_tensor("X", X, dtype, (bsz, nb, L), device)
    tables = _tables(bf)
    C = torch.empty((bsz, nb, m), dtype=dtype, device=device)
    if bsz and nb:
        _launch("block_filter_contributions", dtype, device, X.data_ptr(), tables.data_ptr(),
                C.data_ptr(), bsz, nb * L, L, m)
    return C


def carry_scan(bf, C: torch.Tensor, s: torch.Tensor):
    """``bf.carry_scan(C, s)``: (exit state (B, m), carry-in of each block
    (B, nb, m)) of the block carry scan from the entry state ``s`` (B, m)."""
    device, dtype = _device_and_dtype(C, bf)
    L, m = bf.U.shape
    if C.dim() != 3:
        raise ValueError(f"C must be (B, nb, m), got {tuple(C.shape)}")
    bsz, nb = C.shape[:2]
    build.check_tensor("C", C, dtype, (bsz, nb, m), device)
    build.check_tensor("s", s, dtype, (bsz, m), device)
    tables = _tables(bf)
    S0 = torch.empty_like(C)
    s_out = s.clone() if nb == 0 else torch.empty_like(s)
    if bsz and nb:
        _launch("block_filter_carry", dtype, device, C.data_ptr(), s.data_ptr(),
                tables.data_ptr(), S0.data_ptr(), s_out.data_ptr(), bsz, nb, L, m)
    return s_out, S0


def apply(bf, X: torch.Tensor, S0: torch.Tensor) -> torch.Tensor:
    """``bf.apply(X, S0)``: the in-block outputs (B, nb, L) from the blocks
    ``X`` (B, nb, L) and their carry-ins ``S0`` (B, nb, m)."""
    device, dtype = _device_and_dtype(X, bf)
    L, m = bf.U.shape
    if X.dim() != 3:
        raise ValueError(f"X must be (B, nb, L), got {tuple(X.shape)}")
    bsz, nb = X.shape[:2]
    build.check_tensor("X", X, dtype, (bsz, nb, L), device)
    build.check_tensor("S0", S0, dtype, (bsz, nb, m), device)
    tables = _tables(bf)
    y = torch.empty_like(X)
    if bsz and nb:
        _launch("block_filter_apply", dtype, device, X.data_ptr(), S0.data_ptr(),
                tables.data_ptr(), y.data_ptr(), bsz, nb * L, L, m, _b0(bf, dtype))
    return y
