"""Wrapper of the CUDA blocked IIR filter (``csrc/block_filter.cu``).

Counterpart of ``ops/filter.lfilter_plain`` (scipy ``lfilter`` per row in
the blocked form, every product a sum in a fixed order): :func:`lfilter`
runs the kernel's three phases (block contributions, carry scan, apply) in
one call.  The phases are entry points too, the counterparts of
``ops/filter.BlockFilter``'s plain pieces: :func:`contributions`,
:func:`carry_scan` and :func:`apply`, which the sequence-sharded relay
(``parallel/seqshard.py``) calls between its exchanges.  A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version.
``launches`` counts :func:`lfilter` calls that launched the kernel,
``phase_launches`` the phase entry points' launches.  A filter's tables are
built and copied to the card once and kept (the last few filters), so a
call costs the launches alone.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

launches = 0
phase_launches = {"contributions": 0, "carry_scan": 0, "apply": 0}
_lib = None
MAX_STATE = 8           # the kernel's kMaxM
MAX_BLOCK = 256         # the contributions tile's shared memory holds 64 L-blocks
_KEEP = 16              # filters whose tables stay on the card
_by_design: dict = {}   # (b, a, L, dtype, device) -> (BlockFilter, kernel table)
_by_filter: dict = {}   # id(BlockFilter) -> (that BlockFilter, kernel table)


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("block_filter")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            for name, argtypes in (
                    ("block_filter", [ptr] * 5 + [i32] * 4 + [real, ptr]),
                    ("block_filter_contributions", [ptr] * 3 + [i32] * 4 + [ptr]),
                    ("block_filter_carry", [ptr] * 5 + [i32] * 4 + [ptr]),
                    ("block_filter_apply", [ptr] * 4 + [i32] * 4 + [real, ptr])):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = i32
        lib.block_filter_error_string.argtypes = [i32]
        lib.block_filter_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(name: str, dtype, *args) -> None:
    lib = _library()
    suffix = "f32" if dtype == torch.float32 else "f64"
    rc = getattr(lib, f"{name}_{suffix}")(*args)
    if rc != 0:
        msg = lib.block_filter_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _device_and_dtype(t: torch.Tensor, bf=None):
    """(device, dtype) of a launch on ``t``: the dtype is ``bf``'s tables'
    where given, which must lie on ``t``'s device."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    dtype = t.dtype if bf is None else bf.U.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if bf is not None and bf.U.device != t.device:
        raise ValueError(f"the filter's tables lie on {bf.U.device}, the input on {t.device}")
    return t.device, dtype


def _keep(cache: dict, key, value):
    if len(cache) >= _KEEP:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


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
    return _keep(_by_filter, id(bf), (bf, table))[1]


def _filter(b: np.ndarray, a: np.ndarray, L: int, dtype, device):
    """(BlockFilter, kernel table) of the design (b, a) at block length L."""
    from .. import filter as filt

    key = (np.asarray(b, np.float64).tobytes(), np.asarray(a, np.float64).tobytes(), L,
           dtype, str(device))
    hit = _by_design.get(key)
    if hit is None:
        bf = filt.BlockFilter.build(b, a, L, dtype, device)
        hit = _keep(_by_design, key, (bf, _tables(bf)))
    return hit


def _b0(bf, dtype):
    return (ctypes.c_float(float(np.float32(bf.b0))) if dtype == torch.float32
            else ctypes.c_double(float(bf.b0)))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """scipy ``lfilter(b, a, x[r], zi=zi[r])[0]`` for every row of ``x``
    (B, n), with ``zi`` (B, m)."""
    from .. import filter as filt

    if x.device.type == "cpu":
        return filt.lfilter_plain(b, a, x, zi, block)
    device, dtype = _device_and_dtype(x)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, n) tensor, got {tuple(x.shape)}")
    bsz, n = x.shape
    m = len(a) - 1
    if not 1 <= m <= MAX_STATE:
        raise ValueError(f"the filter kernel takes 1-{MAX_STATE} states, got {m}")
    _check("zi", zi, dtype, (bsz, m), device)
    y = torch.empty_like(x)
    if bsz == 0 or n == 0:
        return y
    L = min(block, max(8, n))
    bf, tables = _filter(b, a, L, dtype, device)
    carry = torch.empty((bsz, -(-n // L), m), dtype=dtype, device=device)
    _call("block_filter", dtype, x.data_ptr(), zi.data_ptr(), tables.data_ptr(),
          carry.data_ptr(), y.data_ptr(), bsz, n, L, m, _b0(bf, dtype), _stream(device))
    global launches
    launches += 1
    return y


def contributions(bf, X: torch.Tensor) -> torch.Tensor:
    """``bf.contributions(X)``: the (B, nb, m) carry contribution of each
    block of ``X`` (B, nb, L)."""
    if X.device.type == "cpu":
        return bf.contributions(X)
    device, dtype = _device_and_dtype(X, bf)
    L, m = bf.U.shape
    if X.dim() != 3:
        raise ValueError(f"X must be (B, nb, L), got {tuple(X.shape)}")
    bsz, nb = X.shape[:2]
    _check("X", X, dtype, (bsz, nb, L), device)
    tables = _tables(bf)
    C = torch.empty((bsz, nb, m), dtype=dtype, device=device)
    if bsz and nb:
        _call("block_filter_contributions", dtype, X.data_ptr(), tables.data_ptr(),
              C.data_ptr(), bsz, nb * L, L, m, _stream(device))
        phase_launches["contributions"] += 1
    return C


def carry_scan(bf, C: torch.Tensor, s: torch.Tensor):
    """``bf.carry_scan(C, s)``: (exit state (B, m), carry-in of each block
    (B, nb, m)) of the block carry scan from the entry state ``s`` (B, m)."""
    if C.device.type == "cpu":
        return bf.carry_scan(C, s)
    device, dtype = _device_and_dtype(C, bf)
    L, m = bf.U.shape
    if C.dim() != 3:
        raise ValueError(f"C must be (B, nb, m), got {tuple(C.shape)}")
    bsz, nb = C.shape[:2]
    _check("C", C, dtype, (bsz, nb, m), device)
    _check("s", s, dtype, (bsz, m), device)
    tables = _tables(bf)
    S0 = torch.empty_like(C)
    s_out = s.clone() if nb == 0 else torch.empty_like(s)
    if bsz and nb:
        _call("block_filter_carry", dtype, C.data_ptr(), s.data_ptr(), tables.data_ptr(),
              S0.data_ptr(), s_out.data_ptr(), bsz, nb, L, m, _stream(device))
        phase_launches["carry_scan"] += 1
    return s_out, S0


def apply(bf, X: torch.Tensor, S0: torch.Tensor) -> torch.Tensor:
    """``bf.apply(X, S0)``: the in-block outputs (B, nb, L) from the blocks
    ``X`` (B, nb, L) and their carry-ins ``S0`` (B, nb, m)."""
    if X.device.type == "cpu":
        return bf.apply(X, S0)
    device, dtype = _device_and_dtype(X, bf)
    L, m = bf.U.shape
    if X.dim() != 3:
        raise ValueError(f"X must be (B, nb, L), got {tuple(X.shape)}")
    bsz, nb = X.shape[:2]
    _check("X", X, dtype, (bsz, nb, L), device)
    _check("S0", S0, dtype, (bsz, nb, m), device)
    tables = _tables(bf)
    y = torch.empty_like(X)
    if bsz and nb:
        _call("block_filter_apply", dtype, X.data_ptr(), S0.data_ptr(), tables.data_ptr(),
              y.data_ptr(), bsz, nb * L, L, m, _b0(bf, dtype), _stream(device))
        phase_launches["apply"] += 1
    return y
