"""Wrapper of the CUDA rhythm-correction scan (``csrc/rhythm_scan.cu``).

Counterpart of the ``lax.scan`` in ``bpm_analysis_tpu/models/corrections.py``
(stage 4's greedy conflict resolution): the loop of
``models/corrections.rhythm_correction``.  A CUDA tensor launches the kernel
or raises; a CPU tensor takes the plain version,
``corrections.rhythm_scan_plain``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("rhythm_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, real in (("rhythm_scan_f32", ctypes.c_float),
                           ("rhythm_scan_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, real, i32, i32, ptr, ptr, ptr]
            fn.restype = i32
        lib.rhythm_scan_error_string.argtypes = [i32]
        lib.rhythm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rhythm_scan(pos: torch.Tensor, amp: torch.Tensor, count: torch.Tensor,
                threshold: torch.Tensor, n: int, sample_rate: int):
    """(written (B, cap) bool, victim (B, cap) int32) of the greedy scan over
    each row's ``count`` valid slots: ``pos`` (B, cap) int32 in [0, n],
    ``amp`` (B, cap), ``threshold`` (B,) in seconds.  The kernel compares
    integer distances with a per-row integer threshold, which equals the
    plain version's division for positions in [0, n] (n < 2^24) and a
    positive sample rate."""
    from ...models import corrections

    if amp.device.type == "cpu":
        return corrections.rhythm_scan_plain(pos, amp, count, threshold, sample_rate)
    device = amp.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    dtype = amp.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    bsz, cap = pos.shape
    for name, t, want_dtype, shape in (("pos", pos, torch.int32, (bsz, cap)),
                                       ("amp", amp, dtype, (bsz, cap)),
                                       ("count", count, torch.int32, (bsz,)),
                                       ("threshold", threshold, dtype, (bsz,))):
        if t.device != device or t.dtype != want_dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {want_dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cap <= 0 or bsz <= 0:
        raise ValueError(f"unsupported shape {(bsz, cap)}")
    if n >= 1 << 24:
        raise ValueError("positions must stay below 2^24 (exact in float32)")
    if sample_rate <= 0:
        raise ValueError(f"unsupported sample rate {sample_rate}")
    written = torch.empty((bsz, cap), dtype=torch.bool, device=device)
    victim = torch.empty((bsz, cap), dtype=torch.int32, device=device)
    lib = _library()
    if dtype == torch.float32:
        fn, sr = lib.rhythm_scan_f32, ctypes.c_float(float(np.float32(sample_rate)))
    else:
        fn, sr = lib.rhythm_scan_f64, ctypes.c_double(float(sample_rate))
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(pos.data_ptr(), amp.data_ptr(), count.data_ptr(), threshold.data_ptr(), sr,
            bsz, cap, written.data_ptr(), victim.data_ptr(), stream)
    if rc != 0:
        msg = lib.rhythm_scan_error_string(rc).decode()
        raise RuntimeError(f"rhythm_scan kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return written, victim
