"""Wrapper of the CUDA classifier scan (``csrc/classify_scan.cu``).

Counterpart of the ``lax.scan`` in ``bpm_analysis_tpu/models/classifier.py``
(the blocked step over raw-peak slots) on CUDA tensors: the carry-dependent
loop of ``models/classifier.classify``.  ``models/classifier.classify_scan``
calls it for CUDA tensors, with the kernel's two constant tables, and runs
the plain version, ``scan_plain``, for CPU ones.  Each launch runs inside
the span ``bpm.scan``.

The tables' layout is the kernel's own: :data:`SCALARS` scalars (its
``enum Const``) then five Interp rows of :data:`TABLE_WIDTH` (its ``enum
Table``) in the working dtype, and :data:`CODES` integer codes (its ``enum
Int``); the library's ``classify_scan_layout`` is held against these
numbers when it is loaded.  Its float32 divisions by a constant take
div.rn.f32's fast path with the reciprocal hoisted; :func:`division_mismatches`
holds them against IEEE division on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...kernels import build
from ...utils.profiling import span

SCALARS = 32            # the kernel's enum Const
TABLE_WIDTH = 48        # its enum Table
CODES = 14              # its enum Int
MAX_KNOTS = 8
MAX_HIST = 64           # the paired ring is a 64-bit mask
KERNEL_FIELDS = ("blend_ratio", "base_conf", "pairing_ratio", "stability_factor",
                 "max_expected_ratio", "penalty_amount", "boost_amount",
                 "max_interval_sec", "interval_penalty", "final_conf", "lone_conf",
                 "rhythm_score", "actual_rr_sec", "expected_rr_sec", "amp_score",
                 "amp_ratio", "belief", "belief_time_sec")


def _check_layout(lib) -> None:
    layout = (ctypes.c_int * 5)()
    lib.classify_scan_layout(layout)
    expected = (SCALARS + 5 * TABLE_WIDTH, CODES, len(KERNEL_FIELDS), MAX_KNOTS, MAX_HIST)
    if tuple(layout) != expected:
        raise RuntimeError(f"classify_scan layout {tuple(layout)} != {expected}")


LIBRARY = build.Library(
    "classify_scan",
    {**{f"classify_scan_{suffix}": [build.PTR] * 11 + [build.I32] * 4 + [build.PTR] * 4
        for suffix in ("f32", "f64")},
     # divisors, count, numerators a divisor, seed, mismatches
     "classify_scan_check_division": [build.PTR, build.I32, ctypes.c_ulonglong, ctypes.c_uint,
                                      build.PTR]},
    queries={"classify_scan_layout": ([build.PTR], build.I32)},
    check=_check_layout)


def division_mismatches(divisors, n_per: int, seed: int = 0) -> int:
    """How many of ``n_per`` pseudo-random numerators for each divisor (half
    of random bits, half in the fast path's exponent range, some zeros)
    give a quotient on the kernel's fast-division path that differs from
    IEEE division (div.rn.f32) on the card; ``divisors=None`` draws
    ``n_per`` divisors at random too, as the carried divisors are.  The
    kernel is bit-equal only if this is 0."""
    d = torch.as_tensor(np.asarray([] if divisors is None else divisors, np.float32),
                        device="cuda")
    mismatches = torch.zeros(1, dtype=torch.int64, device="cuda")
    LIBRARY.check_division("classify_scan_check_division", d.device, d.data_ptr(), len(d),
                           n_per, seed, mismatches.data_ptr())
    return int(mismatches.item())


def classify_scan(x, n: int, consts: torch.Tensor, codes: torch.Tensor, kickstart: bool,
                  want_trace: bool = True):
    """(peak_class (B, capacity) int32, lone_reason (B, capacity) int32,
    paired (B, capacity) bool, the :data:`KERNEL_FIELDS` (len, B, capacity)
    in the working dtype) of the carry-dependent loop over ``x`` (a
    ``classifier.ScanInputs`` of CUDA tensors whose positions lie in [0,
    n]), with the constant tables ``consts`` and ``codes`` on the same
    card; the last three are None without the trace."""
    device = x.deviation.device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got ones on {device}")
    dtype = x.deviation.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    bsz, cap = x.positions.shape
    build.check_tensor("positions", x.positions, torch.int32, (bsz, cap), device)
    build.check_tensor("count", x.count, torch.int32, (bsz,), device)
    build.check_tensor("start_belief", x.start_belief, dtype, (bsz,), device)
    build.check_tensor("flags", x.flags, torch.uint8, (bsz, cap), device)
    for name in ("deviation", "interval_sec", "s2_s1_ratio", "s1_s2_ratio", "strength",
                 "boost", "implied_bpm"):
        build.check_tensor(name, getattr(x, name), dtype, (bsz, cap), device)
    build.check_tensor("consts", consts, dtype, (SCALARS + 5 * TABLE_WIDTH,), device)
    build.check_tensor("codes", codes, torch.int32, (CODES,), device)
    if cap <= 0 or bsz <= 0:
        raise ValueError(f"unsupported shape {(bsz, cap)}")
    if n >= 1 << 24:
        raise ValueError("positions must stay below 2^24 (exact in float32)")

    peak_class = torch.empty((bsz, cap), dtype=torch.int32, device=device)
    lone_reason = paired = fields = None
    if want_trace:
        lone_reason = torch.empty((bsz, cap), dtype=torch.int32, device=device)
        paired = torch.empty((bsz, cap), dtype=torch.bool, device=device)
        fields = torch.empty((len(KERNEL_FIELDS), bsz, cap), dtype=dtype, device=device)
    out_ptrs = [None if t is None else t.data_ptr() for t in (lone_reason, paired, fields)]
    entry = "classify_scan_f32" if dtype == torch.float32 else "classify_scan_f64"
    with span("bpm.scan"):
        LIBRARY.launch(entry, device, x.positions.data_ptr(), x.deviation.data_ptr(),
                       x.interval_sec.data_ptr(), x.s2_s1_ratio.data_ptr(), x.strength.data_ptr(),
                       x.boost.data_ptr(), x.flags.data_ptr(), x.count.data_ptr(),
                       x.start_belief.data_ptr(), consts.data_ptr(), codes.data_ptr(), bsz, cap,
                       int(want_trace), int(kickstart), peak_class.data_ptr(), *out_ptrs)
    return peak_class, lone_reason, paired, fields
