"""Wrapper of the CUDA classifier scan (``csrc/classify_scan.cu``).

Counterpart of the ``lax.scan`` in ``bpm_analysis_tpu/models/classifier.py``
(the blocked step over raw-peak slots): the carry-dependent loop of
``models/classifier.classify``.  A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version, ``classifier.scan_plain``.
``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.

The kernel reads its constants from two small device tables that this
module builds: every float rounded to the working dtype exactly as the
plain version rounds the Python number at its operation (and the Interp
tables taken from ``classifier.Interp`` itself), every integer code from
``types``, and keeps them on the card for the next call with the same
configuration.  Its float32 divisions by a constant take div.rn.f32's fast path
with the reciprocal hoisted; :func:`division_mismatches` holds them against
IEEE division on the card over :func:`constant_divisors`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import types

launches = 0
_lib = None
_tables: dict = {}      # (sample_rate, cfg, dtype, device) -> (float table, int table) on the card

SCALARS = 32            # the kernel's enum Const
TABLE_WIDTH = 48        # its enum Table
MAX_KNOTS = 8
MAX_HIST = 64           # the paired ring is a 64-bit mask
KERNEL_FIELDS = ("blend_ratio", "base_conf", "pairing_ratio", "stability_factor",
                 "max_expected_ratio", "penalty_amount", "boost_amount",
                 "max_interval_sec", "interval_penalty", "final_conf", "lone_conf",
                 "rhythm_score", "actual_rr_sec", "expected_rr_sec", "amp_score",
                 "amp_ratio", "belief", "belief_time_sec")
# Trace fields that are slot inputs, passed through as they are.
SLOT_FIELDS = ("deviation", "s2_s1_ratio", "s1_s2_ratio", "interval_sec", "implied_bpm")


def _library():
    global _lib
    if _lib is None:
        from ...kernels import build

        lib = build.load("classify_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("classify_scan_f32", "classify_scan_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 11 + [i32] * 4 + [ptr] * 5
            fn.restype = i32
        lib.classify_scan_check_division.argtypes = [
            ptr, i32, ctypes.c_ulonglong, ctypes.c_uint, ptr, ptr]
        lib.classify_scan_check_division.restype = i32
        lib.classify_scan_layout.argtypes = [ptr]
        lib.classify_scan_layout.restype = i32
        lib.classify_scan_error_string.argtypes = [i32]
        lib.classify_scan_error_string.restype = ctypes.c_char_p
        layout = (ctypes.c_int * 5)()
        lib.classify_scan_layout(layout)
        expected = (SCALARS + 5 * TABLE_WIDTH, 14, len(KERNEL_FIELDS), MAX_KNOTS, MAX_HIST)
        if tuple(layout) != expected:
            raise RuntimeError(f"classify_scan layout {tuple(layout)} != {expected}")
        _lib = lib
    return _lib


def _interp_table(interp, fp=None) -> np.ndarray:
    """One Interp's row of the kernel's table (``enum Table``), in float64
    holding values of the working dtype.  ``fp`` (low, span) replaces the
    constant values for the base interp, whose values vary with the belief."""
    row = np.zeros(TABLE_WIDTH)
    k = interp.k
    if not 2 <= k <= MAX_KNOTS:
        raise ValueError(f"the classify kernel takes 2-{MAX_KNOTS} interp knots, got {k}")
    xp = interp.xp_t.cpu().numpy()
    if not (np.diff(xp) >= 0).all():
        raise ValueError(f"the classify kernel's segment count needs sorted knots, got {xp}")
    table = interp.table.cpu().numpy().astype(np.float64)
    row[0] = k
    row[1:1 + k] = xp
    row[9:9 + k - 1] = table[1]
    if interp.dx0 is not None:
        row[17:17 + k - 1] = interp.dx0.cpu().numpy()
    if fp is None:
        row[25:25 + k - 1] = table[2]
        row[33:33 + k - 1] = table[3]
        row[41], row[42] = interp.f_ends
    else:
        low, span = fp
        row[25:25 + k] = low
        row[33:33 + k] = span
    return row


def constants(sample_rate: int, cfg, dtype: torch.dtype):
    """(float table, int table) for the kernel, as numpy arrays: the scalars
    of ``enum Const`` and the five Interp tables; the codes of ``enum Int``."""
    from ...models import classifier

    p, r = cfg.pairing, cfg.rhythm
    npd = classifier._NP_DTYPE[dtype]
    scalars = [
        sample_rate, p.stability_history_window, 0.5, p.kickstart_check_threshold,
        p.kickstart_override_ratio, p.contractility_bpm_low,
        p.contractility_bpm_high - p.contractility_bpm_low, p.penalty_amount_min,
        p.penalty_amount_max - p.penalty_amount_min, 1.0, 2.0, 60.0,
        p.s1_s2_interval_rr_fraction, p.s1_s2_interval_cap_sec,
        p.interval_penalty_start_factor, p.interval_penalty_full_factor, 1e-9,
        p.interval_max_penalty, p.pairing_confidence_threshold, r.lone_s1_rhythm_weight,
        r.lone_s1_amplitude_weight, r.lone_s1_confidence_threshold,
        r.lone_s1_forward_check_pct, 1 - r.belief_learning_rate, r.belief_learning_rate,
        r.belief_max_change_per_beat, r.min_bpm, r.max_bpm, 0.0, float("nan")]
    head = np.zeros(SCALARS)
    head[:len(scalars)] = np.asarray(scalars, np.float64).astype(npd)

    def interp(xp, fp):
        return classifier.Interp(xp, fp, dtype, "cpu")

    curve_low = np.asarray(p.curve_low, npd)
    curve_span = np.asarray(p.curve_high, npd) - curve_low
    tables = [
        _interp_table(interp(p.deviation_points, None), fp=(curve_low, curve_span)),
        _interp_table(interp((0.0, 1.0), (p.stability_confidence_floor,
                                          p.stability_confidence_ceiling))),
        _interp_table(interp((p.contractility_bpm_low, p.contractility_bpm_high),
                             (p.s2_s1_ratio_low_bpm, p.s2_s1_ratio_high_bpm))),
        _interp_table(interp(r.rhythm_dev_points, r.rhythm_conf_curve)),
        _interp_table(interp(r.amp_ratio_points, r.amp_conf_curve)),
    ]
    floats = np.concatenate([head, *tables]).astype(npd)
    hist = p.stability_history_window
    if not 1 <= hist <= MAX_HIST:
        raise ValueError(f"the classify kernel keeps a ring of 1-{MAX_HIST} slots, got {hist}")
    ints = np.asarray([
        types.UNCLASSIFIED, types.S1_PAIRED, types.S2_PAIRED, types.LONE_S1_VALIDATED,
        types.LONE_S1_CASCADE, types.LONE_S1_LAST, types.NOISE, types.LONE_OK,
        types.LONE_FIRST_BEAT, types.LONE_REJ_CONFIDENCE, types.LONE_REJ_FORWARD,
        hist, r.cascade_reset_trigger_count, int(p.enable_interval_penalty)], np.int32)
    return floats, ints


def constant_divisors(sample_rate: int, cfg) -> np.ndarray:
    """The float32 constant divisors of the kernel's chain: the BPM span, the
    sample rate, 2 and the dx of each segment of the three interps on the
    chain (ratio, rhythm, amplitude)."""
    floats, _ = constants(sample_rate, cfg, torch.float32)
    out = [floats[6], floats[0], floats[10]]                # C_BPM_SPAN, C_SR, C_TWO
    for which in (2, 3, 4):                                  # I_RATIO, I_RHYTHM, I_AMP
        row = floats[SCALARS + which * TABLE_WIDTH:][:TABLE_WIDTH]
        k = int(row[0])
        out += [dx for dx, dx0 in zip(row[9:9 + k - 1], row[17:17 + k - 1]) if not dx0]
    return np.asarray(out, np.float32)


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
    lib = _library()
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = lib.classify_scan_check_division(d.data_ptr(), len(d), n_per, seed,
                                          mismatches.data_ptr(), stream)
    if rc != 0:
        msg = lib.classify_scan_error_string(rc).decode()
        raise RuntimeError(f"classify_scan division check failed: {msg} ({rc})")
    return int(mismatches.item())


def classify_scan(x, n: int, sample_rate: int, cfg, want_trace: bool = True):
    """(peak_class (B, capacity) int32, ClassifierTrace or None) of the
    carry-dependent loop over ``x`` (a ``classifier.ScanInputs`` whose
    positions lie in [0, n])."""
    from ...models import classifier

    if x.deviation.device.type == "cpu":
        return classifier.scan_plain(x, sample_rate, cfg, want_trace=want_trace)
    device = x.deviation.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    dtype = x.deviation.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    bsz, cap = x.positions.shape
    specs = [("positions", x.positions, torch.int32, (bsz, cap)),
             ("count", x.count, torch.int32, (bsz,)),
             ("start_belief", x.start_belief, dtype, (bsz,)),
             ("flags", x.flags, torch.uint8, (bsz, cap))]
    specs += [(name, getattr(x, name), dtype, (bsz, cap))
              for name in ("deviation", "interval_sec", "s2_s1_ratio", "s1_s2_ratio",
                           "strength", "boost", "implied_bpm")]
    for name, t, want_dtype, shape in specs:
        if t.device != device or t.dtype != want_dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {want_dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cap <= 0 or bsz <= 0:
        raise ValueError(f"unsupported shape {(bsz, cap)}")
    if n >= 1 << 24:
        raise ValueError("positions must stay below 2^24 (exact in float32)")

    key = (sample_rate, cfg, dtype, str(device))
    if key not in _tables:
        if len(_tables) >= 16:
            _tables.pop(next(iter(_tables)))
        floats, ints = constants(sample_rate, cfg, dtype)
        _tables[key] = (torch.as_tensor(floats, device=device),
                        torch.as_tensor(ints, device=device))
    consts, codes = _tables[key]
    peak_class = torch.empty((bsz, cap), dtype=torch.int32, device=device)
    if want_trace:
        ibuf = torch.empty((bsz, cap), dtype=torch.int32, device=device)
        paired = torch.empty((bsz, cap), dtype=torch.bool, device=device)
        fbuf = torch.empty((len(KERNEL_FIELDS), bsz, cap), dtype=dtype, device=device)
        out_ptrs = (ibuf.data_ptr(), paired.data_ptr(), fbuf.data_ptr())
    else:
        out_ptrs = (None, None, None)
    lib = _library()
    fn = lib.classify_scan_f32 if dtype == torch.float32 else lib.classify_scan_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(x.positions.data_ptr(), x.deviation.data_ptr(), x.interval_sec.data_ptr(),
            x.s2_s1_ratio.data_ptr(), x.strength.data_ptr(), x.boost.data_ptr(),
            x.flags.data_ptr(), x.count.data_ptr(), x.start_belief.data_ptr(),
            consts.data_ptr(), codes.data_ptr(), bsz, cap, int(want_trace),
            int(cfg.compat.kickstart_effective), peak_class.data_ptr(), *out_ptrs, stream)
    if rc != 0:
        msg = lib.classify_scan_error_string(rc).decode()
        raise RuntimeError(f"classify_scan kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    if not want_trace:
        return peak_class, None
    fields = dict(zip(KERNEL_FIELDS, fbuf))
    fields.update({f: getattr(x, f) for f in SLOT_FIELDS})
    return peak_class, classifier.ClassifierTrace(
        peak_class=peak_class, paired=paired, lone_reason=ibuf, **fields)
