"""Render the classifier's numeric trace back into the reference's debug
strings — byte-compatible with the `§`-tagged vocabulary the reference
builds inline (bpm_analysis.py:194-196, 238-271, 277-302, 314-329,
1371-1374) and the formatters that parse it back
(``Plotter.format_pairing_details_list`` :336-365,
``format_lone_s1_details_list`` :368-427).

The device emits numbers (confidences, ratios, penalties — see
``ClassifierTrace``); this module is the single place where they become
human-readable text, so plot tooltips and the chronological debug log render
from the same source the way the reference's do.

An own copy of ``bpm_analysis_tpu/reports/trace.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from .. import types


def _pct(x: float) -> str:
    """Python ``format(x, '.0%')``."""
    return format(x, ".0%")


def pairing_reason(tr, i: int, threshold: float) -> str:
    """The pair-attempt reason string for raw-peak slot ``i``
    (bpm_analysis.py:238-271)."""
    base = float(tr.base_conf[i])
    blend = float(tr.blend_ratio[i])
    parts = [f"Base Conf (Blended Model {_pct(blend)} High): {base:.2f}"]
    sf = float(tr.stability_factor[i])
    if not math.isnan(sf):
        parts.append(
            f"\n- Stability Pre-Adjust: x{sf:.2f} (Pairing Ratio: {_pct(float(tr.pairing_ratio[i]))})"
        )
    pen = float(tr.penalty_amount[i])
    if not math.isnan(pen):
        parts.append(
            f"\n- PENALIZED by {pen:.2f} (S2 Str. Ratio {float(tr.s2_s1_ratio[i]):.1f}x"
            f" > Expected {float(tr.max_expected_ratio[i]):.1f}x)"
        )
    boost = float(tr.boost_amount[i])
    if not math.isnan(boost):
        parts.append(
            f"\n- BOOSTED by {boost:.2f} (S1 Str. Ratio {float(tr.s1_s2_ratio[i]):.1f}x > S2)"
        )
    ipen = float(tr.interval_penalty[i])
    if not math.isnan(ipen):
        parts.append(
            f"\n- Interval PENALTY by {ipen:.2f} (Interval {float(tr.interval_sec[i]):.3f}s"
            f" > Max {float(tr.max_interval_sec[i]):.3f}s)"
        )
    conf = float(tr.final_conf[i])
    outcome = "Paired" if bool(tr.paired[i]) else "Not Paired"
    parts.append(f"\n- Final Score: {conf:.2f} vs Threshold {threshold:.2f} -> {outcome}")
    return "".join(parts)


def lone_reason(tr, i: int, cfg) -> str:
    """The lone-S1 validate/reject reason string for slot ``i``
    (bpm_analysis.py:314-329, 1217-1236)."""
    code = int(tr.lone_reason[i])
    thr = cfg.rhythm.lone_s1_confidence_threshold
    conf = float(tr.lone_conf[i])
    rhythm = (
        f"Rhythm Fit={float(tr.rhythm_score[i]):.2f} (Interval {float(tr.actual_rr_sec[i]):.3f}s"
        f" vs Expected {float(tr.expected_rr_sec[i]):.3f}s)"
    )
    amp = (
        f"Amplitude Fit={float(tr.amp_score[i]):.2f}"
        f" (Strength Ratio {float(tr.amp_ratio[i]):.2f}x)"
    )
    if code == types.LONE_FIRST_BEAT:
        return "First beat"
    if code == types.LONE_REJ_CONFIDENCE:
        return (
            f"Rejected Lone S1: Confidence {conf:.2f} < Threshold {thr:.2f}."
            f" ({rhythm}, {amp})"
        )
    if code == types.LONE_REJ_FORWARD:
        return f"Rejected Lone S1: Forward check failed (Implies {float(tr.implied_bpm[i]):.0f} BPM)"
    rw = cfg.rhythm.lone_s1_rhythm_weight
    aw = cfg.rhythm.lone_s1_amplitude_weight
    return (
        f"Validated Lone S1: Confidence {conf:.3f} >= Threshold {thr:.2f}."
        f" ({rhythm}, {amp}, Weights: Rhythm={rw:.2f}, Amplitude={aw:.2f}, Final={conf:.3f})"
    )


def debug_strings(result, cfg) -> Dict[int, str]:
    """Reconstruct the full ``beat_debug_info`` dict: raw-peak sample index →
    `§`-tagged debug string, post-correction (gap-corrected peaks wrapped in
    ``ORIGINAL_REASON`` exactly as bpm_analysis.py:1369-1374)."""
    tr = result.trace
    n_peaks = int(result.raw_peak_count)
    positions = np.asarray(result.raw_peak_positions)[:n_peaks]
    final_classes = np.asarray(result.classes)[:n_peaks]
    pre_classes = np.asarray(result.precorrection_classes)[:n_peaks]
    thr = cfg.pairing.pairing_confidence_threshold

    def base_string(i: int, cls: int) -> Optional[str]:
        if cls == types.S1_PAIRED:
            return (f"{types.CLASS_NAMES[types.S1_PAIRED]}"
                    f"§PAIRING_SUCCESS_REASON§{pairing_reason(tr, i, thr)}")
        if cls == types.S2_PAIRED:
            # The S2's reason is the S1's (written at pair time,
            # bpm_analysis.py:194-196) — slot i-1 carries the attempt.
            return (f"{types.CLASS_NAMES[types.S2_PAIRED]}"
                    f"§PAIRING_SUCCESS_REASON§{pairing_reason(tr, i - 1, thr)}")
        if cls == types.LONE_S1_VALIDATED:
            return (f"{types.CLASS_NAMES[cls]}"
                    f"§PAIRING_FAIL_REASON§{pairing_reason(tr, i, thr)}"
                    f"§LONE_S1_VALIDATE_REASON§{lone_reason(tr, i, cfg)}")
        if cls == types.LONE_S1_CASCADE:
            return (f"{types.CLASS_NAMES[cls]}"
                    f"§PAIRING_FAIL_REASON§{pairing_reason(tr, i, thr)}"
                    f"§LONE_S1_REJECT_REASON§{lone_reason(tr, i, cfg)}")
        if cls == types.LONE_S1_LAST:
            return types.CLASS_NAMES[cls]
        if cls == types.NOISE:
            return (f"{types.NOISE_LOG_NAME}"
                    f"§PAIRING_FAIL_REASON§{pairing_reason(tr, i, thr)}"
                    f"§LONE_S1_REJECT_REASON§{lone_reason(tr, i, cfg)}")
        return None

    out: Dict[int, str] = {}
    for i in range(n_peaks):
        cls = int(final_classes[i])
        pre = int(pre_classes[i])
        if cls in (types.S1_CORRECTED_GAP, types.S2_CORRECTED_GAP):
            original = base_string(i, pre) or types.NOISE_LOG_NAME
            out[int(positions[i])] = (
                f"{types.CLASS_NAMES[cls]}§ORIGINAL_REASON§{original}"
            )
        else:
            s = base_string(i, cls)
            if s is not None:
                out[int(positions[i])] = s
    return out


# --- formatters (reference Plotter.format_* parity) ------------------------
#
# Both renderers (plot tooltips + debug log) format the SAME reason strings,
# one per classified peak — memoizing turns the second renderer's pass into
# dict hits (the formatters are pure; callers only iterate/join the result,
# so the shared tuple is safe).  Bounded so a long batch can't grow the
# cache unboundedly.

def _memoize_formatter(fn):
    import functools

    cached = functools.lru_cache(maxsize=65536)(fn)
    functools.update_wrapper(cached, fn)
    return cached


@_memoize_formatter
def format_pairing_details_list(details_str: str) -> List[str]:
    """Re-render a pairing reason with running-confidence annotations
    (reference bpm_analysis.py:336-365)."""
    import re

    lines = [ln.strip().lstrip("- ") for ln in details_str.strip().split("\n") if ln.strip()]
    if not lines:
        return ["- S1-S2 pairing decision:", "    - No details available."]
    output = ["- S1-S2 pairing decision:"]
    confidence = 0.0
    try:
        m = re.search(r"([\d\.]+)$", lines[0])
        if m:
            confidence = float(m.group(1))
        output.append(f"    - {lines[0]}")
        for line in lines[1:]:
            new_conf = confidence
            if "Stability Pre-Adjust" in line:
                m = re.search(r"x([\d\.]+)", line)
                new_conf *= float(m.group(1)) if m else 1
                output.append(f"    - {line} -> {new_conf:.3f}")
            elif "PENALIZED by" in line:
                m = re.search(r"by ([\d\.]+)", line)
                new_conf -= float(m.group(1)) if m else 0
                output.append(f"    - {line} -> {new_conf:.3f}")
            elif "Interval PENALTY by" in line:
                m = re.search(r"by ([\d\.]+)", line)
                new_conf -= float(m.group(1)) if m else 0
                output.append(f"    - {line} -> {max(0, new_conf):.3f}")
            else:
                output.append(f"    - {line}")
            confidence = new_conf
    except (ValueError, IndexError):
        return ["- S1-S2 pairing decision:", f"    - {details_str}"]
    return output


@_memoize_formatter
def format_lone_s1_details_list(details_str: str) -> List[str]:
    """Re-render a lone-S1 reason as the weighted-calculation breakdown
    (reference bpm_analysis.py:368-427)."""
    import re

    output = ["- Lone S1 decision:"]
    main = re.search(
        r"(Validated|Rejected) Lone S1: Confidence ([\d\.]+) (>=|<) Threshold ([\d\.]+)\. \((.*)\)",
        details_str,
    )
    if not main:
        return ["- Lone S1 decision:", f"\t- {details_str}"]
    try:
        status, conf_s, op, thr_s, reason = main.groups()
        conf = float(conf_s)
        thr = float(thr_s)
        rf = re.search(r"Rhythm Fit=([\d\.]+)", reason)
        rd = re.search(r"\(Interval .*?s vs Expected .*?s\)", reason)
        af = re.search(r"Amplitude Fit=([\d\.]+)", reason)
        ad = re.search(r"\(Strength Ratio .*?x\)", reason)
        rw = re.search(r"Rhythm=([\d\.]+)", reason)
        aw = re.search(r"Amplitude=([\d\.]+)", reason)
        rhythm_score = float(rf.group(1))
        output.append(f"\t- Rhythm Fit={rhythm_score:.2f} {rd.group(0)}")
        amp_score = float(af.group(1))
        output.append(f"\t- Amplitude Fit={amp_score:.2f} {ad.group(0)}")
        if rw and aw:
            rwv, awv = float(rw.group(1)), float(aw.group(1))
            rc, ac = rhythm_score * rwv, amp_score * awv
            output.append("\t- Weighted Calculation:")
            output.append(f"\t\t- Rhythm: {rhythm_score:.2f} × {rwv:.2f} = {rc:.3f}")
            output.append(f"\t\t- Amplitude: {amp_score:.2f} × {awv:.2f} = {ac:.3f}")
            output.append(f"\t\t- Final: {rc:.3f} + {ac:.3f} = {conf:.3f}")
        outcome = "Validated" if "Validated" in status else "Rejected"
        output.append(f"- Final Score: Confidence {conf:.3f} {op} {thr:.2f} -> {outcome}")
    except (AttributeError, ValueError, IndexError):
        return ["- Lone S1 decision:", f"\t- {details_str}"]
    return output
