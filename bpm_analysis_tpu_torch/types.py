"""Peak taxonomy and structured trace records.

The reference classifies peaks with a string enum and *reads its own debug
strings* as state (SURVEY.md §7 "hard parts"): pairing ratio counts
``"S1 (Paired)" in debug_info[idx]`` (bpm_analysis.py:140,185), kick-start
greps for "Lone S1"/"Noise" (:151-161), the gap fixer greps for "Noise"
(:1351,1357).  The rebuild replaces all of that with the integer codes
below, carried as scan outputs; the human-readable strings of the reference
(PeakType at bpm_analysis.py:26-46) are regenerated on host by
``bpm_analysis_tpu.reports.trace`` from the numeric trace fields.
"""
from __future__ import annotations

import numpy as np

# --- integer peak classes (device-side) -----------------------------------
UNCLASSIFIED = 0
S1_PAIRED = 1
S2_PAIRED = 2
LONE_S1_VALIDATED = 3
LONE_S1_CASCADE = 4
LONE_S1_LAST = 5
NOISE = 6
S1_CORRECTED_GAP = 7
S2_CORRECTED_GAP = 8
S2_CORRECTED_CONFLICT = 9

# Display strings — byte-identical to reference PeakType values
# (bpm_analysis.py:28-36).
CLASS_NAMES = {
    UNCLASSIFIED: "",
    S1_PAIRED: "S1 (Paired)",
    S2_PAIRED: "S2 (Paired)",
    LONE_S1_VALIDATED: "Lone S1",
    LONE_S1_CASCADE: "Lone S1 (Corrected by Cascade Reset)",
    LONE_S1_LAST: "Lone S1 (Last Peak)",
    NOISE: "Noise/Rejected",
    S1_CORRECTED_GAP: "S1 (Paired - Corrected from Gap)",
    S2_CORRECTED_GAP: "S2 (Paired - Corrected from Gap)",
    S2_CORRECTED_CONFLICT: "S2 (Paired - Corrected from Conflict)",
}

# NOTE: the reference writes the *raw string* "Noise" (not PeakType.NOISE's
# value "Noise/Rejected") as the class prefix for rejected peaks
# (bpm_analysis.py:302) — the debug log shows "**Noise.**".  Keep both.
NOISE_LOG_NAME = "Noise"

# Sets used by host-side logic mirroring PeakType.is_s1/is_s2
# (bpm_analysis.py:38-46).
S1_CLASSES = frozenset({S1_PAIRED, LONE_S1_VALIDATED, LONE_S1_CASCADE, LONE_S1_LAST,
                        S1_CORRECTED_GAP})
S2_CLASSES = frozenset({S2_PAIRED, S2_CORRECTED_GAP, S2_CORRECTED_CONFLICT})
BEAT_CLASSES = S1_CLASSES  # classes that enter the candidate-beat list


def is_s1(code: int) -> bool:
    return int(code) in S1_CLASSES


def is_s2(code: int) -> bool:
    return int(code) in S2_CLASSES


# --- lone-S1 rejection reason codes (device-side) --------------------------
# The cascade-reset counter only increments for "Rhythm Fit" rejections
# (bpm_analysis.py:286) — i.e. confidence-threshold rejections whose reason
# string embeds the rhythm-fit breakdown, NOT forward-check rejections.
LONE_OK = 0
LONE_FIRST_BEAT = 1       # "First beat" fast-accept (bpm_analysis.py:306)
LONE_REJ_CONFIDENCE = 2   # confidence < threshold (counts toward cascade)
LONE_REJ_FORWARD = 3      # forward-check failed (does NOT count)


def labels_to_codes(labels) -> np.ndarray:
    """Map reference debug-string class prefixes to integer codes (host)."""
    rev = {v: k for k, v in CLASS_NAMES.items() if v}
    rev[NOISE_LOG_NAME] = NOISE
    return np.array([rev.get(str(s).strip(), UNCLASSIFIED) for s in labels], dtype=np.int32)
