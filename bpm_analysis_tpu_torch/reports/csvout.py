"""BPM-curve CSV writer (reference Plotter CSV block,
bpm_analysis.py:458-473): header ``Time (s),Average BPM``, 3-decimal
formatting, NaN rows skipped.

An own copy of ``bpm_analysis_tpu/reports/csvout.py``: the port imports nothing
of the JAX package."""
from __future__ import annotations

import csv

import numpy as np


def write_bpm_csv(path: str, times: np.ndarray, smoothed_bpm: np.ndarray) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["Time (s)", "Average BPM"])
        for t, b in zip(times, smoothed_bpm):
            if not np.isnan(b):
                w.writerow([f"{t:.3f}", f"{b:.3f}"])


def bpm_rows(result):
    """Valid (time, bpm) rows from a PipelineResult."""
    m = result.metrics.bpm
    count = int(m.count)
    times = np.asarray(m.times)[:count]
    bpm = np.asarray(m.smoothed)[:count]
    return times, bpm
