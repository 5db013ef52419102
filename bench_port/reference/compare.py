"""The comparison that decides ``correct``: each answer the program
returned in the window against the upstream analyzer's answer for the same
recording (``upstream.py``), and each number the worst over those answers.

An answer (``answer_of``) holds a recording's final beat positions at the
post rate and its smoothed BPM series.  The numbers:

- ``beats_moved_pct``: final beats at a sample position that only one
  side has, as a share of the upstream answer's beats;
- ``bpm_mae``: the mean absolute gap of the smoothed BPM series, BPM, the
  program's series read at the upstream answer's times (the upstream
  accuracy measure of ``bench.py``);
- ``csv_mae``: the same for the BPM CSV the program wrote, as printed;
- ``answers_failed``: attempted answers that failed (a capacity
  overflowed, no beats, an error), never came, or have no upstream answer;
  traffic is chosen so that none fails.

A NaN on one side only counts as an infinite gap; NaN on both as none."""
import csv

import numpy as np


def answer_of(row) -> dict:
    """The compared fields of one recording's result row (numpy leaves;
    any object with the pipeline result's field names)."""
    count = int(row.final_count)
    bpm = row.metrics.bpm
    k = int(bpm.count)
    return {"positions": np.asarray(row.final_positions[:count], np.int64),
            "bpm_times": np.asarray(bpm.times[:k], np.float64),
            "bpm": np.asarray(bpm.smoothed[:k], np.float64)}


def read_csv(path: str):
    """(times, BPM) of a BPM CSV: a header row, then ``time,bpm`` rows."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))[1:]
    return (np.array([float(r[0]) for r in rows]), np.array([float(r[1]) for r in rows]))


def series_mae(times, values, ref_times, ref_values) -> float:
    """Mean absolute gap of a series against the reference's, read at the
    reference's times."""
    times, values = np.asarray(times, np.float64), np.asarray(values, np.float64)
    if len(ref_times) == 0 and len(times) == 0:
        return 0.0
    if len(ref_times) == 0 or len(times) == 0:
        return float("inf")
    at = np.interp(ref_times, times, values)
    nan_a, nan_b = np.isnan(at), np.isnan(ref_values)
    if np.any(nan_a != nan_b):
        return float("inf")
    keep = ~nan_b
    return float(np.mean(np.abs(at[keep] - ref_values[keep]))) if keep.any() else 0.0


def moved_pct(got: np.ndarray, ref: np.ndarray) -> float:
    """Positions on one side only, % of the reference's count."""
    return 100.0 * len(np.setxor1d(got, ref)) / max(len(ref), 1)


def numbers(got: dict, ref: dict) -> dict:
    """The compared numbers of one answer against the upstream answer."""
    out = {"beats_moved_pct": moved_pct(got["positions"], ref["positions"]),
           "bpm_mae": series_mae(got["bpm_times"], got["bpm"], ref["bpm_times"], ref["bpm"])}
    if "csv" in got:
        out["csv_mae"] = series_mae(*got["csv"], ref["bpm_times"], ref["bpm"])
    return out


def worst(readings: list) -> dict:
    """Each number's largest reading over the compared answers."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
