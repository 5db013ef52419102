"""Chronological debug log (reference ``ReportGenerator.create_chronological_log``
+ ``_prepare_log_data`` + ``_write_log_events``, bpm_analysis.py:815-906).

The reference builds a full-sample-length DataFrame and ``merge_asof``s every
peak/trough event against it.  Since every event sits exactly on a sample,
the nearest-merge reduces to direct indexing (noise floor) and as-of lookups
(smoothed BPM, belief) — no dense frame needed:

* ``noise_floor`` at an event = floor at the event's sample,
* ``smoothed_bpm``/``lt_bpm`` = forward-filled series as-of the event time
  (the sample-grid ffill of the reference is exactly as-of),
* duplicate belief timestamps are mean-grouped first (the reference's
  ``groupby(level=0).mean()`` at :850 — belief history carries one entry per
  loop iteration, so no-candidate iterations repeat timestamps).

An own copy of ``bpm_analysis_tpu/reports/debug_log.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np

from .. import types
from . import trace as trace_mod


def build_events(result, cfg, sample_rate: int, debug=None):
    """Time-sorted event list: (time, kind, amp, debug_string).
    ``debug``: optionally a precomputed ``trace.debug_strings`` dict
    shared with the plot renderer."""
    n_troughs = int(result.trough_count)
    troughs = np.asarray(result.trough_positions)[:n_troughs]
    if debug is None:
        debug = trace_mod.debug_strings(result, cfg)

    events = []
    for pos, reason in debug.items():
        events.append((pos / sample_rate, "Peak", pos, reason))
    for pos in troughs:
        events.append((pos / sample_rate, "Trough", int(pos), ""))
    events.sort(key=lambda e: e[0])
    return events


def render(result, cfg, envelope: np.ndarray, sample_rate: int, file_name: str,
           now: Optional[datetime.datetime] = None, debug=None) -> str:
    now = now or datetime.datetime.now()
    events = build_events(result, cfg, sample_rate, debug=debug)

    # May be a dense ndarray (serial path) or a host.SampledEnv view holding
    # exactly the event-position values (batched render pack) — only ever
    # indexed at event positions below.
    floor = result.floor

    # smoothed BPM as-of series
    m = result.metrics.bpm
    count = int(m.count)
    bpm_t = np.asarray(m.times)[:count]
    bpm_v = np.asarray(m.smoothed)[:count]

    # belief as-of series: mean-group duplicate timestamps
    bt = np.asarray(result.trace.belief_time_sec)
    bv = np.asarray(result.trace.belief)
    ok = ~np.isnan(bt)
    bt, bv = bt[ok], bv[ok]
    if len(bt):
        uniq, inv = np.unique(bt, return_inverse=True)
        sums = np.zeros(len(uniq))
        cnts = np.zeros(len(uniq))
        np.add.at(sums, inv, bv)
        np.add.at(cnts, inv, 1)
        bt, bv = uniq, sums / cnts

    # Vectorized per-event metric lookups (one searchsorted per series for
    # the WHOLE event list instead of per event; one batch gather for the
    # amp/floor columns): the debug log is the heaviest host artifact
    # (~5k events/file) and renders on the fetch thread of a 1-core host.
    tol = 0.5 / sample_rate
    ev_t = np.array([e[0] for e in events], dtype=float)
    ev_pos = np.array([e[2] for e in events], dtype=np.int64)
    if len(events):
        amp_col = np.asarray(envelope[ev_pos], dtype=float)
        floor_col = np.asarray(floor[ev_pos], dtype=float)
        if count:
            i = np.searchsorted(bpm_t, ev_t + tol, side="right") - 1
            bpm_col = np.where(i >= 0, bpm_v[np.maximum(i, 0)], np.nan)
        else:
            bpm_col = np.full(len(events), np.nan)
        if len(bt):
            i = np.searchsorted(bt, ev_t + tol, side="right") - 1
            belief_col = np.where(i >= 0, bv[np.maximum(i, 0)], np.nan)
        else:
            belief_col = np.full(len(events), np.nan)

    out = []
    out.append(f"# Chronological Debug Log for {os.path.basename(file_name)}")
    out.append(f"Analysis performed on: {now.strftime('%Y-%m-%d %H:%M:%S')}\n")

    for ev_i, (t, kind, pos, reason) in enumerate(events):
        out.append(f"## Time: `{t:.4f}s`")
        if kind == "Trough":
            out.append("**Trough Detected**")
        elif not reason:
            out.append("**Unclassified Peak**")
        else:
            parts = reason.split("§")
            peak_type, details = parts[0], parts[1:]
            out.append(f"**{peak_type}.**")
            i = 0
            while i < len(details):
                tag = details[i]
                value = details[i + 1] if (i + 1) < len(details) else ""
                formatted = ""
                if "PAIRING" in tag:
                    formatted = "\n".join(trace_mod.format_pairing_details_list(value))
                elif "LONE_S1_REJECT_REASON" in tag or "LONE_S1_VALIDATE_REASON" in tag:
                    formatted = "\n".join(trace_mod.format_lone_s1_details_list(value))
                elif "ORIGINAL_REASON" in tag:
                    formatted = f"- Original Classification:\n    - `{value}`"
                if formatted:
                    out.append(formatted)
                i += 2

        metrics = {
            "Raw Amp": amp_col[ev_i],
            "Noise Floor": floor_col[ev_i],
            "Average BPM (Smoothed)": bpm_col[ev_i],
            "Long-Term BPM (Belief)": belief_col[ev_i],
        }
        for name, value in metrics.items():
            if not np.isnan(value):
                out.append(f"- **{name}**: `{value:.1f}`")
        out.append("\n")
    out.append("")
    return "\n".join(out)


def save(result, cfg, envelope: np.ndarray, sample_rate: int, file_name: str,
         output_directory: str, debug=None) -> str:
    base = os.path.basename(os.path.splitext(file_name)[0])
    path = os.path.join(output_directory, f"{base}_Debug_Log.md")
    text = render(result, cfg, envelope, sample_rate, file_name, debug=debug)
    with open(path, "w", encoding="utf-8") as f:
        if not text.strip():
            f.write("# No significant events detected to log.\n")
        else:
            f.write(text)
    return path
