"""Markdown analysis summary (reference ``ReportGenerator`` summary path,
bpm_analysis.py:801-813, 908-985): overall table, steepest-slope tables,
significant-changes lists, full BPM table.

An own copy of ``bpm_analysis_tpu/reports/summary.py``: the port imports nothing
of the JAX package."""
from __future__ import annotations

import datetime
import os

import numpy as np


def _mmss(seconds: float) -> str:
    """Reference formats period bounds via datetime ``%M:%S``
    (bpm_analysis.py:934)."""
    return (datetime.datetime.fromtimestamp(0)
            + datetime.timedelta(seconds=float(seconds))).strftime("%M:%S")


def render(result, file_name: str, now: datetime.datetime | None = None) -> str:
    m = result.metrics
    now = now or datetime.datetime.now()
    lines = []
    lines.append(f"# Analysis Report for: {os.path.basename(file_name)}")
    lines.append(f"*Generated on: {now.strftime('%Y-%m-%d %H:%M:%S')}*\n")

    lines.append("## Overall Summary\n")
    lines.append("| Metric | Value |")
    lines.append("|:---|:---|")
    avg = float(m.avg_bpm)
    if not np.isnan(avg):
        lines.append(f"| **Average BPM** | {avg:.1f} BPM |")
        lines.append(f"| **BPM Range** | {float(m.min_bpm):.1f} to {float(m.max_bpm):.1f} BPM |")
    if not np.isnan(float(m.avg_rmssdc)):
        lines.append(f"| **Avg. Corrected RMSSD** | {float(m.avg_rmssdc):.2f} |")
    if not np.isnan(float(m.avg_sdnn)):
        lines.append(f"| **Avg. Windowed SDNN** | {float(m.avg_sdnn):.2f} ms |")
    if bool(m.hrr.found):
        lines.append(f"| **1-Minute HRR** | {float(m.hrr.hrr):.1f} BPM Drop |")
    lines.append("")

    lines.append("## Steepest Slopes Analysis\n")
    lines.append("### Peak Exertion (Fastest HR Increase)\n")
    pe = m.peak_exertion
    if bool(pe.found):
        lines.append("| Attribute | Value |")
        lines.append("|:---|:---|")
        lines.append(f"| **Rate** | `+{float(pe.slope):.2f}` BPM/second |")
        lines.append(f"| **Period** | {_mmss(pe.start_time)} to {_mmss(pe.end_time)} |")
        lines.append(f"| **Duration** | {float(pe.duration):.1f} seconds |")
        lines.append(f"| **BPM Change** | {float(pe.start_bpm):.1f} to {float(pe.end_bpm):.1f} BPM |\n")
    else:
        lines.append("*No significant peak exertion period found.*\n")

    lines.append("### Peak Recovery (Fastest HR Decrease)\n")
    pr = m.peak_recovery
    if bool(pr.found):
        lines.append("| Attribute | Value |")
        lines.append("|:---|:---|")
        lines.append(f"| **Rate** | `{float(pr.slope):.2f}` BPM/second |")
        lines.append(f"| **Period** | {_mmss(pr.start_time)} to {_mmss(pr.end_time)} |")
        lines.append(f"| **Duration** | {float(pr.duration):.1f} seconds |")
        lines.append(f"| **BPM Change** | {float(pr.start_bpm):.1f} to {float(pr.end_bpm):.1f} BPM |\n")
    else:
        lines.append("*No significant peak recovery period found post-peak.*\n")

    lines.append("## All Significant HR Changes\n")
    lines.append("### Exertion Periods (Sustained HR Increase)\n")
    inc = m.inclines
    n_inc = int(inc.count)
    if n_inc:
        for i in range(n_inc):
            lines.append(
                f"- **From {float(inc.start_time[i]):.1f}s to {float(inc.end_time[i]):.1f}s:**"
                f" Duration={float(inc.duration[i]):.1f}s,"
                f" Change=`+{float(inc.bpm_change[i]):.1f}` BPM"
            )
    else:
        lines.append("*None found.*")
    lines.append("")
    lines.append("### Recovery Periods (Sustained HR Decrease)\n")
    dec = m.declines
    n_dec = int(dec.count)
    if n_dec:
        for i in range(n_dec):
            lines.append(
                f"- **From {float(dec.start_time[i]):.1f}s to {float(dec.end_time[i]):.1f}s:**"
                f" Duration={float(dec.duration[i]):.1f}s,"
                f" Change=`-{-float(dec.bpm_change[i]):.1f}` BPM"
            )
    else:
        lines.append("*None found.*")
    lines.append("")

    lines.append("## Heartbeat Data (BPM over Time)\n")
    lines.append("| Time (s) | Average BPM |")
    lines.append("|:---:|:---:|")
    count = int(m.bpm.count)
    times = np.asarray(m.bpm.times)[:count]
    bpm = np.asarray(m.bpm.smoothed)[:count]
    wrote = False
    for t, b in zip(times, bpm):
        if not np.isnan(b):
            lines.append(f"| {t:.2f} | {b:.1f} |")
            wrote = True
    if not wrote:
        lines.append("| *No data* | *No data* |")
    return "\n".join(lines) + "\n"


def save(result, file_name: str, output_directory: str) -> str:
    base = os.path.basename(os.path.splitext(file_name)[0])
    path = os.path.join(output_directory, f"{base}_Analysis_Summary.md")
    with open(path, "w", encoding="utf-8") as f:
        f.write(render(result, file_name))
    return path
