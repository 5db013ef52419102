"""Interactive analysis plot (reference ``Plotter``, bpm_analysis.py:332-780).

Two backends:

* **plotly** (when installed): reproduces the reference figure — dark theme,
  secondary y-axis, downsampled envelope + noise-floor lines, trough
  markers, S1/S2/Noise marker traces with fully formatted per-peak decision
  tooltips, BPM/belief/HRV traces, exertion/recovery slope segments, min/max
  annotations and the summary box.
* **standalone HTML/SVG fallback** (this environment ships no plotly): a
  self-contained HTML file with an inline SVG chart carrying the same
  traces (envelope, noise floor, S1/S2/noise markers with hover titles, BPM
  curve) so the artifact set stays complete.

Both write ``{base}_bpm_plot.html``; the CSV beside it comes from
``reports.csvout``.

An own copy of ``bpm_analysis_tpu/reports/plot.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import datetime
import html
import os
from typing import Dict, List, Optional

import numpy as np

from .. import types
from . import trace as trace_mod

def _plotly_modules():
    """Resolve plotly lazily (per save) so the figure path stays testable:
    tests inject recording stubs into ``sys.modules`` and the real
    environment picks up plotly if/when it is installed."""
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots

        return go, make_subplots
    except ImportError:
        return None, None


def peak_hover_text(result, cfg, envelope, sample_rate,
                    debug: Optional[Dict[int, str]] = None) -> Dict[int, str]:
    """Per-peak HTML tooltip text (reference ``_add_peak_traces`` loop,
    bpm_analysis.py:569-605).  ``debug``: optionally a precomputed
    ``trace.debug_strings(result, cfg)`` dict shared with the debug-log
    renderer (both read the same strings; building it twice per file is
    pure waste on the 1-core render thread)."""
    if debug is None:
        debug = trace_mod.debug_strings(result, cfg)
    out = {}
    # One vectorized gather for every tooltip's amplitude — per-peak scalar
    # indexing costs a searchsorted each on host.SampledEnv views (~15 us x
    # thousands of peaks on the 1-core render thread).
    all_pos = np.fromiter(debug.keys(), dtype=np.int64, count=len(debug))
    all_amp = np.asarray(envelope[all_pos], dtype=float) if len(debug) else \
        np.zeros(0)
    for (pos, reason), amp in zip(debug.items(), all_amp):
        parts = reason.split("§")
        peak_type, details = parts[0], parts[1:]
        blocks = [
            f"<b>Type:</b> {peak_type}",
            f"<b>Time:</b> {pos / sample_rate:.2f}s",
            f"<b>Amp:</b> {amp:.0f}",
            "---",
        ]
        i = 0
        while i < len(details):
            tag = details[i]
            value = details[i + 1] if (i + 1) < len(details) else ""
            lines: List[str] = []
            if "PAIRING" in tag:
                lines = trace_mod.format_pairing_details_list(value)
            elif "LONE_S1" in tag:
                lines = trace_mod.format_lone_s1_details_list(value)
            elif "ORIGINAL_REASON" in tag:
                lines = ["- Original Classification:",
                         f"&nbsp;&nbsp;&nbsp;&nbsp;- {value.replace('`', '')}"]
            if lines:
                blocks.append("<br>".join(
                    l.replace("\t", "&nbsp;&nbsp;&nbsp;&nbsp;") for l in lines))
            i += 2
        out[pos] = "<br>".join(blocks)
    return out


def _peak_groups(result, cfg, envelope, sample_rate, debug=None):
    hover = peak_hover_text(result, cfg, envelope, sample_rate, debug=debug)
    n = int(result.raw_peak_count)
    positions = np.asarray(result.raw_peak_positions)[:n]
    classes = np.asarray(result.classes)[:n]
    amps = np.asarray(envelope[positions.astype(np.int64)], dtype=float) \
        if n else np.zeros(0)
    groups = {"s1": ([], []), "s2": ([], []), "noise": ([], [])}
    for pos, cls, amp in zip(positions, classes, amps):
        pos = int(pos)
        text = hover.get(pos, (f"<b>Type:</b> Unclassified<br><b>Time:</b> {pos/sample_rate:.2f}s"
                               f"<br><b>Amp:</b> {amp:.0f}"
                               "<br><b>Details:</b> Peak was not evaluated by the classifier."))
        key = "s1" if cls in types.S1_CLASSES else "s2" if cls in types.S2_CLASSES else "noise"
        groups[key][0].append(pos)
        groups[key][1].append(text)
    return groups


def slope_segments(metrics) -> List[Dict]:
    """Exertion/recovery slope segments for the figure (reference
    ``_add_slope_traces``, bpm_analysis.py:733-780): the major incline and
    decline lists plus the two steepest fixed-window slopes.  Shared by the
    plotly and SVG backends."""
    segs: List[Dict] = []
    for name, lst in (("Exertion", metrics.inclines), ("Recovery", metrics.declines)):
        cnt = int(lst.count)
        for i in range(cnt):
            segs.append({
                "kind": name,
                "x": (float(lst.start_time[i]), float(lst.end_time[i])),
                "y": (float(lst.start_bpm[i]), float(lst.end_bpm[i])),
                "duration": float(lst.duration[i]),
                "bpm_change": float(lst.bpm_change[i]),
                "slope": float(lst.slope[i]),
                "first": i == 0,
            })
    for name, st in (("Peak Recovery Slope", metrics.peak_recovery),
                     ("Peak Exertion Slope", metrics.peak_exertion)):
        if bool(st.found):
            segs.append({
                "kind": name,
                "x": (float(st.start_time), float(st.end_time)),
                "y": (float(st.start_bpm), float(st.end_bpm)),
                "duration": float(st.duration),
                "bpm_change": float(st.end_bpm) - float(st.start_bpm),
                "slope": float(st.slope),
                "first": True,
            })
    return segs


def summary_box_text(metrics, html_breaks=True) -> str:
    """The summary annotation (reference ``_add_annotations_and_summary``,
    bpm_analysis.py:695-731)."""
    lines = ["<b>Analysis Summary</b>"]
    if not np.isnan(float(metrics.avg_bpm)):
        lines.append(f"Avg/Min/Max BPM: {float(metrics.avg_bpm):.1f} / "
                     f"{float(metrics.min_bpm):.1f} / {float(metrics.max_bpm):.1f}")
    if bool(metrics.hrr.found):
        lines.append(f"<b>1-Min HRR: {float(metrics.hrr.hrr):.1f} BPM Drop</b>")
    if bool(metrics.peak_recovery.found):
        lines.append(f"<b>Peak Recovery Rate: {float(metrics.peak_recovery.slope):.2f} BPM/sec</b>")
    if not np.isnan(float(metrics.avg_rmssdc)):
        lines.append(f"Avg. Corrected RMSSD: {float(metrics.avg_rmssdc):.2f}")
    if not np.isnan(float(metrics.avg_sdnn)):
        lines.append(f"Avg. Windowed SDNN: {float(metrics.avg_sdnn):.2f} ms")
    sep = "<br>" if html_breaks else "\n"
    return sep.join(lines)


def bpm_extrema(metrics):
    """(max_bpm, max_time, min_bpm, min_time) of the smoothed curve, or None
    (reference min/max annotations, bpm_analysis.py:697-714)."""
    cnt = int(metrics.bpm.count)
    if not cnt:
        return None
    bv = np.asarray(metrics.bpm.smoothed)[:cnt]
    bt = np.asarray(metrics.bpm.times)[:cnt]
    ok = ~np.isnan(bv)
    if not ok.any():
        return None
    bv, bt = bv[ok], bt[ok]
    imax, imin = int(np.argmax(bv)), int(np.argmin(bv))
    return float(bv[imax]), float(bt[imax]), float(bv[imin]), float(bt[imin])


def save(result, cfg, envelope: np.ndarray, sample_rate: int, file_name: str,
         output_directory: str, debug=None):
    base = os.path.basename(os.path.splitext(file_name)[0])
    path = os.path.join(output_directory, f"{base}_bpm_plot.html")
    go, make_subplots = _plotly_modules()
    if go is not None:
        fig = _plotly_figure(go, make_subplots, result, cfg, envelope,
                             sample_rate, file_name, debug=debug)
        fig.write_html(path, config={"scrollZoom": True})
        return fig, path
    _svg_fallback(result, cfg, envelope, sample_rate, file_name, path,
                  debug=debug)
    return None, path


def _plotly_figure(go, make_subplots, result, cfg, envelope, sample_rate,
                   file_name, debug=None):
    fig = make_subplots(specs=[[{"secondary_y": True}]])
    epoch = datetime.datetime.fromtimestamp(0)

    def dt(seconds):
        return [epoch + datetime.timedelta(seconds=float(s)) for s in seconds]

    n = len(envelope)
    factor = max(1, cfg.output.plot_downsample_factor)
    ts = np.arange(n)[::factor] / sample_rate
    fig.add_trace(go.Scatter(x=dt(ts), y=envelope[::factor], name="Audio Envelope",
                             line=dict(color="#47a5c4")), secondary_y=False)
    floor = np.asarray(result.floor)[::factor]
    fig.add_trace(go.Scatter(x=dt(ts), y=floor, name="Dynamic Noise Floor",
                             line=dict(color="green", dash="dot", width=1.5),
                             hovertemplate="Noise Floor: %{y:.2f}<extra></extra>"),
                  secondary_y=False)

    n_troughs = int(result.trough_count)
    troughs = np.asarray(result.trough_positions)[:n_troughs]
    fig.add_trace(go.Scatter(x=dt(troughs / sample_rate), y=envelope[troughs], mode="markers",
                             name="Troughs", marker=dict(color="green", symbol="circle-open",
                                                         size=6),
                             visible="legendonly"), secondary_y=False)

    groups = _peak_groups(result, cfg, envelope, sample_rate, debug=debug)
    style = {"s1": ("S1 Beats", dict(color="#e36f6f", size=8, symbol="diamond")),
             "s2": ("S2 Beats", dict(color="orange", symbol="circle", size=6)),
             "noise": ("Noise/Rejected", dict(color="grey", symbol="x", size=6))}
    for key, (positions, texts) in groups.items():
        if not positions:
            continue
        name, marker = style[key]
        fig.add_trace(go.Scatter(x=dt(np.asarray(positions) / sample_rate),
                                 y=envelope[np.asarray(positions)], mode="markers",
                                 name=name, marker=marker, customdata=texts,
                                 hovertemplate="%{customdata}<extra></extra>"),
                      secondary_y=False)

    m = result.metrics
    count = int(m.bpm.count)
    if count:
        bt = np.asarray(m.bpm.times)[:count]
        bv = np.asarray(m.bpm.smoothed)[:count]
        fig.add_trace(go.Scatter(x=dt(bt), y=bv, name="Average BPM",
                                 line=dict(color="#4a4a4a", width=3)), secondary_y=True)
    belief_t = np.asarray(result.trace.belief_time_sec)
    okb = ~np.isnan(belief_t)
    if okb.any():
        fig.add_trace(go.Scatter(x=dt(belief_t[okb]), y=np.asarray(result.trace.belief)[okb],
                                 name="BPM Trend (Belief)",
                                 line=dict(color="orange", width=2, dash="dot"),
                                 visible="legendonly"), secondary_y=True)
    nh = int(m.hrv.count)
    if nh:
        ht = np.asarray(m.hrv.time)[:nh]
        fig.add_trace(go.Scatter(x=dt(ht), y=np.asarray(m.hrv.rmssdc)[:nh], name="RMSSDc",
                                 line=dict(color="cyan", width=2), visible="legendonly"),
                      secondary_y=True)
        fig.add_trace(go.Scatter(x=dt(ht), y=np.asarray(m.hrv.sdnn)[:nh], name="SDNN",
                                 line=dict(color="magenta", width=2), visible="legendonly"),
                      secondary_y=True)

    # Exertion/recovery slope segments (reference bpm_analysis.py:733-780).
    seg_style = {
        "Exertion": dict(color="purple", width=4, dash="dash"),
        "Recovery": dict(color="#2ca02c", width=4, dash="dash"),
        "Peak Recovery Slope": dict(color="#ff69b4", width=5, dash="solid"),
        "Peak Exertion Slope": dict(color="#9d32a8", width=5, dash="solid"),
    }
    for seg in slope_segments(m):
        c = [seg["duration"], abs(seg["bpm_change"]), seg["slope"]]
        fig.add_trace(go.Scatter(
            x=dt(seg["x"]), y=list(seg["y"]), mode="lines",
            line=seg_style[seg["kind"]], name=seg["kind"],
            legendgroup=seg["kind"], showlegend=seg["first"],
            visible="legendonly",
            hovertemplate=(f"<b>{seg['kind']}</b><br>Duration: %{{customdata[0]:.1f}}s"
                           "<br>ΔBPM: %{customdata[1]:.1f}"
                           "<br>Slope: %{customdata[2]:.2f} BPM/sec<extra></extra>"),
            customdata=np.array([c, c])), secondary_y=True)

    # Min/max annotations + summary box (reference bpm_analysis.py:695-731).
    ext = bpm_extrema(m)
    if ext is not None:
        max_bpm, max_t, min_bpm, min_t = ext
        fig.add_annotation(x=dt([max_t])[0], y=max_bpm,
                           text=f"Max: {max_bpm:.1f} BPM", showarrow=True,
                           arrowhead=1, ax=20, ay=-40,
                           font=dict(color="#e36f6f"), yref="y2")
        fig.add_annotation(x=dt([min_t])[0], y=min_bpm,
                           text=f"Min: {min_bpm:.1f} BPM", showarrow=True,
                           arrowhead=1, ax=20, ay=40,
                           font=dict(color="#a3d194"), yref="y2")
    fig.add_annotation(text=summary_box_text(m), align="left", showarrow=False,
                       xref="paper", yref="paper", x=0.02, y=0.98,
                       bordercolor="black", borderwidth=1,
                       bgcolor="rgba(255, 253, 231, 0.4)")

    fig.update_layout(template="plotly_dark",
                      title_text=f"Heartbeat Analysis - {os.path.basename(file_name)}",
                      dragmode="pan", hovermode="x unified",
                      legend=dict(orientation="h", yanchor="bottom", y=1.02,
                                  xanchor="right", x=1),
                      margin=dict(t=140, b=100))
    # Robust amplitude axis (reference bpm_analysis.py:503-506):
    # 95th percentile of the plotted envelope x plot_amplitude_scale_factor.
    robust_upper = float(np.quantile(envelope[::factor], 0.95)) or 1.0
    fig.update_yaxes(title_text="Signal Amplitude", secondary_y=False,
                     range=[0, robust_upper * cfg.output.plot_amplitude_scale_factor])
    fig.update_yaxes(title_text="BPM / HRV", secondary_y=True, range=[50, 200])
    return fig


def _svg_fallback(result, cfg, envelope, sample_rate, file_name, path,
                  debug=None):
    """Minimal self-contained HTML+SVG rendering of the core traces."""
    W, H = 1200, 500
    n = len(envelope)
    step = max(1, n // 2400)
    env_ds = envelope[::step]
    # Scale from the PLOTTED points (identical whether `envelope` is dense or
    # a host.SampledEnv view carrying exactly the [::step] grid — both paths
    # must render byte-identical SVGs).
    emax = float(np.quantile(env_ds, 0.99)) * 2 or 1.0

    def sx(i):
        return i / n * W

    def sy_amp(v):
        return H - min(v / emax, 1.0) * H

    def sy_bpm(b):
        return H - (min(max(b, 50), 200) - 50) / 150 * H

    env_pts = " ".join(f"{sx(i*step):.1f},{sy_amp(v):.1f}" for i, v in enumerate(env_ds))
    floor = result.floor[::step]          # ndarray or SampledEnv view
    floor_pts = " ".join(f"{sx(i*step):.1f},{sy_amp(v):.1f}" for i, v in enumerate(floor))

    groups = _peak_groups(result, cfg, envelope, sample_rate, debug=debug)
    marker_svg = []
    colors = {"s1": "#e36f6f", "s2": "orange", "noise": "grey"}
    for key, (positions, texts) in groups.items():
        amps = np.asarray(envelope[np.asarray(positions, dtype=np.int64)],
                          dtype=float) if positions else np.zeros(0)
        for pos, text, amp in zip(positions, texts, amps):
            title = html.escape(text.replace("<br>", "\n").replace("<b>", "").replace("</b>", ""))
            marker_svg.append(
                f'<circle cx="{sx(pos):.1f}" cy="{sy_amp(amp):.1f}" r="3" '
                f'fill="{colors[key]}"><title>{title}</title></circle>'
            )

    m = result.metrics.bpm
    count = int(m.count)
    bpm_pts = ""
    if count:
        bt = np.asarray(m.times)[:count] * sample_rate
        bv = np.asarray(m.smoothed)[:count]
        ok = ~np.isnan(bv)
        bpm_pts = " ".join(f"{sx(t):.1f},{sy_bpm(b):.1f}" for t, b in zip(bt[ok], bv[ok]))

    title = f"Heartbeat Analysis - {os.path.basename(file_name)}"
    mm = result.metrics

    # Slope segments + min/max markers + summary box — same figure features
    # as the plotly backend (reference bpm_analysis.py:695-780).
    seg_colors = {"Exertion": "purple", "Recovery": "#2ca02c",
                  "Peak Recovery Slope": "#ff69b4",
                  "Peak Exertion Slope": "#9d32a8"}
    seg_svg = []
    for seg in slope_segments(mm):
        (x0, x1), (y0, y1) = seg["x"], seg["y"]
        hover = (f"{seg['kind']}: {seg['slope']:.2f} BPM/sec over "
                 f"{seg['duration']:.1f}s")
        seg_svg.append(
            f'<line class="slope-{seg["kind"].replace(" ", "-")}" '
            f'x1="{sx(x0 * sample_rate):.1f}" y1="{sy_bpm(y0):.1f}" '
            f'x2="{sx(x1 * sample_rate):.1f}" y2="{sy_bpm(y1):.1f}" '
            f'stroke="{seg_colors[seg["kind"]]}" stroke-width="3" '
            f'stroke-dasharray="6 4"><title>{html.escape(hover)}</title></line>')
    ext = bpm_extrema(mm)
    annot_svg = []
    if ext is not None:
        max_bpm, max_t, min_bpm, min_t = ext
        annot_svg.append(
            f'<text x="{sx(max_t * sample_rate):.1f}" y="{sy_bpm(max_bpm) - 6:.1f}"'
            f' fill="#e36f6f" font-size="12">Max: {max_bpm:.1f} BPM</text>')
        annot_svg.append(
            f'<text x="{sx(min_t * sample_rate):.1f}" y="{sy_bpm(min_bpm) + 14:.1f}"'
            f' fill="#a3d194" font-size="12">Min: {min_bpm:.1f} BPM</text>')
    summary = summary_box_text(mm, html_breaks=True) \
        .replace("<b>", "<strong>").replace("</b>", "</strong>")
    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>body{{background:#111;color:#eee;font-family:sans-serif}}
#summary-box{{border:1px solid #888;background:rgba(255,253,231,0.1);
display:inline-block;padding:8px;font-size:13px}}</style></head>
<body><h2>{html.escape(title)}</h2>
<div id="summary-box">{summary}</div>
<svg width="{W}" height="{H}" style="background:#1a1a2e">
<polyline points="{env_pts}" fill="none" stroke="#47a5c4" stroke-width="1"/>
<polyline points="{floor_pts}" fill="none" stroke="green" stroke-width="1" stroke-dasharray="4 3"/>
{''.join(marker_svg)}
<polyline points="{bpm_pts}" fill="none" stroke="#cccccc" stroke-width="2"/>
{''.join(seg_svg)}
{''.join(annot_svg)}
</svg>
<p style="color:#888">Static fallback rendering (plotly not installed): envelope (blue),
noise floor (green), S1/S2/noise markers (red/orange/grey, hover for the decision trace),
smoothed BPM (white, 50-200 scale), exertion/recovery slope segments, min/max annotations.</p>
</body></html>"""
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)
