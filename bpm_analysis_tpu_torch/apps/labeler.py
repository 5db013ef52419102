"""Ground-truth labeling tool (reference L9: heartbeat_labeler.py, a Dash
app; here a dependency-free reimplementation on ``http.server`` + a
self-contained HTML/canvas client).

The port's own copy of ``bpm_analysis_tpu/apps/labeler.py``: stdlib and
numpy only, over the artifacts the port's renderers write.

Feature parity with the reference labeler:

* works over ``processed_files/`` artifacts: recomputes the envelope from
  ``*_filtered_debug.wav`` with the same abs + centered-rolling-mean formula
  (heartbeat_labeler.py:62-67) and overlays the BPM curve from
  ``*_bpm_plot.csv``,
* click-to-label S1/S2 at the clicked time with the BPM of the nearest curve
  point; ``z``/``x`` hotkeys switch the active label type; ``Ctrl+Z`` is a
  20-deep undo (assets/keyboard_shortcuts.js semantics),
* persists ``<base>_labels.csv`` in the reference's two-section format
  ("# Peak Labels" + "# S1-S2 Intervals", heartbeat_labeler.py:165-193) with
  the same greedy S1→next-S2 interval pairing (:198-217),
* time-range average tool: average S1-S2 interval / BPM over the pairs whose
  S1 lies in a user-chosen [start, end] range (:219-243, :697-723),
* label-group statistics: S1 peaks split into groups at >=5 s gaps with
  per-group average S1-S2 interval / BPM via the same range tool (:244-308).

Run: ``python -m bpm_analysis_tpu_torch.apps.labeler [--port 8050] [--dir processed_files]``
"""
from __future__ import annotations

import argparse
import csv
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

PROCESSED_DIR = "processed_files"


def list_files(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(
        f[: -len("_filtered_debug.wav")]
        for f in os.listdir(directory)
        if f.endswith("_filtered_debug.wav")
    )


def load_envelope(directory: str, base: str):
    from ..io import wav as wavio

    sr, data = wavio.read(os.path.join(directory, f"{base}_filtered_debug.wav"))
    data = np.abs(data.astype(np.float64))
    window = sr // 10
    # Same centered rolling mean as the engine (host-side numpy variant).
    csum = np.concatenate([[0.0], np.cumsum(data)])
    n = len(data)
    idx = np.arange(n)
    left, right = window // 2, (window - 1) // 2
    lo = np.maximum(idx - left, 0)
    hi = np.minimum(idx + right + 1, n)
    env = (csum[hi] - csum[lo]) / (hi - lo)
    return sr, env


def load_bpm_csv(directory: str, base: str):
    path = os.path.join(directory, f"{base}_bpm_plot.csv")
    if not os.path.exists(path):
        return [], []
    t, b = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            t.append(float(row["Time (s)"]))
            b.append(float(row["Average BPM"]))
    return t, b


def load_labels(directory: str, base: str):
    path = os.path.join(directory, f"{base}_labels.csv")
    labels = []
    if not os.path.exists(path):
        return labels
    with open(path) as f:
        in_labels = False
        for line in f:
            line = line.strip()
            if line.startswith("# Peak Labels"):
                in_labels = True
                continue
            if line.startswith("#"):
                in_labels = False
                continue
            if not in_labels or not line or line.startswith("Time"):
                continue
            parts = line.split(",")
            if len(parts) >= 3:
                labels.append({"time": float(parts[0]), "bpm": float(parts[1]),
                               "type": parts[2]})
    return labels


def s1_s2_pairs(labels):
    """Greedy S1 → next-later-S2 pairing (heartbeat_labeler.py:198-217)."""
    ordered = sorted(labels, key=lambda l: l["time"])
    s1 = [(l["time"], l["bpm"]) for l in ordered if l["type"] == "S1"]
    s2 = [l["time"] for l in ordered if l["type"] == "S2"]
    pairs, i, j = [], 0, 0
    while i < len(s1) and j < len(s2):
        if s2[j] > s1[i][0]:
            pairs.append((s1[i][0], s2[j], s2[j] - s1[i][0], s1[i][1]))
            i += 1
            j += 1
        else:
            j += 1
    return pairs


def avg_delta_t_in_range(labels, start_time, end_time):
    """Average S1-S2 interval / BPM over pairs whose S1 falls inside
    [start_time, end_time] — the reference's interactive time-range tool
    (heartbeat_labeler.py:219-243).  Returns (avg_delta_t, avg_bpm, pairs);
    (None, None, []) when the range holds no pairs."""
    if start_time is None or end_time is None:
        return None, None, []
    pairs = [p for p in s1_s2_pairs(labels)
             if start_time <= p[0] <= end_time]
    if not pairs:
        return None, None, []
    avg_dt = sum(p[2] for p in pairs) / len(pairs)
    avg_bpm = sum(p[3] for p in pairs) / len(pairs)
    return avg_dt, avg_bpm, pairs


def group_stats(labels, gap_threshold=5.0):
    """Gap-based label groups (heartbeat_labeler.py:244-308): consecutive S1
    peaks closer than ``gap_threshold`` seconds form a group; per group the
    stats come from :func:`avg_delta_t_in_range` over [first S1, last S1].
    Groups with fewer than 2 S1 peaks are skipped, like the reference."""
    s1_times = sorted(l["time"] for l in labels if l["type"] == "S1")
    if len(s1_times) < 2:
        return []
    groups, current = [], [s1_times[0]]
    for t in s1_times[1:]:
        if t - current[-1] < gap_threshold:
            current.append(t)
        else:
            groups.append(current)
            current = [t]
    groups.append(current)
    out = []
    for i, g in enumerate(groups):
        if len(g) < 2:
            continue
        avg_dt, avg_bpm, pairs = avg_delta_t_in_range(labels, g[0], g[-1])
        if avg_dt is None:
            continue
        out.append({
            "group_id": i + 1, "start": g[0], "end": g[-1],
            "duration": g[-1] - g[0], "s1_count": len(g),
            "n_pairs": len(pairs),
            "avg_delta_t": avg_dt, "avg_bpm": avg_bpm,
        })
    return out


def save_labels(directory: str, base: str, labels):
    path = os.path.join(directory, f"{base}_labels.csv")
    ordered = sorted(labels, key=lambda l: l["time"])
    pairs = s1_s2_pairs(ordered)
    buf = io.StringIO()
    buf.write("# Peak Labels\n")
    buf.write("Time (s),Average BPM,Peak Type\n")
    for l in ordered:
        buf.write(f"{round(l['time'], 3)},{round(l['bpm'], 3)},{l['type']}\n")
    if pairs:
        buf.write("\n# S1-S2 Intervals\n")
        buf.write("S1_Time,S2_Time,Delta_t,S1_BPM\n")
        for s1t, s2t, dt, bpm in pairs:
            buf.write(f"{round(s1t, 3)},{round(s2t, 3)},{round(dt, 3)},{round(bpm, 3)}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return path


PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Heartbeat Labeler (PyTorch build)</title>
<style>
body{background:#14141e;color:#ddd;font-family:sans-serif;margin:16px}
#bar{margin-bottom:8px} select,button{background:#222;color:#ddd;border:1px solid #555;padding:4px 8px}
#mode{font-weight:bold;color:#e36f6f} canvas{background:#1a1a2e;display:block;border:1px solid #333}
#stats{font-size:13px;color:#9ad}
</style></head><body>
<div id="bar">
<select id="file"></select>
<button onclick="save()">Save (writes _labels.csv)</button>
<button onclick="clearLabels()">Clear</button>
<span>mode: <span id="mode">S1</span> (z = S1, x = S2, Ctrl+Z = undo, click = label)</span>
</div>
<div id="bar">
Range: <input id="t0" type="number" step="0.001" style="width:90px" placeholder="start s">
&rarr; <input id="t1" type="number" step="0.001" style="width:90px" placeholder="end s">
<button onclick="rangeAvg()">Average S1-S2 interval in range</button>
<span id="range-out"></span>
</div>
<canvas id="c" width="1400" height="520"></canvas>
<div id="stats"></div>
<script>
let data=null, labels=[], undoStack=[], mode='S1';
const cv=document.getElementById('c'), ctx=cv.getContext('2d');
async function loadList(){
  const files=await (await fetch('api/files')).json();
  const sel=document.getElementById('file');
  sel.innerHTML=files.map(f=>`<option>${f}</option>`).join('');
  sel.onchange=loadFile; if(files.length) loadFile();
}
async function loadFile(){
  const f=document.getElementById('file').value;
  data=await (await fetch('api/data?file='+encodeURIComponent(f))).json();
  labels=data.labels; undoStack=[]; draw();
}
function x2t(px){return px/cv.width*data.duration}
function t2x(t){return t/data.duration*cv.width}
function draw(){
  if(!data) return;
  ctx.clearRect(0,0,cv.width,cv.height);
  ctx.strokeStyle='#47a5c4'; ctx.beginPath();
  const emax=data.env_max*2;
  data.env.forEach((v,i)=>{const x=i/(data.env.length-1)*cv.width,
    y=cv.height-Math.min(v/emax,1)*cv.height; i?ctx.lineTo(x,y):ctx.moveTo(x,y);});
  ctx.stroke();
  ctx.strokeStyle='#ccc'; ctx.beginPath();
  data.bpm_t.forEach((t,i)=>{const x=t2x(t),
    y=cv.height-((Math.min(Math.max(data.bpm_v[i],50),200)-50)/150)*cv.height;
    i?ctx.lineTo(x,y):ctx.moveTo(x,y);});
  ctx.stroke();
  labels.forEach(l=>{ctx.fillStyle=l.type=='S1'?'#e36f6f':'orange';
    const x=t2x(l.time); ctx.fillRect(x-1,0,2,cv.height);
    ctx.fillText(l.type,x+2,12);});
  document.getElementById('stats').innerText=
    `${labels.length} labels — groups: `+JSON.stringify(data.groups||[]);
}
cv.onclick=e=>{
  if(!data) return;
  const t=x2t(e.offsetX);
  let bpm=0, best=1e9;
  data.bpm_t.forEach((bt,i)=>{const d=Math.abs(bt-t); if(d<best){best=d;bpm=data.bpm_v[i];}});
  undoStack.push(JSON.stringify(labels)); if(undoStack.length>20) undoStack.shift();
  labels.push({time:t,bpm:bpm,type:mode}); draw();
};
document.onkeydown=e=>{
  if(e.target.tagName=='INPUT'||e.target.tagName=='TEXTAREA') return;
  if(e.key=='z'&&!e.ctrlKey){mode='S1';}
  else if(e.key=='x'){mode='S2';}
  else if(e.key=='z'&&e.ctrlKey){if(undoStack.length){labels=JSON.parse(undoStack.pop());draw();} e.preventDefault();}
  document.getElementById('mode').innerText=mode;
};
async function save(){
  const f=document.getElementById('file').value;
  const r=await fetch('api/save',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({file:f,labels:labels})});
  const out=await r.json(); data.groups=out.groups; draw();
}
function clearLabels(){undoStack.push(JSON.stringify(labels)); labels=[]; draw();}
async function rangeAvg(){
  const t0=parseFloat(document.getElementById('t0').value),
        t1=parseFloat(document.getElementById('t1').value);
  if(isNaN(t0)||isNaN(t1)) return;
  const r=await fetch('api/range_avg',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({labels:labels,start:t0,end:t1})});
  const out=await r.json();
  document.getElementById('range-out').innerText = out.avg_delta_t==null
    ? ` no S1-S2 pairs in ${t0}s..${t1}s`
    : ` avg S1-S2 interval ${out.avg_delta_t.toFixed(3)}s, avg BPM ${out.avg_bpm.toFixed(1)} (${out.n_pairs} pairs)`;
}
loadList();
</script></body></html>"""


class Handler(BaseHTTPRequestHandler):
    directory = PROCESSED_DIR

    def log_message(self, *a):  # quiet
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif url.path == "/api/files":
            self._json(list_files(self.directory))
        elif url.path == "/api/data":
            base = parse_qs(url.query).get("file", [""])[0]
            try:
                sr, env = load_envelope(self.directory, base)
            except OSError:
                self._json({"error": "not found"}, 404)
                return
            step = max(1, len(env) // 4000)
            env_ds = env[::step]
            bpm_t, bpm_v = load_bpm_csv(self.directory, base)
            labels = load_labels(self.directory, base)
            self._json({
                "sr": sr, "duration": len(env) / sr,
                "env": np.round(env_ds, 2).tolist(),
                "env_max": float(np.quantile(env, 0.99)),
                "bpm_t": bpm_t, "bpm_v": bpm_v,
                "labels": labels, "groups": group_stats(labels),
            })
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        url = urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0))
        payload = json.loads(self.rfile.read(length) or b"{}")
        if url.path == "/api/save":
            base = payload.get("file", "")
            labels = payload.get("labels", [])
            path = save_labels(self.directory, base, labels)
            self._json({"saved": path, "groups": group_stats(labels)})
        elif url.path == "/api/range_avg":
            avg_dt, avg_bpm, pairs = avg_delta_t_in_range(
                payload.get("labels", []), payload.get("start"),
                payload.get("end"))
            self._json({"avg_delta_t": avg_dt, "avg_bpm": avg_bpm,
                        "n_pairs": len(pairs), "pairs": pairs})
        else:
            self._json({"error": "not found"}, 404)


def main(argv=None):
    p = argparse.ArgumentParser(description="Heartbeat ground-truth labeler")
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--dir", default=PROCESSED_DIR)
    args = p.parse_args(argv)
    Handler.directory = args.dir
    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"Labeler serving http://127.0.0.1:{args.port}/ over {args.dir}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
