"""Single uploads: each call is one request, ``host.analyze_any_file`` on
one WAV of the run's pool (in turn) with every artifact written, into the
directory that holds it (so the input is not copied)."""
import os
import sys
import time
from types import SimpleNamespace

from ..reference import compare


def setup(ctx):
    from bpm_analysis_tpu_torch import host

    paths = ctx.inputs["paths"]
    return SimpleNamespace(ctx=ctx, host=host, cfg=ctx.program_config, paths=paths,
                           ids=dict(zip(paths, ctx.inputs["ids"])),
                           minutes=ctx.inputs["minutes"], outdir=os.path.dirname(paths[0]))


def csv_path(outdir: str, path: str) -> str:
    base = os.path.splitext(os.path.basename(path))[0]
    return os.path.join(outdir, f"{base}_bpm_plot.csv")


def call(s, i: int) -> dict:
    path = s.paths[i % len(s.paths)]
    t0 = time.perf_counter()
    try:
        res = s.host.analyze_any_file(path, s.cfg, output_directory=s.outdir,
                                      device=s.ctx.device)
    except Exception as e:  # a failed request is counted, and the run goes on
        print(f"request {i} ({os.path.basename(path)}) failed: {e!r}", file=sys.stderr, flush=True)
        res = None
    t1 = time.perf_counter()
    ok = res is not None
    return {"t0": t0, "t1": t1, "attempted": 1, "failed": 0 if ok else 1,
            "audio_min": s.minutes if ok else 0.0, "path": path, "result": res}


def answers(s, rec) -> list:
    res = rec["result"]
    return [(s.ids[rec["path"]], compare.answer_of(res) if res is not None else None)]


def csvs(s) -> list:
    """The BPM CSV of each file of the pool, as its last request left it."""
    out = []
    for p in s.paths:
        c = csv_path(s.outdir, p)
        out.append((s.ids[p], compare.read_csv(c) if os.path.exists(c) else None))
    return out


def shapes(s) -> dict:
    return {"files": 1}
