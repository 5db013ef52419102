"""The fleet engine: each call sends one batch of float32 host rows through
``models/envelope.preprocess`` and ``models/pipeline.analyze_batch`` and
ends with the fleet fields on the host (``host.to_host``: final positions
and count, metrics, ``ok`` and the overflow flags)."""
import time
from types import SimpleNamespace

import numpy as np

from ..reference import compare


def setup(ctx):
    from bpm_analysis_tpu_torch import host
    from bpm_analysis_tpu_torch.models import envelope, pipeline

    return SimpleNamespace(ctx=ctx, host=host, envelope=envelope, pipeline=pipeline,
                           cfg=ctx.program_config, batches=ctx.inputs["batches"],
                           ids=ctx.inputs["ids"], rate=ctx.inputs["rate"],
                           minutes=ctx.inputs["minutes"])


def call(s, i: int) -> dict:
    b = i % len(s.batches)
    x = s.batches[b]
    t0 = time.perf_counter()
    env = s.envelope.preprocess(x, s.rate, s.cfg, device=s.ctx.device)[0]
    res = s.pipeline.analyze_batch(env, s.rate, s.cfg, device=s.ctx.device)
    res = s.host.to_host(res._replace(
        floor=None, trace=None, smoothed_deviation=None, classes=None,
        precorrection_classes=None, s1_positions=None, trough_positions=None,
        raw_peak_positions=None))
    t1 = time.perf_counter()
    done = ~np.asarray(res.overflowed, bool) & np.asarray(res.ok, bool)
    return {"t0": t0, "t1": t1, "attempted": len(x), "failed": len(x) - int(done.sum()),
            "audio_min": float(done.sum()) * s.minutes, "batch": b, "result": res,
            "done": done}


def answers(s, rec) -> list:
    """A row the result lacks never came: None, as a row that failed."""
    res, ids, done = rec["result"], s.ids[rec["batch"]], rec["done"]
    return [(rid, compare.answer_of(_row(res, r)) if r < len(done) and done[r] else None)
            for r, rid in enumerate(ids)]


def _row(tree, r: int):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*[_row(x, r) for x in tree])
    return tree[r]


def csvs(s) -> list:
    return []


def shapes(s) -> dict:
    bsz, n = s.batches[0].shape
    return {"batch": bsz, "n": n, "rate": s.rate}
