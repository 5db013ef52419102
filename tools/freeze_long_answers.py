#!/usr/bin/env python3
"""Freeze the answers of the two-hour pool into
``bench_port/reference/answers/synth-302hz-2h.npz``.

    JAX_PLATFORMS=cpu python3 tools/freeze_long_answers.py [--ids 0-31] [--jobs 4] [--out PATH]

The upstream analyzer (``pixeru/bpm_analysis``) is not in this repository,
so the answers come from the JAX package on the CPU, on the path whose
answers ``exact-f64-b256`` holds to the upstream's with no beat moved:
``envelope.preprocess`` → ``pipeline.analyze_batch`` in float64 at
``noise_quantile_stride`` 1 (the upstream's own floor, a rolling quantile
at every sample).  The recordings are ``synth_recording(id, 120)`` of
``bench_port/traffic/synth.py``, int16-quantized as the benchmark sends
them; the capacities are those of ``bench_port/configs/engine-2h-302hz.json``
and a row that overflows one, or yields fewer than two beats, stops the
tool.  The arrays are ``bench_port/reference/freeze.pool_arrays``', with
``oracle`` naming this tool.  An id takes ~12 s after a process's first
(~45 s with the compile) and ~3 GB; ``--jobs`` runs ids in that many
processes (4: ~5 minutes for the 32)."""
import argparse
import functools
import json
import multiprocessing
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port.reference.freeze import pool_arrays  # noqa: E402
from bench_port.traffic import synth  # noqa: E402

POOL = "synth-302hz-2h"
CONFIG = os.path.join(ROOT, "bench_port", "configs", "engine-2h-302hz.json")
META = {"oracle": "tools/freeze_long_answers.py", "generator": "synth_recording",
        "rate": 302, "post_rate": 302, "minutes": 120}
IDS = range(32)


def runtime() -> dict:
    """The configuration's runtime in float64 at stride 1."""
    with open(CONFIG) as f:
        rt = json.load(f)["runtime"]
    return {**rt, "dtype": "float64", "noise_quantile_stride": 1}


def row(rid: int) -> np.ndarray:
    """Recording ``rid`` as the benchmark sends it: int16 values."""
    return synth.quantize_int16(synth.synth_recording(rid, META["minutes"]))


@functools.lru_cache(maxsize=None)
def _analyze():
    """The jitted preprocess → analyze_batch of one float64 row (built once
    a process)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from bpm_analysis_tpu.config import AnalyzerConfig, RuntimeConfig
    from bpm_analysis_tpu.models import envelope, pipeline

    cfg = AnalyzerConfig(runtime=RuntimeConfig(**runtime()))
    sr = META["rate"]
    return jax.jit(lambda xs: pipeline.analyze_batch(
        jax.vmap(lambda x: envelope.preprocess(x, sr, cfg)[0])(xs), sr, cfg))


def answer(rid: int) -> dict:
    """Recording ``rid``'s answer in the oracle form ``pool_arrays`` reads
    (``beat_times``, ``bpm_times``, ``bpm_values``), with its counts."""
    import jax

    t0 = time.perf_counter()
    res = jax.tree_util.tree_map(np.asarray, _analyze()(row(rid)[None].astype(np.float64)))
    if bool(res.overflowed[0]) or not bool(res.ok[0]):
        raise RuntimeError(f"id {rid}: overflowed {bool(res.overflowed[0])}, "
                           f"ok {bool(res.ok[0])}")
    count, k = int(res.final_count[0]), int(res.metrics.bpm.count[0])
    return {"beat_times": (res.final_positions[0, :count].astype(np.int64)
                           / META["post_rate"]).tolist(),
            "bpm_times": res.metrics.bpm.times[0, :k].tolist(),
            "bpm_values": res.metrics.bpm.smoothed[0, :k].tolist(),
            "counts": {"troughs": int(res.trough_count[0]),
                       "raw_peaks": int(res.raw_peak_count[0]),
                       "s1": int(res.s1_count[0]), "final": count},
            "seconds": time.perf_counter() - t0}


def _job(rid: int):
    return rid, answer(rid)


def parse_ids(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ids", default=f"{IDS[0]}-{IDS[-1]}")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "bench_port", "reference", "answers",
                                                   f"{POOL}.npz"))
    args = ap.parse_args(argv)
    ids = parse_ids(args.ids)
    per_seed = {}
    with multiprocessing.get_context("spawn").Pool(max(1, args.jobs)) as workers:
        for rid, ans in workers.imap_unordered(_job, ids):
            per_seed[str(rid)] = ans
            print(f"id {rid}: {ans['counts']} in {ans['seconds']:.1f} s", flush=True)
    np.savez_compressed(args.out, oracle=META["oracle"], **pool_arrays(META, per_seed))
    print(f"wrote {args.out}: ids {sorted(ids)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
