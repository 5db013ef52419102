"""Fleet traffic at 302 Hz: the recordings of a pool whose upstream answers
the reference holds (``reference/answers/<pool>.npz``), int16-quantized and
handed over as float32 rows.  Each of ``batches`` batches is a permutation
of the pool drawn from the seed, repeated to ``batch`` rows, so every seed
sends the same recordings in another order."""
import numpy as np

from ..reference import upstream
from . import synth


def make(params: dict, seed: int, workdir: str) -> dict:
    """{"rate", "minutes", "ids": [[id, ...] per batch], "batches": [(batch, n)
    float32, ...]}."""
    pool = upstream.pool(params["pool"])
    minutes = pool.minutes
    rows = {rid: synth.quantize_int16(synth.synth_recording(rid, minutes)).astype(np.float32)
            for rid in pool.ids}
    rng = np.random.default_rng([seed, 0])
    ids, batches = [], []
    for _ in range(params["batches"]):
        reps = -(-params["batch"] // len(pool.ids))
        order = np.concatenate([rng.permutation(pool.ids) for _ in range(reps)])
        ids.append([int(i) for i in order[:params["batch"]]])
        batches.append(np.stack([rows[i] for i in ids[-1]]))
    return {"rate": synth.SR, "minutes": minutes, "ids": ids, "batches": batches}
