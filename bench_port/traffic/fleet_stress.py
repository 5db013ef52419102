"""Fleet traffic from outside the exertion family at 302 Hz: ``fleet.make``'s
contract (each of ``batches`` batches a permutation of the pool drawn from
the seed, repeated to ``batch`` rows, int16-quantized float32 rows) over the
recordings of ``synth_stress.synth_stress_recording``."""
import numpy as np

from ..reference import upstream
from . import synth, synth_stress


def make(params: dict, seed: int, workdir: str) -> dict:
    """{"rate", "minutes", "ids": [[id, ...] per batch], "batches": [(batch, n)
    float32, ...]}."""
    pool = upstream.pool(params["pool"])
    minutes = pool.minutes
    rows = {rid: synth.quantize_int16(
        synth_stress.synth_stress_recording(rid, minutes)).astype(np.float32) for rid in pool.ids}
    rng = np.random.default_rng([seed, 0])
    ids, batches = [], []
    for _ in range(params["batches"]):
        reps = -(-params["batch"] // len(pool.ids))
        order = np.concatenate([rng.permutation(pool.ids) for _ in range(reps)])
        ids.append([int(i) for i in order[:params["batch"]]])
        batches.append(np.stack([rows[i] for i in ids[-1]]))
    return {"rate": synth.SR, "minutes": minutes, "ids": ids, "batches": batches}
