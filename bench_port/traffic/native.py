"""Native-rate recordings as files: ``files`` mono int16 WAVs drawn from the
seed among the recordings of a pool whose upstream answers the reference
holds, written by worker processes into ``workdir`` (the output directory
of the run, so the analyzer finds each input where it would copy it)."""
import multiprocessing
import os
import struct

import numpy as np

from ..reference import upstream
from . import synth


def write_wav_i16(path: str, rate: int, data: np.ndarray) -> None:
    """A mono PCM16 WAV, flushed to disk before it returns, so that no
    write-back of the inputs runs inside the measured window."""
    payload = np.ascontiguousarray(data, dtype="<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, rate, 2 * rate, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def _one(args):
    rid, minutes, rate, path = args
    write_wav_i16(path, rate, synth.quantize_int16(
        synth.synth_recording_native(rid, minutes, rate)))
    return path


def make(params: dict, seed: int, workdir: str, workers: int = 0) -> dict:
    """{"rate", "minutes", "ids": [id, ...], "paths": [wav, ...]}."""
    pool = upstream.pool(params["pool"])
    minutes = pool.minutes
    rng = np.random.default_rng([seed, 0])
    ids = [int(i) for i in rng.choice(pool.ids, size=params["files"], replace=False)]
    os.makedirs(workdir, exist_ok=True)
    jobs = [(rid, minutes, pool.rate, os.path.join(workdir, f"rec_{k:03d}_{rid}.wav"))
            for k, rid in enumerate(ids)]
    workers = workers or min(8, os.cpu_count() or 1, len(ids))
    with multiprocessing.get_context("spawn").Pool(workers) as pool_:
        paths = pool_.map(_one, jobs, chunksize=1)
        pool_.close()
        pool_.join()
    return {"rate": pool.rate, "minutes": minutes, "ids": ids, "paths": paths}
