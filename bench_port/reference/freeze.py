#!/usr/bin/env python3
"""Freeze the upstream analyzer's answers into ``answers/<pool>.npz``.

    python3 bench_port/reference/freeze.py

The sources are the repository's CPU oracles, made once by
``tools/make_fleet_oracles.py``: the upstream engine (``pixeru/bpm_analysis``,
stages 1-6 at its default parameters, numpy/pandas/scipy on the CPU) over
each synthetic recording of an id.  Each pool keeps, per recording id, the
final beats as sample positions at the post rate (the oracle's beat times
times that rate, an exact round trip) and the smoothed BPM series."""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

POOLS = {
    "synth-302hz": {"oracle": "bench_cpu_baseline.json", "generator": "synth_recording",
                    "rate": 302, "post_rate": 302, "minutes": 10},
    "synth-native-44k": {"oracle": "bench_cpu_native.json", "generator": "synth_recording_native",
                         "rate": 44100, "post_rate": 302, "minutes": 10},
}


def pool_arrays(meta: dict, per_seed: dict) -> dict:
    ids = sorted(int(k) for k in per_seed)
    pos, bt, bv = [], [], []
    for i in ids:
        rec = per_seed[str(i)]
        times = np.asarray(rec["beat_times"], np.float64)
        p = np.round(times * meta["post_rate"]).astype(np.int64)
        if not np.array_equal(p / meta["post_rate"], times):
            raise ValueError(f"id {i}: beat times are not samples at {meta['post_rate']} Hz")
        pos.append(p)
        bt.append(np.asarray(rec["bpm_times"], np.float64))
        bv.append(np.asarray(rec["bpm_values"], np.float64))
    offsets = lambda parts: np.cumsum([0] + [len(a) for a in parts])  # noqa: E731
    return {"ids": np.asarray(ids, np.int64), "beat_offsets": offsets(pos),
            "positions": np.concatenate(pos), "bpm_offsets": offsets(bt),
            "bpm_times": np.concatenate(bt), "bpm_values": np.concatenate(bv),
            "rate": meta["rate"], "post_rate": meta["post_rate"], "minutes": meta["minutes"],
            "generator": meta["generator"]}


def main() -> int:
    for name, meta in POOLS.items():
        with open(os.path.join(ROOT, meta["oracle"])) as f:
            per_seed = json.load(f)["per_seed"]
        np.savez_compressed(os.path.join(HERE, "answers", f"{name}.npz"),
                            **pool_arrays(meta, per_seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
