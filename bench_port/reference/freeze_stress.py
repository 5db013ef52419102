#!/usr/bin/env python3
"""Freeze the upstream analyzer's answers for the out-of-family stress
recordings into ``answers/stress-302hz.npz``.

    python3 bench_port/reference/freeze_stress.py

The source is the repository's CPU oracle ``bench_cpu_stress.json``: the
upstream engine (``pixeru/bpm_analysis``, stages 1-6 at its default
parameters, numpy/pandas/scipy on the CPU) over the int16 rows of
``synth_stress_recording`` for ids 0-127, at 302 Hz.  The arrays are
``freeze.pool_arrays``'."""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from bench_port.reference.freeze import pool_arrays  # noqa: E402

POOL = "stress-302hz"
META = {"oracle": "bench_cpu_stress.json", "generator": "synth_stress_recording",
        "rate": 302, "post_rate": 302, "minutes": 10}


def main() -> int:
    with open(os.path.join(ROOT, META["oracle"])) as f:
        per_seed = json.load(f)["per_seed"]
    np.savez_compressed(os.path.join(HERE, "answers", f"{POOL}.npz"),
                        **pool_arrays(META, per_seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
