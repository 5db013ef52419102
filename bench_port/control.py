#!/usr/bin/env python3
"""The control of a cell's comparison: a run of the cell with the program's
envelope rounded to bfloat16, the precision below the configurations'
float32 (``core.bfloat16_envelope``), at the cell's own size and through the
same comparison as every run (``core.check``).  Every control run has to
come out not correct.

    python3 bench_port/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line per seed: ``correct`` and the compared numbers beside
their limits."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port import core

    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = core.run_cell(args.workload, seed % (1 << 64), args.seconds, False, device,
                          control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16_envelope",
                          "correct": r["correct"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
