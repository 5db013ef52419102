#!/usr/bin/env python3
"""The benchmark of the port ``bpm_analysis_tpu_torch``: one run of one cell.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card.  The last
line of standard output is the result as JSON; the numbers compared with
the reference, each beside its limit, are the last lines of standard
error.  Exits 2 without a card (or with fewer than the cell asks for), 3
if JAX, Flax or the JAX package was loaded, 1 on any other fault; no
result is printed then."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port import core

    chips = core.cell_spec(args.workload).cell["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {core.nvidia_smi('name,power.limit,clocks.max.sm')}", file=sys.stderr,
          flush=True)
    result = core.run_cell(args.workload, args.seed % (1 << 64), args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"bench_port: modules loaded that the port may not use: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
