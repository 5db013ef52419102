#!/usr/bin/env python3
"""Time ``envelope.preprocess`` on chip_smoke.py's phase-4 batch on the card.

    python3 tools/torch_preprocess_time.py [--root CHECKOUT] [--reps 5]

The batch is 16 ten-minute synthetic recordings (302 Hz, 181,200 samples,
int16-quantized, float32), as in chip_smoke.py phase 4.  The package is
imported from ``--root`` (default: this checkout), so two trees can be timed
on one card in one call, in turns.  Prints one JSON line: the card, the
root, each repetition's CUDA-synchronised wall seconds after one warm-up
call, and the best.  Exits non-zero without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_preprocess_time: no CUDA device", file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import envelope

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    batch = np.stack([synth._quantize_int16(synth.synth_recording(s))
                      for s in range(16)]).astype(np.float32)
    cfg = AnalyzerConfig()
    envelope.preprocess(batch, 302, cfg, device="cuda")
    torch.cuda.synchronize()
    seconds = []
    for i in range(args.reps):
        fresh = batch + np.float32(i + 1) * 1e-3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        envelope.preprocess(fresh, 302, cfg, device="cuda")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"card": card, "root": root, "seconds": seconds,
                      "best": min(seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
