"""Run ``chip_smoke.py``'s phase 9 (the host path) alone on a CUDA card.

    python3 tools/torch_host_phase.py

From the repository root.  Builds the kernels, runs phase 4's batch of 16
recordings through the in-memory main path once (phase 9 compares the
host's positions with it), then phase 9: about two minutes instead of the
whole script's six, for iterating on the host path.  Exits non-zero on a
failed gate, as the script does.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_host_phase: no CUDA device", file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import synth

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cs.log(f"build: {cs.build_all()}")
    cfg = cs.engine_config()
    batch_i16 = np.stack([synth._quantize_int16(synth.synth_recording(s)) for s in cs.SEEDS])
    res = cs.run_main_path(batch_i16.astype(np.float32), cfg, "cuda")
    torch.cuda.synchronize()
    cs.log("phase 4's batch through the in-memory main path")
    with open(os.path.join(cs.REPO, "bench_cpu_baseline.json")) as f:
        oracle = json.load(f)["per_seed"]
    with tempfile.TemporaryDirectory(prefix="torch_host_phase_") as tmp:
        cs.check_host_path(card, cfg, batch_i16, res, oracle, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
