"""Run ``chip_smoke.py``'s phase 10 (scale-out) alone on a CUDA card.

    python3 tools/torch_scale_phase.py

From the repository root.  Builds the kernels, runs phase 4's batch of 16
recordings through the in-memory main path (a cold and a warm run: phase
10 compares the dp ranks with both) and once on the strided-kernel path
(for the profiler's B2 call), writes recordings 0 and 1 as WAVs through the
unsharded batched host (the artifacts the dp host is held against), then
phase 10: a few minutes instead of the whole script's, for iterating on the
scale-out layer.  Exits non-zero on a failed gate, as the script does.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scale_phase: no CUDA device", file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import host_batch, synth
    from bpm_analysis_tpu_torch.io import wav
    from bpm_analysis_tpu_torch.ops.cuda import knot_kernel, quantile_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cs.log(f"build: {cs.build_all()}")
    cfg = cs.engine_config()
    batch_i16 = np.stack([synth._quantize_int16(synth.synth_recording(s)) for s in cs.SEEDS])
    batch = batch_i16.astype(np.float32)
    cs.run_main_path(batch, cfg, "cuda")
    knot_calls, strided_calls = [], []
    res, _ = cs.counted_run(batch, cfg, {
        (knot_kernel, "knot_quantile_anchors"): knot_calls})
    best = cs.warm_best(batch, cfg, 1)
    cs.log(f"phase 4's batch: warm wall {best:.3f}s on {card}")
    cfg_b2 = cfg.replace(runtime=dataclasses.replace(cfg.runtime, quantile_backend="pallas"))
    cs.counted_run(batch, cfg_b2, {(quantile_kernel, "strided_quantile_anchors"):
                                   strided_calls})
    with open(os.path.join(cs.REPO, "bench_cpu_baseline.json")) as f:
        oracle = json.load(f)["per_seed"]
    with tempfile.TemporaryDirectory(prefix="torch_scale_phase_") as tmp:
        paths = []
        for s in (0, 1):
            paths.append(os.path.join(tmp, "src", f"rec_{s:02d}.wav"))
            os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
            wav.write(paths[-1], cs.SR, batch_i16[s])
        out = os.path.join(tmp, "batched")
        t0 = time.perf_counter()
        results, errors = host_batch.analyze_files_batched(paths, cfg, out,
                                                           max_batch=cs.BATCH)
        cs.log(f"unsharded host on 2 files: {time.perf_counter() - t0:.3f}s; {errors}")
        torch.cuda.empty_cache()
        cs.check_scale_out(card, cfg, batch, res, best, oracle, (paths, results, out),
                           (knot_kernel.knot_quantile_anchors, knot_calls[-1]),
                           (quantile_kernel.strided_quantile_anchors, strided_calls[-1]),
                           tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
