#!/usr/bin/env python3
"""Time the classifier-scan, rhythm-scan and block-filter kernels at
chip_smoke.py's phase-4 inputs on the card, with each launch's device time,
beside an empty launch.

    python3 tools/torch_kernel_time.py [--root CHECKOUT] [--reps 20]

Drives phase 4's batch (16 ten-minute synthetic recordings at the engine
configuration) through the main path once, captures the arguments of both
``classifier.classify_scan`` calls (the preliminary pass without the trace,
the main pass with it), of the ``corrections.rhythm_scan`` call and of both
``ops/filter.lfilter`` calls (the filtfilt's passes), each of which makes
the CPU-or-card choice and on the card calls its kernel's wrapper, holds
each kernel against its plain version (max abs error), and times each call
three ways: CUDA events around ``--reps``
calls issued back to back after a warm-up (``ms``: the host's issue time
where it is the longer), the same calls queued behind a spin kernel
(``queued_ms``, ``chip_smoke.device_ms``: the card's time alone), and
under ``torch.profiler`` (device microseconds per launch of each CUDA
kernel, so the filter's three phases appear apart).  The empty launch is
``torch.cuda._sleep(0)``, timed the same three ways.  The package is
imported from ``--root`` (default: this checkout) and the driving and
timing code is this checkout's chip_smoke.py, so two trees can be timed by
the same code on one card in one call, in turns.  Prints one JSON line with
the card's name and power limit.  Exits non-zero without a CUDA device.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_kernel_time: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.models import classifier, corrections
    from bpm_analysis_tpu_torch.ops import filter as filt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = cs.engine_config()
    batch = np.stack([synth._quantize_int16(synth.synth_recording(s))
                      for s in cs.SEEDS]).astype(np.float32)
    cs.run_main_path(batch, cfg, "cuda")
    c_calls, r_calls, f_calls = [], [], []
    cs.counted_run(batch, cfg, {(classifier, "classify_scan"): c_calls,
                                (corrections, "rhythm_scan"): r_calls,
                                (filt, "lfilter"): f_calls})
    out = {"card": card, "root": root, "kernels": {}}
    calls = [(f"classify_scan {label}", classifier.classify_scan,
              lambda a, k: classifier.scan_plain(a[0], *a[2:], **k), cs.trace_error, a, k)
             for label, (a, k) in zip(("preliminary", "main"), c_calls)]
    calls += [("rhythm_scan", corrections.rhythm_scan,
               lambda a, k: corrections.rhythm_scan_plain(*a[:4], a[5]), cs.rhythm_error,
               *r_calls[-1])]
    calls += [(f"block_filter {label}", filt.lfilter,
               lambda a, k: filt.lfilter_plain(*a, **k),
               lambda g, e: float((g - e).abs().max()), a, k)
              for label, (a, k) in zip(("forward", "backward"), f_calls)]
    calls += [("empty launch", lambda: torch.cuda._sleep(0), None, None, (), {})]
    for name, fn, plain, error, a, k in calls:
        err = None if plain is None else error(fn(*a, **k), plain(a, k))
        ms = cs.cuda_ms(lambda: fn(*a, **k), args.reps)
        queued_ms = cs.device_ms(lambda: fn(*a, **k), args.reps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(*a, **k)
            torch.cuda.synchronize()
        launches = {}
        for e in prof.key_averages():
            device_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            kernel = re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::", "", e.key))[0]
            if device_us > 0 and e.count and kernel.endswith("_kernel"):
                launches[kernel] = device_us / e.count
        out["kernels"][name] = {"max_abs_err": err, "ms": ms, "queued_ms": queued_ms,
                                "device_us_per_launch": launches}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
