#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the batched engine on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each printed on its own line with
the seconds since start:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels, compiled with ``nvcc`` from ``csrc/``;
3. kernel vs plain version on the card: the knot-quantile kernel against
   ``ops/knot_quantile.rolling_quantile_knots`` on the cases of
   tests/test_knot_kernel.py and on engine-shaped knots;
4. the main path at full width: 16 ten-minute recordings (302 Hz,
   181,200 samples) through ``envelope.preprocess`` → ``pipeline.analyze_batch``
   at float32, stride 64, ``quantile_backend="auto"``; launch counts,
   warm wall time, a per-stage breakdown, and the kernel's time, bound and
   plain-version time on the main path's own inputs;
5. accuracy against the CPU reference's beats and BPM curves
   (``bench_cpu_baseline.json``): worst beat F1 >= 0.99, BPM MAE < 0.5;
6. the card against the port on the CPU, recordings 0 and 1.

The second-to-last line is the kernel table as JSON, the last line the
result.  Any failing phase exits non-zero before the result line; without a
CUDA device the script exits non-zero at once.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
SR = 302
BATCH = 16
SEEDS = list(range(BATCH))
RTOL, ATOL = 3e-6, 1e-3
# H100 SXM data-sheet peaks: float32 outside the tensor cores, and HBM
# bandwidth.  The float32 rate counts a fused multiply-add as two
# operations; the kernel is built without contraction, so each of the
# operations counted below issues alone and the bound is optimistic by up to
# 2x (33.5e12 single operations/s: 132 SMs x 128 lanes x 1.98 GHz).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# Operations the knot quantile needs per window segment, by the branch the
# segment takes (csrc/knot_quantile.cu), with per-segment constants hoisted:
# once per segment: clipped start max, end min, length sub, count add,
#   dv sub, the hoisted constant (1 + p0 - s, or e - p0) 2 = 7;
# each of the 33 count passes (32 descent steps and the count at v_lo), on a
#   sloped segment: v - v0 sub, / dv, * denom, floor or ceil, + constant,
#   clip max, clip min, sign select, accumulate add = 9; on a flat one:
#   compare, select, accumulate add = 3;
# the next-value pass, sloped: v - v0, / dv, * denom, floor or ceil,
#   + constant, clamp to the segment, range compare, i - p0, / denom, * dv,
#   + v0, compare with v_lo, running min = 13; flat: compare, select, min = 3.
# Per anchor, each descent step: probe or, key-to-float select and xor,
# compare, select = 5.
OPS_SEG_ONCE = 7
COUNT_PASSES = 33
OPS_COUNT_SLOPED, OPS_COUNT_FLAT = 9, 3
OPS_NEXT_SLOPED, OPS_NEXT_FLAT = 13, 3
OPS_DESCENT_STEP, DESCENT_STEPS = 5, 32

def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def engine_config():
    """The in-family engine configuration of bench.py:534-538 with
    raw_peaks=2560 (2432 truncates the fleet's worst recording)."""
    from bpm_analysis_tpu_torch.config import AnalyzerConfig, RuntimeConfig

    return AnalyzerConfig(runtime=RuntimeConfig(
        max_raw_peaks=2560, max_troughs=2560, max_candidates=1536,
        dtype="float32", noise_quantile_stride=64, quantile_backend="auto",
        find_peaks_work_factor=4, prominence_work_factor=2.5,
        prominence_residual_capacity=512, raw_candidate_capacity=16384,
        extrema_capacity=22016))


def random_knots(rng, n, cap, min_spacing, count):
    """Sorted positions >= min_spacing apart, padded with n past count (the
    generator of tests/test_knot_kernel.py)."""
    gaps = rng.randint(min_spacing, 3 * min_spacing, size=count)
    pos = np.minimum(np.cumsum(gaps) - gaps[0], n - 1)
    pos = np.unique(pos)[:count]
    count = len(pos)
    full = np.full(cap, n, np.int32)
    full[:count] = pos
    val = np.zeros(cap, np.float32)
    val[:count] = np.abs(rng.randn(count)).astype(np.float32) * 120
    return full, val, count


def kernel_cases():
    """(name, pos, val, count, n, window, stride, min_spacing, n_valid)."""
    cases = []
    for window, stride, ms in ((603, 8, 30), (301, 4, 45)):
        rng = np.random.RandomState(0)
        ps, vs, cs = [], [], []
        for count in (90, 40, 7):
            p, v, c = random_knots(rng, 6000, 128, ms, count)
            ps.append(p)
            vs.append(v)
            cs.append(c)
        cases.append((f"random_w{window}", np.stack(ps), np.stack(vs),
                      np.array(cs, np.int32), 6000, window, stride, ms, None))
    rng = np.random.RandomState(3)
    p, v, c = random_knots(rng, 3490, 64, 40, 55)
    cases.append(("masked_prefix", p[None], v[None], np.array([c], np.int32),
                  5000, 603, 8, 40, np.array([3500], np.int32)))
    cases.append(("no_knots", np.full((1, 32), 4000, np.int32),
                  np.zeros((1, 32), np.float32), np.zeros(1, np.int32),
                  4000, 301, 8, 30, None))
    rng = np.random.RandomState(7)
    gaps = rng.randint(30, 90, size=40)
    pos = np.unique(np.minimum(2 * 603 + np.cumsum(gaps), 5999))[:40]
    full = np.full(64, 6000, np.int32)
    full[:len(pos)] = pos
    val = np.zeros(64, np.float32)
    val[:len(pos)] = np.abs(rng.randn(len(pos))).astype(np.float32) * 120
    cases.append(("first_knot_past_zero", full[None], val[None],
                  np.array([len(pos)], np.int32), 6000, 603, 8, 30, None))
    # Engine shapes: B=16, cap=2560, n=181200, window 3020, spacing 15.
    rng = np.random.RandomState(11)
    n, cap = 181200, 2560
    ps, vs, cs = [], [], []
    for _ in range(BATCH):
        pos = np.cumsum(rng.randint(15, 140, size=2500))
        pos = pos[pos < n][:cap - 100]
        vals = (np.abs(rng.randn(len(pos))) * 30).astype(np.float32)
        vals[::7] = np.round(vals[::7])
        p = np.full(cap, n, np.int32)
        p[:len(pos)] = pos
        v = np.zeros(cap, np.float32)
        v[:len(pos)] = vals
        ps.append(p)
        vs.append(v)
        cs.append(len(pos))
    cases.append(("engine_shapes", np.stack(ps), np.stack(vs),
                  np.array(cs, np.int32), n, 3020, 64, 15, None))
    return cases


def compare(got: torch.Tensor, exp: torch.Tensor):
    """(max abs err, max rel err, ok) under rtol/atol with equal NaN
    positions."""
    g, e = got.cpu().numpy(), exp.cpu().numpy()
    nan_ok = np.array_equal(np.isnan(g), np.isnan(e))
    fin = ~np.isnan(e) & ~np.isnan(g)
    diff = np.abs(g[fin] - e[fin])
    err = float(diff.max()) if diff.size else 0.0
    rel = float((diff / np.maximum(np.abs(e[fin]), 1e-30)).max()) if diff.size else 0.0
    ok = nan_ok and np.allclose(g, e, rtol=RTOL, atol=ATOL, equal_nan=True)
    return err, rel, ok


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def knot_bound(pos, val, count, n, window, q, min_periods, stride, min_spacing,
               n_valid) -> tuple:
    """Least time for the kernel's work on these inputs: bytes moved (each
    input read once, the anchors written once) over HBM bandwidth, and the
    operations that the segments these windows actually meet need (sloped
    and flat segments counted by their own branch) over the float32 peak.
    Returns (ms, 'bytes'|'operations')."""
    from bpm_analysis_tpu_torch.ops.rolling import centered_bounds

    bsz, cap = pos.shape
    n_anchor = -(-n // stride)
    nbytes = pos.numel() * 4 + val.numel() * 4 + 2 * bsz * 4 + bsz * n_anchor * 4
    left, right = centered_bounds(window)
    cnt = count.long()[:, None]
    apos = torch.clamp(torch.arange(n_anchor, device=pos.device) * stride, max=n - 1)
    w_lo = torch.clamp(apos - left, min=0).expand(bsz, -1).contiguous()
    hi = n if n_valid is None else torch.clamp(n_valid.long(), max=n)[:, None]
    w_hi = torch.minimum(apos[None, :] + right + 1,
                         torch.as_tensor(hi, device=pos.device)).expand(bsz, -1).contiguous()
    slot = torch.arange(cap, device=pos.device)[None, :]
    p = torch.where(slot < cnt, pos.long(), n).contiguous()
    # The segments of an anchor's window: knots [base, min(top, count)).
    base = torch.clamp(torch.searchsorted(p, w_lo, right=True) - 1, min=0)
    stop = torch.maximum(torch.minimum(torch.searchsorted(p, w_hi, right=False), cnt), base)
    # Knot k starts a sloped segment when k + 1 < count and its value changes.
    sloped = (slot[:, :-1] + 1 < cnt) & (val[:, 1:] != val[:, :-1])
    csum = torch.zeros((bsz, cap + 1), dtype=torch.long, device=pos.device)
    csum[:, 1:cap] = torch.cumsum(sloped.long(), dim=1)
    csum[:, cap] = csum[:, cap - 1]
    n_seg = (stop - base).sum()
    n_sloped = (torch.gather(csum, 1, stop) - torch.gather(csum, 1, base)).sum()
    n_flat = n_seg - n_sloped
    live_anchors = int((count > 0).sum()) * n_anchor
    ops = (float(n_seg) * OPS_SEG_ONCE
           + float(n_sloped) * (COUNT_PASSES * OPS_COUNT_SLOPED + OPS_NEXT_SLOPED)
           + float(n_flat) * (COUNT_PASSES * OPS_COUNT_FLAT + OPS_NEXT_FLAT)
           + live_anchors * DESCENT_STEPS * OPS_DESCENT_STEP)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

def run_main_path(batch_np, cfg, device):
    from bpm_analysis_tpu_torch.models import envelope as envm, pipeline

    env = envm.preprocess(batch_np, SR, cfg, device=device)[0]
    return pipeline.analyze_batch(env, SR, cfg, device=device)


def stage_breakdown(batch_np, cfg):
    """Seconds per pipeline stage on the card, each stage synchronized
    (a separate run: the synchronizations cost the overlap they remove)."""
    from bpm_analysis_tpu_torch.models import (analytics, classifier, corrections,
                                               envelope as envm, noise_floor, pipeline)
    from bpm_analysis_tpu_torch.ops import find_peaks as fp

    times = {}

    def timed(name_of, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            name = name_of(a, k)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    patches = [
        (fp, "build_extrema", lambda a, k: "build_extrema"),
        (noise_floor, "dynamic_noise_floor", lambda a, k: "noise_floor"),
        (pipeline, "raw_peaks", lambda a, k: "raw_peaks"),
        (classifier, "classify",
         lambda a, k: "classify_preliminary" if k.get("want_trace") is False
         else "classify_main"),
        (corrections, "refine_and_correct", lambda a, k: "corrections"),
        (analytics, "compute_metrics", lambda a, k: "metrics"),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, name_of in patches:
            setattr(mod, attr, timed(name_of, getattr(mod, attr)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env = envm.preprocess(batch_np, SR, cfg, device="cuda")[0]
        torch.cuda.synchronize()
        times["preprocess"] = time.perf_counter() - t0
        pipeline.analyze_batch(env, SR, cfg, device="cuda")
        torch.cuda.synchronize()
        times["total"] = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.accuracy import (F1_FLOOR, MAE_CEIL, beat_f1,
                                                 bpm_mae, result_curves)
    from bpm_analysis_tpu_torch.models import noise_floor
    from bpm_analysis_tpu_torch.ops import knot_quantile as kq
    from bpm_analysis_tpu_torch.ops.cuda import knot_kernel

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"phase 1 device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the filter's float32 products must stay exact")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    knot_kernel._library()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {build_s:.2f}s")

    # ---- 3. kernel vs plain version on the card ----------------------------
    worst_err = 0.0
    for name, pos, val, cnt, n, window, stride, ms, nv in kernel_cases():
        args = [torch.from_numpy(a).to(dev) for a in (pos, val, cnt)]
        nv_t = None if nv is None else torch.from_numpy(nv).to(dev)
        got = knot_kernel.knot_quantile_anchors(
            *args, n, window, 0.2, min_periods=3, stride=stride, min_spacing=ms,
            n_valid=nv_t)
        exp = kq.rolling_quantile_knots(
            *args, n, window, 0.2, min_periods=3, stride=stride, min_spacing=ms,
            n_valid=nv_t, dtype=torch.float32)
        torch.cuda.synchronize()
        err, rel, ok = compare(got, exp)
        worst_err = max(worst_err, err)
        log(f"  knot kernel vs plain [{name}] shape {tuple(got.shape)}: "
            f"max abs err {err:.3g}, max rel err {rel:.3g}")
        check(ok, f"knot kernel disagrees with its plain version on {name}")
    log(f"phase 3 kernel vs plain: ok (rtol {RTOL}, atol {ATOL})")

    # ---- 4. main path at full width ----------------------------------------
    cfg = engine_config()
    t0 = time.perf_counter()
    batch = np.stack([synth._quantize_int16(synth.synth_recording(s)).astype(np.float32)
                      for s in SEEDS])
    log(f"synthesized {batch.shape} in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    res = run_main_path(batch, cfg, "cuda")
    torch.cuda.synchronize()
    log(f"first run (cold): {time.perf_counter() - t0:.2f}s")

    captured = []
    real_anchors = knot_kernel.knot_quantile_anchors

    def capturing(*a, **k):
        captured.append((a, k))
        return real_anchors(*a, **k)

    noise_floor.knot_kernel.knot_quantile_anchors = capturing
    knot_kernel.launches = 0
    try:
        res = run_main_path(batch, cfg, "cuda")
        torch.cuda.synchronize()
    finally:
        noise_floor.knot_kernel.knot_quantile_anchors = real_anchors
    launches = knot_kernel.launches
    log(f"knot kernel launches on the main path: {launches}")
    check(launches == 2, f"expected 2 knot-kernel launches per batch, got {launches}")

    overflowed = res.overflowed.cpu().numpy()
    final_count = res.final_count.cpu().numpy()
    log(f"final beats per recording: min {final_count.min()} max {final_count.max()}; "
        f"overflowed {int(overflowed.sum())}")
    check(not overflowed.any(), "a capacity truncated events on the main path")
    check((final_count > 100).all(), f"too few beats: {final_count}")

    best = float("inf")
    for i in range(3):
        fresh = batch + np.float32(i + 1) * 1e-3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_main_path(fresh, cfg, "cuda")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    rate = BATCH * 10 / best
    log(f"warm wall time (best of 3): {best:.3f}s = {rate:.2f} audio-min/s "
        f"on {card}")

    stages = stage_breakdown(batch, cfg)
    log("stage breakdown (synchronized run): " + ", ".join(
        f"{k} {v:.3f}s" for k, v in stages.items()))

    # The kernel against its plain version at the main path's own inputs
    # (draft and final floor), then timed on the final-floor call.
    def plain(*a, **k):
        return kq.rolling_quantile_knots(*a, **k, dtype=torch.float32)

    for label, (a, k) in zip(("draft floor", "final floor"), captured):
        got = real_anchors(*a, **k)
        err, rel, ok = compare(got, plain(*a, **k))
        worst_err = max(worst_err, err)
        log(f"  knot kernel vs plain [main path, {label}] {tuple(a[0].shape)} -> "
            f"{tuple(got.shape)}: max abs err {err:.3g}, max rel err {rel:.3g}")
        check(ok, f"knot kernel disagrees with its plain version on the {label}")
    kernel_ms = cuda_ms(lambda: real_anchors(*a, **k), 50)
    plain_ms = cuda_ms(lambda: plain(*a, **k), 3)
    bound_ms, bound_by = knot_bound(*a, **k)
    log(f"knot kernel at the main path's shapes: {kernel_ms:.4f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}) on {card}")
    log("phase 4 main path: ok")

    # ---- 5. accuracy against the CPU reference -----------------------------
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "bench_cpu_baseline.json")
    with open(ref_path) as f:
        oracle = json.load(f)["per_seed"]
    curves = result_curves(res, SR)
    f1s, maes = [], []
    for s in SEEDS:
        beats, times, values = curves[s]
        ref = oracle[str(s)]
        f1s.append(beat_f1(beats, ref["beat_times"]))
        maes.append(bpm_mae(ref["bpm_times"], ref["bpm_values"], times, values))
    log(f"phase 5 accuracy vs CPU reference over {len(SEEDS)} seeds: worst beat F1 "
        f"{min(f1s):.6f}, worst BPM MAE {max(maes):.6f}")
    check(min(f1s) >= F1_FLOOR, f"worst beat F1 {min(f1s)} < {F1_FLOOR}")
    check(max(maes) < MAE_CEIL, f"worst BPM MAE {max(maes)} >= {MAE_CEIL}")

    # ---- 6. card vs the port on the CPU ------------------------------------
    t0 = time.perf_counter()
    res_cpu = run_main_path(batch[:2], cfg, "cpu")
    log(f"CPU run of recordings 0-1: {time.perf_counter() - t0:.2f}s")
    cpu_curves = result_curves(res_cpu, SR)
    for s in (0, 1):
        g = np.round(curves[s][0] * SR).astype(np.int64)
        c = np.round(cpu_curves[s][0] * SR).astype(np.int64)
        differ = len(np.setxor1d(g, c))
        f1 = beat_f1(curves[s][0], cpu_curves[s][0])
        log(f"  recording {s}: {len(g)} beats on the card, {len(c)} on the CPU, "
            f"{differ} positions differ, beat F1 {f1:.6f}")
        check(f1 >= 0.99, f"card vs CPU beat F1 {f1} < 0.99 on recording {s}")
    log("phase 6 card vs CPU: ok")

    table = {"kernels": [{
        "name": "knot_quantile",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/knot_quantile.cu",
        "replaces": "bpm_analysis_tpu/ops/pallas/knot_kernel.py:81",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
