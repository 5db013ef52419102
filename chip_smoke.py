#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the batched engine on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each printed on its own line with
the seconds since start:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both CUDA kernels, compiled with ``nvcc`` from ``csrc/`` in
   parallel, with each build's time;
3. each kernel vs its plain version on the card: the knot-quantile kernel
   against ``ops/knot_quantile.rolling_quantile_knots`` on the cases of
   tests/test_knot_kernel.py and engine-shaped knots; the strided-quantile
   kernel against ``ops/cuda/quantile_kernel.plain_anchors`` on the cases of
   tests/test_pallas_quantile.py, a masked tail, a short row, windows
   that need 8 and 32 warps, and engine-shaped series;
4. the main path at full width: 16 ten-minute recordings (302 Hz,
   181,200 samples) through ``envelope.preprocess`` → ``pipeline.analyze_batch``
   at float32, stride 64, ``quantile_backend="auto"``; launch counts,
   warm wall time, a per-stage breakdown, and the knot kernel's time, bound
   and plain-version time on the main path's own inputs;
5. accuracy against the CPU reference's beats and BPM curves
   (``bench_cpu_baseline.json``): worst beat F1 >= 0.99, BPM MAE < 0.5;
6. the card against the port on the CPU, recordings 0 and 1;
7. the strided-kernel path at full width: the same batch and configuration
   with ``quantile_backend="pallas"`` (the dense noise floor on the
   strided-quantile kernel); launch counts, warm wall time, stage breakdown,
   the phase-5 accuracy gates, the kernel against its plain version at the
   path's own inputs with its time, bound, plain-version time and the
   ``torch.nanquantile`` yardstick, and the card against the CPU;
8. the default configuration (stride 1: the exact wavelet-tree floor) in
   float64 on the vulpine recording of ``tests/golden/vulpine_oracle.npz``,
   with both prominence backends, against the golden counts and beats.

The second-to-last line is the kernel table as JSON, the last line the
result.  Any failing phase exits non-zero before the result line; without a
CUDA device the script exits non-zero at once.
"""
import concurrent.futures
import dataclasses
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
# The strided quantile's bound counts the least work of the function, not
# the kernel's 32-plane select (csrc/strided_quantile.cu): a histogram select
# with 8-bit digits in 4 rounds, each a digit extraction, a prefix compare
# and a histogram increment per in-row key = 3, plus once per key the clamp
# of missing keys to one sentinel = 1; per anchor, 4 scans of 256 bins at an
# add and a compare each = 2048.  The rate is the SM's issue limit, one warp
# instruction per scheduler per clock, whichever pipe takes it (int32 adds
# also go as IMAD to the FMA pipe): 132 SMs x 4 x 32 lanes x 1.98 GHz.
PEAK_ISSUE_OPS = 132 * 128 * 1.98e9
OPS_DIGIT_ROUND, DIGIT_ROUNDS, OPS_KEY_ONCE = 3, 4, 1
OPS_ANCHOR = DIGIT_ROUNDS * 256 * 2
STRIDED_RTOL = 1e-6     # tests/test_pallas_quantile.py:26
VULPINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                       "vulpine_oracle.npz")

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


def strided_kernel_cases():
    """(name, x, window, stride, q, min_periods) for the strided-quantile
    kernel: the cases of tests/test_pallas_quantile.py, a masked tail, a row
    shorter than one window, the kernel's 256- and 1024-thread blocks, and
    engine-shaped series."""
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(2, 3000).astype(np.float32)) * 100
    x[0, :40] = np.nan
    cases = [("pallas_w603", x, 603, 8, 0.2, 3), ("pallas_w301", x, 301, 4, 0.2, 3)]
    rng = np.random.RandomState(5)
    masked = np.abs(rng.randn(2, 5000).astype(np.float32)) * 50
    masked[:, ::9] = np.round(masked[:, ::9])
    masked[1, 3500:] = np.nan                   # a padded row, NaN past n_valid
    cases.append(("masked_tail", masked, 603, 8, 0.2, 3))
    short = np.abs(rng.randn(1, 200).astype(np.float32)) * 20
    cases.append(("short_row", short, 603, 8, 0.2, 3))
    # Windows that need 8 and 32 warps (the kernel's widest block).
    wide = np.abs(rng.randn(2, 30000).astype(np.float32)) * 10
    wide[:, ::5] = np.round(wide[:, ::5])
    wide[1, 27000:] = np.nan
    cases.append(("wide_w6037", wide, 6037, 64, 0.3, 3))
    cases.append(("widest_w24575", wide, 24575, 128, 0.2, 3))
    # Engine shapes: a smooth positive trough-interpolation-like series per
    # row, NaN before the first trough, ties from rounding.
    n = 181200
    t = np.arange(n, dtype=np.float32)
    eng = np.empty((BATCH, n), np.float32)
    for r in range(BATCH):
        base = (20 + 10 * np.sin(t / (300 + 40 * r))
                + 5 * np.abs(rng.randn(n)).astype(np.float32))
        base[::7] = np.round(base[::7])
        base[:rng.randint(0, 400)] = np.nan
        eng[r] = base
    cases.append(("engine_shapes", eng, 3020, 64, 0.2, 3))
    return cases


def compare(got: torch.Tensor, exp: torch.Tensor, rtol=RTOL, atol=ATOL):
    """(max abs err, max rel err, ok) under rtol/atol with equal NaN
    positions."""
    g, e = got.cpu().numpy(), exp.cpu().numpy()
    nan_ok = np.array_equal(np.isnan(g), np.isnan(e))
    fin = ~np.isnan(e) & ~np.isnan(g)
    diff = np.abs(g[fin] - e[fin])
    err = float(diff.max()) if diff.size else 0.0
    rel = float((diff / np.maximum(np.abs(e[fin]), 1e-30)).max()) if diff.size else 0.0
    ok = nan_ok and np.allclose(g, e, rtol=rtol, atol=atol, equal_nan=True)
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

def strided_bound(x, window, stride) -> tuple:
    """Least time for the strided quantile of ``x`` (B, n): bytes (the
    series read once, the anchors written once) over HBM bandwidth, and the
    histogram select's operations on the window keys that lie in the row
    (edge windows are cut) over the issue limit.  Returns (ms,
    'bytes'|'operations')."""
    from bpm_analysis_tpu_torch.ops.rolling import centered_bounds

    bsz, n = x.shape
    left, right = centered_bounds(window)
    n_anchor = -(-n // stride)
    apos = np.arange(n_anchor, dtype=np.int64) * stride
    keys = (np.minimum(apos + right, n - 1) - np.maximum(apos - left, 0) + 1).sum() * bsz
    ops = (float(keys) * (DIGIT_ROUNDS * OPS_DIGIT_ROUND + OPS_KEY_ONCE)
           + bsz * n_anchor * OPS_ANCHOR)
    t_bytes = (x.numel() + bsz * n_anchor) * 4 / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_ISSUE_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nanquantile_rows(x, window, q, min_periods, stride):
    """The library yardstick for the strided quantile: ``torch.nanquantile``
    over each row's unfolded windows (its input is capped at 2^24 elements,
    so one row per call), NaN below ``min_periods``."""
    from bpm_analysis_tpu_torch.ops.rolling import centered_bounds

    left, right = centered_bounds(window)
    out = []
    for r in range(x.shape[0]):
        w = torch.nn.functional.pad(x[r:r + 1], (left, right),
                                    value=float("nan")).unfold(1, window, stride)
        val = torch.nanquantile(w, q, dim=-1)
        out.append(torch.where((~torch.isnan(w)).sum(-1) >= min_periods, val,
                               torch.full_like(val, float("nan"))))
    return torch.cat(out)


def reset_launches():
    from bpm_analysis_tpu_torch.ops.cuda import knot_kernel, quantile_kernel

    knot_kernel.launches = 0
    quantile_kernel.launches = 0


def read_launches() -> dict:
    from bpm_analysis_tpu_torch.ops.cuda import knot_kernel, quantile_kernel

    return {"knot_quantile": knot_kernel.launches,
            "strided_quantile": quantile_kernel.launches}


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

    from bpm_analysis_tpu_torch.ops import series
    from bpm_analysis_tpu_torch.ops.cuda import quantile_kernel

    patches = [
        (fp, "build_extrema", lambda a, k: "build_extrema"),
        (noise_floor, "dynamic_noise_floor", lambda a, k: "noise_floor"),
        # Inside the noise floor on the dense path:
        (series, "interpolate_dense", lambda a, k: "of which interpolate_dense"),
        (quantile_kernel, "rolling_quantile_strided_cuda",
         lambda a, k: "of which strided quantile (kernel + interp_anchors)"),
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


def build_all() -> dict:
    """Build every kernel library at once (one nvcc per source, started
    together); returns each build's seconds."""
    from bpm_analysis_tpu_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t0

    names = ("knot_quantile", "strided_quantile")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def check_knot_cases(dev) -> float:
    from bpm_analysis_tpu_torch.ops import knot_quantile as kq
    from bpm_analysis_tpu_torch.ops.cuda import knot_kernel

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
    return worst_err


def check_strided_cases(dev) -> float:
    from bpm_analysis_tpu_torch.ops.cuda import quantile_kernel

    worst_err = 0.0
    for name, x, window, stride, q, mp in strided_kernel_cases():
        xt = torch.from_numpy(x).to(dev)
        got = quantile_kernel.strided_quantile_anchors(xt, window, q, mp, stride)
        exp = quantile_kernel.plain_anchors(xt, window, q, mp, stride)
        torch.cuda.synchronize()
        err, rel, ok = compare(got, exp, rtol=STRIDED_RTOL, atol=0.0)
        worst_err = max(worst_err, err)
        log(f"  strided kernel vs plain [{name}] {tuple(x.shape)} -> {tuple(got.shape)}: "
            f"max abs err {err:.3g}, max rel err {rel:.3g}")
        check(ok, f"strided kernel disagrees with its plain version on {name}")
    return worst_err


def counted_run(batch, cfg, captures: dict):
    """Drive the path once with every launch count set to 0 just before and
    read just after; ``captures`` maps (module, attribute) of a kernel
    wrapper to a list that collects its calls' arguments."""
    saved = []
    for (mod, attr), calls in captures.items():
        real = getattr(mod, attr)

        def capturing(*a, _real=real, _calls=calls, **k):
            _calls.append((a, k))
            return _real(*a, **k)

        saved.append((mod, attr, real))
        setattr(mod, attr, capturing)
    try:
        reset_launches()
        res = run_main_path(batch, cfg, "cuda")
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return res, launches


def warm_best(batch, cfg, reps: int) -> float:
    best = float("inf")
    for i in range(reps):
        fresh = batch + np.float32(i + 1) * 1e-3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_main_path(fresh, cfg, "cuda")
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def check_accuracy(res, oracle, label):
    from bpm_analysis_tpu_torch.accuracy import (F1_FLOOR, MAE_CEIL, beat_f1, bpm_mae,
                                                 result_curves)

    curves = result_curves(res, SR)
    f1s, maes = [], []
    for s in SEEDS:
        beats, times, values = curves[s]
        ref = oracle[str(s)]
        f1s.append(beat_f1(beats, ref["beat_times"]))
        maes.append(bpm_mae(ref["bpm_times"], ref["bpm_values"], times, values))
    log(f"{label} accuracy vs CPU reference over {len(SEEDS)} seeds: worst beat F1 "
        f"{min(f1s):.6f}, worst BPM MAE {max(maes):.6f}")
    check(min(f1s) >= F1_FLOOR, f"{label}: worst beat F1 {min(f1s)} < {F1_FLOOR}")
    check(max(maes) < MAE_CEIL, f"{label}: worst BPM MAE {max(maes)} >= {MAE_CEIL}")
    return curves


def check_card_vs_cpu(batch, cfg, curves, label):
    from bpm_analysis_tpu_torch.accuracy import beat_f1, result_curves

    t0 = time.perf_counter()
    res_cpu = run_main_path(batch[:2], cfg, "cpu")
    log(f"{label} CPU run of recordings 0-1: {time.perf_counter() - t0:.2f}s")
    cpu_curves = result_curves(res_cpu, SR)
    for s in (0, 1):
        g = np.round(curves[s][0] * SR).astype(np.int64)
        c = np.round(cpu_curves[s][0] * SR).astype(np.int64)
        differ = np.setxor1d(g, c)
        f1 = beat_f1(curves[s][0], cpu_curves[s][0])
        log(f"  recording {s}: {len(g)} beats on the card, {len(c)} on the CPU, "
            f"{len(differ)} positions differ {differ[:20].tolist()}, beat F1 {f1:.6f}")
        check(f1 >= 0.99, f"{label}: card vs CPU beat F1 {f1} < 0.99 on recording {s}")


def check_vulpine_default(card, dev):
    """The default configuration (stride 1, wavelet tree) in float64 on the
    vulpine recording, with the extrema and the dense prominence backends:
    the checks of tests/test_pipeline_golden.py::test_pipeline_stage_outputs
    and equal integer outputs between the two backends."""
    from bpm_analysis_tpu_torch.config import DEFAULT_CONFIG
    from bpm_analysis_tpu_torch.models import envelope as envm, noise_floor, pipeline

    oracle = np.load(VULPINE)
    sr = int(oracle["sample_rate"])
    check(noise_floor.quantile_path(DEFAULT_CONFIG) == "exact",
          "the default configuration is not the stride-1 floor")
    x = torch.from_numpy(oracle["raw_signal"].astype(np.float64)).to(dev)[None]
    results = {}
    for backend in ("auto", "dense"):
        cfg = DEFAULT_CONFIG.replace(runtime=dataclasses.replace(
            DEFAULT_CONFIG.runtime, prominence_backend=backend))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        res = pipeline.analyze_batch(envm.envelope_from_filtered(x, sr), sr, cfg,
                                     device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        count = int(res.final_count[0])
        got = {"trough_count": int(res.trough_count[0]),
               "raw_peak_count": int(res.raw_peak_count[0]),
               "start_bpm": float(res.start_bpm[0]),
               "peak_bpm_time": float(res.peak_bpm_time[0]), "final_count": count}
        log(f"  vulpine, default config, prominence_backend={backend!r}, float64: "
            f"{seconds:.2f}s on {card}; {got}; launches {read_launches()}")
        check(got["trough_count"] == len(oracle["sanitized_troughs"]),
              f"{backend}: trough count {got['trough_count']}")
        check(got["raw_peak_count"] == len(oracle["all_raw_peaks"]),
              f"{backend}: raw peak count {got['raw_peak_count']}")
        check(np.isclose(got["start_bpm"], oracle["start_bpm"], rtol=1e-9, atol=0),
              f"{backend}: start BPM {got['start_bpm']}")
        check(np.isclose(got["peak_bpm_time"], oracle["peak_time"], rtol=1e-9, atol=0),
              f"{backend}: peak BPM time {got['peak_bpm_time']}")
        check(np.array_equal(res.final_positions[0, :count].cpu().numpy(),
                             oracle["final_peaks"]),
              f"{backend}: final beats differ from the golden's")
        check(bool(res.ok[0]) and not bool(res.overflowed[0]), f"{backend}: not ok")
        results[backend] = res
    def leaves(a, b, prefix=""):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if hasattr(x, "_fields"):
                yield from leaves(x, y, f"{prefix}{name}.")
            else:
                yield f"{prefix}{name}", x, y

    ints = 0
    for name, a, b in leaves(results["auto"], results["dense"]):
        if not a.is_floating_point():
            check(torch.equal(a, b), f"vulpine: {name} differs between the backends")
            ints += 1
    log(f"  both backends: {ints} integer fields equal, "
        f"{len(oracle['final_peaks'])} final beats as the golden")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.models import noise_floor
    from bpm_analysis_tpu_torch.ops import knot_quantile as kq
    from bpm_analysis_tpu_torch.ops.cuda import knot_kernel, quantile_kernel

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
    builds = build_all()
    knot_kernel._library()
    quantile_kernel._library()
    log("phase 2 build: " + ", ".join(f"nvcc {k} {v:.2f}s" for k, v in builds.items())
        + f"; {time.perf_counter() - t0:.2f}s in all")

    # ---- 3. kernels vs plain versions on the card --------------------------
    knot_err = check_knot_cases(dev)
    strided_err = check_strided_cases(dev)
    log(f"phase 3 kernels vs plain: ok (knot rtol {RTOL} atol {ATOL}; strided rtol "
        f"{STRIDED_RTOL})")

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
    res, launches = counted_run(batch, cfg, {
        (noise_floor.knot_kernel, "knot_quantile_anchors"): captured})
    log(f"kernel launches on the main path: {launches}")
    check(launches == {"knot_quantile": 2, "strided_quantile": 0},
          f"expected 2 knot-kernel launches and none of the strided kernel, got {launches}")

    overflowed = res.overflowed.cpu().numpy()
    final_count = res.final_count.cpu().numpy()
    log(f"final beats per recording: min {final_count.min()} max {final_count.max()}; "
        f"overflowed {int(overflowed.sum())}")
    check(not overflowed.any(), "a capacity truncated events on the main path")
    check((final_count > 100).all(), f"too few beats: {final_count}")

    best = warm_best(batch, cfg, 2)
    log(f"warm wall time (best of 2): {best:.3f}s = {BATCH * 10 / best:.2f} audio-min/s "
        f"on {card}")

    stages = stage_breakdown(batch, cfg)
    log("stage breakdown (synchronized run): " + ", ".join(
        f"{k} {v:.3f}s" for k, v in stages.items()))

    # The kernel against its plain version at the main path's own inputs
    # (draft and final floor), then timed on the final-floor call.
    real_anchors = knot_kernel.knot_quantile_anchors

    def plain(*a, **k):
        return kq.rolling_quantile_knots(*a, **k, dtype=torch.float32)

    for label, (a, k) in zip(("draft floor", "final floor"), captured):
        got = real_anchors(*a, **k)
        err, rel, ok = compare(got, plain(*a, **k))
        knot_err = max(knot_err, err)
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
    curves = check_accuracy(res, oracle, "phase 5")

    # ---- 6. card vs the port on the CPU ------------------------------------
    check_card_vs_cpu(batch, cfg, curves, "phase 6")
    log("phase 6 card vs CPU: ok")

    # ---- 7. the strided-kernel path at full width ---------------------------
    cfg_b2 = cfg.replace(runtime=dataclasses.replace(cfg.runtime, quantile_backend="pallas"))
    check(noise_floor.quantile_path(cfg_b2) == "strided_kernel",
          "quantile_backend='pallas' at stride 64 does not select the strided kernel")
    s_captured = []
    res_b2, launches_b2 = counted_run(batch, cfg_b2, {
        (quantile_kernel, "strided_quantile_anchors"): s_captured})
    log(f"kernel launches on the strided-kernel path: {launches_b2}")
    check(launches_b2 == {"knot_quantile": 0, "strided_quantile": 2},
          f"expected 2 strided-kernel launches and none of the knot kernel, got "
          f"{launches_b2}")
    overflowed = res_b2.overflowed.cpu().numpy()
    final_count = res_b2.final_count.cpu().numpy()
    log(f"final beats per recording: min {final_count.min()} max {final_count.max()}; "
        f"overflowed {int(overflowed.sum())}")
    check(not overflowed.any(), "a capacity truncated events on the strided-kernel path")
    best_b2 = warm_best(batch, cfg_b2, 2)
    log(f"strided-kernel path warm wall time (best of 2): {best_b2:.3f}s = "
        f"{BATCH * 10 / best_b2:.2f} audio-min/s on {card}")
    stages_b2 = stage_breakdown(batch, cfg_b2)
    log("strided-kernel path stage breakdown (synchronized run): " + ", ".join(
        f"{k} {v:.3f}s" for k, v in stages_b2.items()))
    curves_b2 = check_accuracy(res_b2, oracle, "phase 7")

    real_strided = quantile_kernel.strided_quantile_anchors
    for label, (a, k) in zip(("draft floor", "final floor"), s_captured):
        got = real_strided(*a, **k)
        err, rel, ok = compare(got, quantile_kernel.plain_anchors(*a, **k),
                               rtol=STRIDED_RTOL, atol=0.0)
        strided_err = max(strided_err, err)
        log(f"  strided kernel vs plain [strided-kernel path, {label}] "
            f"{tuple(a[0].shape)} -> {tuple(got.shape)}: max abs err {err:.3g}, "
            f"max rel err {rel:.3g}")
        check(ok, f"strided kernel disagrees with its plain version on the {label}")
    x_b2, window_b2, q_b2, mp_b2, stride_b2 = a[:5]
    s_kernel_ms = cuda_ms(lambda: real_strided(*a, **k), 10)
    s_plain_ms = cuda_ms(lambda: quantile_kernel.plain_anchors(*a, **k), 2)
    s_library_ms = cuda_ms(lambda: nanquantile_rows(x_b2, window_b2, q_b2, mp_b2,
                                                    stride_b2), 2)
    s_bound_ms, s_bound_by = strided_bound(x_b2, window_b2, stride_b2)
    log(f"strided kernel at the path's shapes {tuple(x_b2.shape)} window {window_b2} "
        f"stride {stride_b2}: {s_kernel_ms:.4f} ms (plain {s_plain_ms:.3f} ms, "
        f"torch.nanquantile {s_library_ms:.3f} ms, bound {s_bound_ms:.5f} ms by "
        f"{s_bound_by}) on {card}")
    check_card_vs_cpu(batch, cfg_b2, curves_b2, "phase 7")
    log("phase 7 strided-kernel path: ok")

    # ---- 8. the default configuration on the vulpine recording -------------
    check_vulpine_default(card, dev)
    log("phase 8 default configuration: ok")

    table = {"kernels": [{
        "name": "knot_quantile",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/knot_quantile.cu",
        "replaces": "bpm_analysis_tpu/ops/pallas/knot_kernel.py:81",
        "launches": launches["knot_quantile"],
        "max_abs_err": knot_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "strided_quantile",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/strided_quantile.cu",
        "replaces": "bpm_analysis_tpu/ops/pallas/quantile_kernel.py:46",
        "launches": launches_b2["strided_quantile"],
        "max_abs_err": strided_err,
        "ms": s_kernel_ms,
        "plain_ms": s_plain_ms,
        "bound_ms": s_bound_ms,
        "bound_by": s_bound_by,
        "library_ms": s_library_ms,
    }]}
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
