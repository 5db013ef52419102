#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the batched engine on one CUDA card.

    python3 chip_smoke.py

Run from the repository root.  Phases, each printed on its own line with
the seconds since start:

1. device: the card's name, power limit and maximum SM clock (``nvidia-smi``);
2. build: the seven CUDA kernels, compiled with ``nvcc`` from ``csrc/`` in
   parallel, with each build's time;
3. each kernel vs its plain version on the card: the knot kernel's fast
   division against IEEE division over 2^30 operand pairs, the classifier
   kernel's over its constant divisors x 2^25 numerators and 2^28 random
   pairs; the
   knot-quantile kernel against ``ops/knot_quantile.rolling_quantile_knots``
   on the cases of tests/test_knot_kernel.py, knots 2-5 samples apart (more
   segments a window than a lane group holds in registers), all-flat knots
   and engine-shaped knots; the strided-quantile kernel against
   ``ops/quantile.strided_quantile_anchors_f32_plain`` on the cases of
   tests/test_pallas_quantile.py, a masked tail, a short row, windows of
   6037 and 24575 keys, the tiled design's edges (a ragged last tile, a row
   shorter than one tile, all-equal and all-missing windows, heavy ties,
   keys on both sides of a 24-bit prefix boundary) and engine-shaped series;
   the row-quantile kernel against ``ops/quantile.quantile_exact_plain``
   bit for bit on ``row_quantile_cases`` (signed zeros, all-equal rows, one
   and no valid element, +-inf, NaN without a mask, ties, envelopes) at
   q = 0, 0.1, 0.5, 1, both dtypes, three rows of 7 and rows of 229,825
   alone (a cluster of blocks a row); the rolling-quantile kernel against
   ``ops/quantile.rolling_quantile_centered_plain`` bit for bit on
   ``rolling_quantile_cases`` (NaN runs, signed zeros, all-equal rows, +-inf,
   odd and even windows, a window of the whole row, the widest window
   sorted in shared memory and one wider, sorted in global scratch, and a
   384 kHz recording's default window) at three rows of 1000, two of
   20,000, four of 181,200 and one of 229,825, both dtypes;
   the classifier and rhythm scans against ``classifier.scan_plain`` and
   ``corrections.rhythm_scan_plain`` on four one-minute recordings (rows cut
   to 0, 1, 2 and 4 peaks, a row at full capacity), float32 and float64,
   kick-start off and on, with and without the trace: every field equal;
   the rhythm scan also on NaN, infinite, negative and boundary thresholds,
   unsorted rows, one run over a whole row and rows of three of its tiles
   (``rhythm_cases``);
   the blocked filter against ``ops/filter.lfilter_plain`` and each of its
   phase entry points (``ops/filter.contributions`` / ``carry_scan`` /
   ``apply`` on the card) against its ``BlockFilter`` piece (short rows, a ragged last
   block, 2-6 states, both dtypes, the main path's length, one long row);
4. the main path at full width: 16 ten-minute recordings (302 Hz,
   181,200 samples) through ``envelope.preprocess`` → ``pipeline.analyze_batch``
   at float32, stride 64, ``quantile_backend="auto"``; launch counts (the
   filter kernel twice, the knot kernel twice, the row quantile four times,
   the classifier scan twice, the rhythm scan once), warm wall time, the
   table of the program's
   ``bpm.*`` spans from one traced batch (``utils/profiling.stage_table``:
   host ms, device ms and launches of each stage), and each
   of those kernels against its plain version on the main path's own
   inputs with its time, bound and plain-version time (the classifier scan
   timed in both its passes; the rhythm scan queued behind a spin kernel, so
   that the card and not the host's issue times it, beside an empty launch
   timed the same way; the row quantile also at the fleet cell's shape, the
   envelope tiled to 512 rows without and with a valid-prefix mask, with
   ``torch.nanquantile`` by rows as the library yardstick);
5. accuracy against the CPU reference's beats and BPM curves
   (``bench_cpu_baseline.json``): worst beat F1 >= 0.99, BPM MAE < 0.5;
6. the card against the port on the CPU, recordings 0 and 1;
7. the strided-kernel path at full width: the same batch and configuration
   with ``quantile_backend="pallas"`` (the dense noise floor on the
   strided-quantile kernel); launch counts, warm wall time, the span table,
   the phase-5 accuracy gates, the kernel against its plain version at the
   path's own inputs with its time, bound, plain-version time and the
   ``torch.nanquantile`` yardstick, and the card against the CPU;
8. the default configuration (stride 1: the exact floor on the
   rolling-quantile kernel) in float64 on the vulpine recording of
   ``tests/golden/vulpine_oracle.npz``, with both prominence backends,
   against the golden counts and beats (the float64 scan kernels); then
   phase 4's batch at the ``exact-f64`` configuration (stride 1, float64):
   launch counts, both floors' calls against the plain version, and the
   final floor's input tiled to (256, 181,200) float64, a float32 row of
   229,825 and a float32 row of 768,000 at a 384 kHz recording's default
   window, each timed beside ``rolling_bound`` and the plain version, and
   the float32 rows beside ``torch.nanquantile`` over unfolded windows;
9. the host path at full width: phase 4's 16 recordings written as int16
   302 Hz WAVs through ``host_batch.analyze_files_batched`` at phase 4's
   configuration with every artifact (launch counts, the phase-5 accuracy
   gates, positions against phase 4's in-memory run, wall time and each
   lane's seconds), the same files in two chunks (the main thread's
   dispatch with and without a render running beside it), the serial
   ``host.analyze_wav_file`` on recording 0 against the batched artifacts,
   two 44.1 kHz recordings decimated by the native decoder against
   ``bench_cpu_native.json``, and the CLI on the vulpine signal in a
   subprocess;
10. scale-out on the one card (``parallel/``), ranks started by
   ``parallel.mesh.spawn`` after phase 2 built the kernels: dp — 4 gloo
   ranks share the card on phase 4's batch, 4 recordings each (B1's
   launches per rank, the gathered beats against phase 4's, ``fleet_summary``
   against one-device reductions, the phase-5 gates, the warm wall time
   beside phase 4's); a world of 1 on NCCL runs ``fleet_summary``; sp — 4
   gloo ranks, each holding a quarter of a two-hour recording on the card,
   hold the sharded envelope, quantile and filtfilt against the local
   functions, the filtfilt's relay running on the filter kernel's phase
   entry points (their launches per rank) and equal bit for bit to the same
   relay on ``BlockFilter``'s plain pieces; the host — ``analyze_files_batched(mesh=...)`` on 2 ranks
   against an unsharded run at one file a batch, and both against phase 9's
   chunk of 16 (equal positions and CSV: a recording's result does not
   depend on its batch); and ``utils.profiling.device_trace`` around
   both quantile kernels, with their CUDA times from the trace beside the
   CUDA-event times.

The second-to-last line is the kernel table as JSON, the last line the
result.  Any failing phase exits non-zero before the result line; without a
CUDA device the script exits non-zero at once.
"""
import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
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
# The classifier scan's bound is the longest carry-dependent chain of one
# step times the slots (csrc/classify_scan.cu counts its chains): ALU
# operations at 4 cycles each and IEEE divisions by a carried value at 40
# (div.rn.f32's subroutine), at the card's maximum SM clock as nvidia-smi
# reports it.  A division by a constant counts as the hoisted fast path's 3
# dependent operations.  The classifier's four chains from one step's belief
# to the next one's, as (ALU operations, divisions); the longest in cycles is
# the bound.
CLASSIFY_CHAINS = {"base confidence": (33, 0), "penalty": (37, 1),
                   "interval penalty": (22, 2), "lone check": (30, 2)}
ALU_CYCLES, DIV_CYCLES = 4, 40
# The rhythm scan's chain at given inputs (csrc/rhythm_scan.cu): one IEEE
# division places the row's integer threshold d* (the divisions at d* and
# d* - 1 that pin it issue side by side), then the longest run of dependent
# steps, each an integer subtract, the compare with d*, the decision and the
# carry select.  Where a row's active positions are non-decreasing its runs
# start at slot 0 and at every slot at least d* after the one before; a row
# that is not sorted is one run of count steps.  Printed beside it, the chain
# of a scan that divides on every step over the whole capacity (6 ALU
# operations and a carried division a step; the kernel's earlier design).
RHYTHM_STEP_ALU = 4
RHYTHM_DIVIDING_STEP = (6, 1)
RHYTHM_TILE = 2048      # csrc/rhythm_scan.cu's kTile: slots staged a pass
RHYTHM_CASES = ("pipeline", "full_capacity", "conflicts", "few_slots", "edge_thresholds",
                "at_f(d)", "below_f(d)", "above_f(d)", "unsorted", "one_run", "tiles")
# device_ms queues the timed calls behind a spin of this many clock cycles
# (~17 ms at 1.98 GHz), longer than the host takes to issue them.
SPIN_CYCLES = 1 << 25
# The block filter's carry scan: one step of a row's chain is a product's
# multiply, its m - 1 adds and + C[k]: m + 1 dependent operations.
FILTER_LONG_ROW = 362_401
CLASSIFY_DIVISION_NUMERATORS = 1 << 24   # per constant divisor
STRIDED_RTOL = 1e-6     # tests/test_pallas_quantile.py:26
# Phase 10: the fleet means of 4 ranks' partial sums against one sum over
# the batch, both float32: 16 terms summed in another order.
FLEET_RTOL = 1e-5
DP_RANKS = SP_RANKS = 4
SP_RECORDINGS = 12      # two hours at 302 Hz
SP_QUANTILE = dict(window=3020, q=0.3, min_periods=3, stride=64)
DIVISION_PAIRS = 1 << 28
REPO = os.path.dirname(os.path.abspath(__file__))
VULPINE = os.path.join(REPO, "tests", "golden", "vulpine_oracle.npz")
ARTIFACTS = ("_bpm_plot.csv", "_bpm_plot.html", "_Analysis_Summary.md", "_Debug_Log.md",
             "_Analysis_Settings.json", "_filtered_debug.wav")

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
    # Windows that meet more segments (~120-300) than one lane group holds
    # in registers (8 lanes x 7): knots 2-5 samples apart, window 603.
    rng = np.random.RandomState(13)
    ps, vs, cs = [], [], []
    for count in (700, 420):
        p = np.full(768, 2400, np.int32)
        pos = np.cumsum(rng.randint(2, 6, size=count)) - 2
        pos = pos[pos < 2400]
        p[:len(pos)] = pos
        v = np.zeros(768, np.float32)
        v[:len(pos)] = np.abs(rng.randn(len(pos))).astype(np.float32) * 40
        v[:len(pos):5] = np.round(v[:len(pos):5])
        ps.append(p)
        vs.append(v)
        cs.append(len(pos))
    cases.append(("dense_knots_w603", np.stack(ps), np.stack(vs), np.array(cs, np.int32),
                  2400, 603, 8, 2, np.array([2400, 2000], np.int32)))
    # All-flat knots: every segment constant, one value per row.
    rng = np.random.RandomState(17)
    ps, cs = [], []
    for count in (60, 25):
        p, _, c = random_knots(rng, 4000, 64, 40, count)
        ps.append(p)
        cs.append(c)
    flat = np.zeros((2, 64), np.float32)
    flat[0, :cs[0]] = 12.5
    flat[1, :cs[1]] = 3.0
    cases.append(("all_flat", np.stack(ps), flat, np.array(cs, np.int32), 4000, 603, 8, 40,
                  None))
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
    shorter than one window, windows of 6037 and 24575 keys, the tiled
    design's edges (a ragged last tile, a row shorter than one tile,
    all-equal and all-missing windows, heavy ties at v_lo, keys on both
    sides of a 24-bit prefix boundary), and engine-shaped series."""
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
    # The tiled design's edges: 125 anchors a row (not a multiple of the
    # 16-anchor tile), a row of 10 anchors (shorter than one tile), a window
    # of all-equal keys, an all-missing stretch longer than a window.
    edge = np.random.RandomState(19)
    ragged = np.abs(edge.randn(2, 1000).astype(np.float32)) * 30
    ragged[0, 300:700] = 7.25                   # all-equal windows
    ragged[1, 200:600] = np.nan                 # all missing, longer than a window
    cases.append(("ragged_tile_w301", ragged, 301, 8, 0.3, 3))
    cases.append(("row_shorter_than_tile", ragged[:, :40].copy(), 61, 4, 0.5, 3))
    # Heavy ties at v_lo: a few integer levels, so v_lo's round-4 bin holds
    # many keys.
    ties = edge.randint(0, 4, size=(2, 3000)).astype(np.float32)
    ties[1, ::3] = np.nan
    cases.append(("ties_at_v_lo", ties, 603, 8, 0.35, 3))
    # Keys that share one 24-bit prefix (row 0: v_hi from round 4's next
    # non-empty bin) and keys whose low byte is 0xFF (row 1: v_lo's bin is
    # the last with its prefix, so v_hi needs the min pass over the keys).
    bits = np.stack([0x42C80000 | edge.randint(0, 256, size=2000),
                     ((0x42C800 + edge.randint(0, 64, size=2000)) << 8) | 0xFF])
    pattern = bits.astype(np.uint32).view(np.float32)
    pattern[:, ::9] = np.nan
    cases.append(("prefix_boundary", pattern, 301, 4, 0.45, 3))
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


ROW_QUANTILE_QS = (0.0, 0.1, 0.5, 1.0)


def row_quantile_cases(n: int, seed: int = 0) -> list:
    """(name, x, valid) cases of the row-quantile kernel: three float64 rows
    of length ``n`` and a bool mask, or None for ``~isnan(x)``.  Signed zeros
    around the median (-0.0 and +0.0 tie as floats, not as keys), all-equal
    rows, one valid element, no valid element (a false mask, all-NaN rows),
    negative values with +-inf, NaN without a mask, heavy ties under a
    random mask, and smooth positive envelopes with a valid prefix (the main
    path's rows)."""
    rng = np.random.RandomState(seed)
    full = np.ones((3, n), dtype=bool)
    m = n // 3
    zeros = np.where(np.arange(m) % 2 == 0, -0.0, 0.0)
    signed = np.stack([rng.permutation(np.concatenate(
        [-rng.rand(m) - 0.5, zeros, rng.rand(n - 2 * m) + 0.5])) for _ in range(3)])
    one = np.zeros((3, n), dtype=bool)
    one[np.arange(3), rng.randint(0, n, size=3)] = True
    infs = rng.randn(3, n) * 100 - 50
    infs[rng.rand(3, n) < 0.05] = -np.inf
    infs[rng.rand(3, n) < 0.05] = np.inf
    nans = rng.randn(3, n)
    nans[rng.rand(3, n) < 0.3] = np.nan
    smooth = np.stack([np.abs(np.convolve(rng.randn(n + 30), np.ones(31) / 31, mode="valid"))
                       for _ in range(3)]) + 0.05
    prefix = np.arange(n)[None, :] < (n - np.arange(3) * (n // 7))[:, None]
    return [("signed_zeros", signed, full),
            ("all_equal", np.stack([np.full(n, v) for v in (2.5, -0.0, -3.0)]), None),
            ("one_valid", rng.randn(3, n) * 10, one),
            ("no_valid", rng.randn(3, n), np.zeros((3, n), dtype=bool)),
            ("all_nan", np.full((3, n), np.nan), None),
            ("negative_inf", infs, full),
            ("nan_no_mask", nans, None),
            ("ties_masked", np.round(rng.randn(3, n) * 3), rng.rand(3, n) < 0.7),
            ("envelope_prefix", smooth, prefix)]


def _beat_row(intervals, cap: int, count=None, start: int = 150):
    """(positions (cap,) int32, count) of beats ``intervals`` samples apart,
    padded past the count with the last position + 1000 (a corrected row's
    fill is the envelope's length)."""
    pos = start + np.concatenate([[0], np.cumsum(np.asarray(intervals, np.int64))])
    count = min(len(pos), cap) if count is None else count
    row = np.full(cap, int(pos[min(count, len(pos)) - 1]) + 1000 if count else 1000, np.int32)
    row[:count] = pos[:count]
    return row, count


def metrics_fleet_rows(rows: int, cap: int, sr: int = SR, seed: int = 0,
                       seconds: float = 600):
    """(positions (rows, cap) int32, count (rows,) int32): ``seconds`` of
    beats a row (ten minutes by default) with the BPM wandering between ~70
    and ~190 (a slow sine, a random walk and 3% jitter), as the main path's
    corrected rows."""
    rng = np.random.RandomState(seed)
    pos, count = np.empty((rows, cap), np.int32), np.empty(rows, np.int32)
    for r in range(rows):
        t, iv = 0.0, []
        period, phase, walk = rng.uniform(60, 240), rng.uniform(0, 6.3), 0.0
        while t < seconds and len(iv) < cap - 1:
            walk = np.clip(walk + rng.randn() * 1.5, -25, 25)
            bpm = 125 + 45 * np.sin(2 * np.pi * t / period + phase) + walk
            step = 60.0 / bpm * (1 + 0.03 * rng.randn())
            t += step
            iv.append(max(int(round(step * sr)), 15))
        pos[r], count[r] = _beat_row(iv, cap)
    return pos, count


def metrics_cases(cap: int, seed: int = 0) -> list:
    """(name, sample_rate, positions (rows, cap) int32, count (rows,) int32)
    cases of the metrics kernel: counts 0, 1, 2, 39 (no HRV window), 41 and
    the capacity; beats at one position (diffs of 0 s, dropped); at 256 Hz,
    where beat times and BPM are exact binary fractions, piecewise-constant
    BPM (plateaus of the smoothed curve, equal maxima) and a periodic
    pattern (equal priorities inside one suppression window); jittered fast
    beats (more than 256 plateau maxima: the work capacity truncates);
    large slow swings (more than 64 peaks: the slope capacity truncates);
    the vulpine recording's final beats, whole and cut; and fleet rows."""
    rng = np.random.RandomState(seed)

    def rows(*made):
        return (np.stack([m[0] for m in made]).astype(np.int32),
                np.array([m[1] for m in made], np.int32))

    base = [int(x) for x in rng.randint(110, 190, size=cap)]
    counts = rows(*(_beat_row(base, cap, c) for c in (0, 1, 2, 39, 41, min(cap, 600), cap)))
    dup = list(base)
    for k in range(5, cap - 1, 37):
        dup[k] = 0
    close = rows(_beat_row(dup, cap), _beat_row([0] * 3 + base[:300], cap),
                 _beat_row([0] * (cap - 1), cap))
    levels = (128, 96, 192, 160, 128, 64)
    piece = [levels[(k // 40) % len(levels)] for k in range(cap)]
    periodic = [(128, 128, 96, 96, 160, 112)[k % 6] for k in range(cap)]
    flat = rows(_beat_row(piece, cap), _beat_row(periodic, cap),
                _beat_row([128] * cap, cap), _beat_row(piece[::-1], cap, cap // 2))
    jitter = rows(*(_beat_row(rng.randint(55, 110, size=cap), cap) for _ in range(3)))
    t = np.arange(cap) * 0.45
    swing = 60.0 / (125 + 55 * np.sin(2 * np.pi * t / 7.0)) * SR
    swings = rows(_beat_row(np.maximum(np.round(swing), 15).astype(int), cap),
                  _beat_row(np.maximum(np.round(swing * 1.3), 15).astype(int), cap))
    vul = np.load(VULPINE)
    final = np.asarray(vul["final_peaks"], np.int64)
    v_rate = int(vul["sample_rate"])
    vrow = lambda p: _beat_row(np.diff(p), cap, start=int(p[0]))  # noqa: E731
    vulpine = rows(vrow(final[:cap]), vrow(final[100:400]), vrow(final[::2][:cap]))
    return [("counts", SR, *counts), ("close_beats", SR, *close),
            ("plateaus", 256, *flat), ("many_maxima", SR, *jitter),
            ("many_peaks", SR, *swings), ("vulpine", v_rate, *vulpine),
            ("fleet", SR, *metrics_fleet_rows(4, cap, SR, seed))]


def rolling_quantile_cases(n: int, rows: int, seed: int = 0) -> list:
    """(name, x, window, qs, min_periods) cases of the rolling-quantile
    kernel: ``rows`` float64 rows of length ``n`` (cast by the caller) with
    a window, the quantiles to take and ``min_periods``.  NaN prefix, suffix
    and interior runs; -0.0 and +0.0 ties (a float tie broken by position,
    not by the sortable key); all-equal rows; valid +-inf beside NaN; heavy
    ties in an odd window; a window of the whole row and more (on rows of
    up to 20,000, as the sorted-window reference's cost grows with n times
    the window); the widest window whose tiles are sorted in shared memory
    and one sample wider (sorted in global scratch); the default window of
    a 384 kHz recording (12,800 samples at 1,280 Hz); and trough
    interpolations with a NaN head and a masked tail, the exact floor's own
    input, at the floor's window."""
    from bpm_analysis_tpu_torch.ops.cuda import rolling_quantile_kernel

    rng = np.random.RandomState(seed)
    idx = np.arange(n)

    def smooth():
        return np.stack([np.abs(np.convolve(rng.randn(n + 30), np.ones(31) / 31, mode="valid"))
                         for _ in range(rows)]) + 0.05

    runs = smooth()
    for r in range(rows):
        runs[r, :rng.randint(1, max(2, n // 20))] = np.nan
        runs[r, n - rng.randint(1, max(2, n // 15)):] = np.nan
        for _ in range(3):
            a = rng.randint(0, n)
            runs[r, a:a + rng.randint(1, 4600)] = np.nan
    zeros = rng.choice([-0.0, 0.0, 0.0, -0.0, 1e-3, -1e-3, 2.0], size=(rows, n))
    equal = np.stack([np.full(n, (2.5, -0.0, -3.0)[r % 3]) for r in range(rows)])
    infs = rng.randn(rows, n) * 100
    infs[rng.rand(rows, n) < 0.05] = -np.inf
    infs[rng.rand(rows, n) < 0.05] = np.inf
    infs[rng.rand(rows, n) < 0.05] = np.nan
    ties = np.round(rng.randn(rows, n) * 3)
    widest = rolling_quantile_kernel.shared_window()
    edges = smooth()
    edges[:, :rng.randint(1, max(2, n // 10))] = np.nan
    troughs = np.empty((rows, n))
    for r in range(rows):
        knots = np.unique(np.concatenate([[0, n - 1], rng.randint(0, n, size=max(2, n // 150))]))
        troughs[r] = np.interp(idx, knots, np.abs(rng.randn(len(knots))) * 5 + 20)
        troughs[r, :knots[min(2, len(knots) - 1)]] = np.nan
        troughs[r, n - r * (n // 9):] = np.nan
    cases = [("nan_runs", runs, 3020, (0.2,), 3),
             ("signed_zeros", zeros, 3021, (0.0, 0.5), 1),
             ("all_equal", equal, 3020, (0.2,), 3),
             ("infinities", infs, 64, (0.0, 0.2, 1.0), 1),
             ("odd_window_ties", ties, 7, (0.5,), 3)]
    if n <= 20_000:
        cases.append(("window_ge_n", smooth(), n + 7, (0.2,), 3))
    cases += [("widest_shared", edges, widest, (0.2,), 3),
              ("past_shared", edges, widest + 1, (0.2,), 3),
              ("wide_window", runs, 12_800, (0.2,), 3),
              ("trough_interp", troughs, 3020, (0.0, 0.2, 1.0), 3)]
    return cases


def rolling_bound(x) -> float:
    """Least time of one rolling quantile of ``x`` (B, n): each sample read
    once and each output written once at HBM bandwidth, in ms."""
    return 2 * x.numel() * x.element_size() / PEAK_BYTES_S * 1e3


def same_values(got: torch.Tensor, exp: torch.Tensor) -> bool:
    """Bit for bit, NaN equal to NaN whatever its payload."""
    nan = torch.isnan(exp)
    if not torch.equal(torch.isnan(got), nan):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[exp.dtype]
    return torch.equal(got[~nan].view(ints), exp[~nan].view(ints))


def metrics_fields(m) -> dict:
    """``analytics.Metrics`` as {"group.field": tensor}."""
    out = {}
    for name, val in m._asdict().items():
        items = [(name, val)] if isinstance(val, torch.Tensor) else [
            (f"{name}.{f}", x) for f, x in val._asdict().items()]
        out.update(items)
    return out


def metrics_differ(got, exp) -> list:
    """The fields of two ``Metrics`` that are not bit for bit equal (NaN
    equal to NaN; integers and flags equal)."""
    g, e = metrics_fields(got), metrics_fields(exp)
    return [k for k in e if g[k].dtype != e[k].dtype or g[k].shape != e[k].shape
            or not (same_values(g[k], e[k]) if e[k].is_floating_point()
                    else torch.equal(g[k], e[k]))]


def metrics_max_abs_err(got, exp) -> float:
    """The largest absolute difference over the float fields of two
    ``Metrics``, where both are numbers."""
    g, e = metrics_fields(got), metrics_fields(exp)
    err = 0.0
    for k, x in e.items():
        if x.is_floating_point():
            ok = ~torch.isnan(x) & ~torch.isnan(g[k])
            if bool(ok.any()):
                err = max(err, float((g[k][ok].double() - x[ok].double()).abs().max()))
    return err


# An unbounded smoothing window (more than 128 slots, or not below the
# capacity): the kernel sums each window in slot order, the plain version
# differences a prefix sum, and their smoothed BPM differ by at most this
# share of the value.  The prefix sums reach ~2e5 BPM at a capacity of 1536
# (float32 ulp 0.016) and their rounding accumulates along the row, ~40
# ulps as a random walk: ~1e-4 of a ~40-beat window's sum.  Measured on the
# CPU at a capacity of 1536: 4.7e-5 in float32, 1.2e-13 in float64.
METRICS_UNBOUNDED_RTOL = {torch.float32: 5e-4, torch.float64: 2e-12}


def metrics_bound(bsz: int, cap: int, dtype) -> float:
    """Least time of the metrics kernel on (bsz, cap) positions, in ms: its
    bytes (positions and counts read, every output written once) at HBM
    bandwidth.  Its dependent chains (the smoothing windows, the greedy
    suppression walk, the prominence scans) are per block and overlap
    across blocks."""
    from bpm_analysis_tpu_torch.models import analytics
    from bpm_analysis_tpu_torch.ops.cuda import metrics_kernel as mk

    size = torch.finfo(dtype).bits // 8
    reals = (3 * cap + 4 * analytics.HRV_CAPACITY + 2 * len(mk.LIST_FIELDS) * mk.SLOPES
             + len(mk.SCALARS))
    nbytes = bsz * (4 * cap + 4 + size * reals + 4 * 4 + 3)
    return nbytes / PEAK_BYTES_S * 1e3


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


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card with the host's issue time
    hidden: the calls are queued behind a spin kernel
    (``torch.cuda._sleep``) and timed by CUDA events around them, so a
    call that the host issues slower than the card runs it is timed by the
    card.  Fails if the spin ended before the last call was queued."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    hidden = not start.query()
    torch.cuda.synchronize()
    check(hidden, "the spin ended before the timed calls were queued")
    return start.elapsed_time(end) / reps


def once_ms(fn) -> tuple:
    """(result, milliseconds on the card) of one call, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    """The library yardstick for the strided and the exact rolling
    quantile: ``torch.nanquantile`` over each row's unfolded windows (its
    input is capped at 2^24 elements, so one row, and at most 2^24 window
    elements, per call), NaN below ``min_periods``."""
    from bpm_analysis_tpu_torch.ops.rolling import centered_bounds

    left, right = centered_bounds(window)
    per = max(1, (1 << 24) // window)
    out = []
    for r in range(x.shape[0]):
        w = torch.nn.functional.pad(x[r:r + 1], (left, right),
                                    value=float("nan")).unfold(1, window, stride)[0]
        for c0 in range(0, w.shape[0], per):
            wc = w[c0:c0 + per]
            val = torch.nanquantile(wc, q, dim=-1)
            out.append(torch.where((~torch.isnan(wc)).sum(-1) >= min_periods, val,
                                   torch.full_like(val, float("nan"))))
    return torch.cat(out).reshape(x.shape[0], -1)


def scan_bound(x, want_trace: bool, clock_hz: float) -> tuple:
    """Least time for the classifier scan over ``x`` (a ``ScanInputs``):
    bytes (the slot inputs the kernel reads and the outputs it writes, once
    each) over HBM bandwidth, and the capacity times one step's dependent
    chain at the SM clock.  Returns (ms, 'bytes'|'operations')."""
    from bpm_analysis_tpu_torch.ops.cuda import classify_kernel

    bsz, cap = x.positions.shape
    t = x.deviation.element_size()
    per_slot = 4 + 5 * t + 1 + 4                       # inputs, peak_class
    if want_trace:
        per_slot += len(classify_kernel.KERNEL_FIELDS) * t + 4 + 1
    t_bytes = (bsz * cap * per_slot + bsz * (4 + t)) / PEAK_BYTES_S * 1e3
    step = max(alu * ALU_CYCLES + div * DIV_CYCLES for alu, div in CLASSIFY_CHAINS.values())
    t_ops = cap * step / clock_hz * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rhythm_longest_run(pos, amp, count, threshold, sr: int) -> int:
    """The longest run of dependent steps of the rhythm scan at these inputs
    (``RHYTHM_STEP_ALU``'s comment): a slot at least d* after the one before
    is one where the plain version's interval test fails, computed with its
    division."""
    cap = pos.shape[1]
    p = pos.long()
    active = torch.arange(1, cap, device=pos.device)[None, :] < count.long()[:, None]
    d = p[:, 1:] - p[:, :-1]
    sr_t = torch.tensor(sr, dtype=amp.dtype, device=amp.device)
    starts = (active & ~(d.to(amp.dtype) / sr_t < threshold[:, None])).cpu().numpy()
    sorted_rows = (~active | (d >= 0)).all(dim=1).cpu().numpy()
    longest = 0
    for b, cnt in enumerate(count.cpu().numpy()):
        cnt = max(int(cnt), 0)
        if not sorted_rows[b]:
            longest = max(longest, cnt)
        elif cnt > 0:
            edges = np.concatenate([[0], np.flatnonzero(starts[b]) + 1, [cnt]])
            longest = max(longest, int(np.diff(edges).max()))
    return longest


def rhythm_bound(pos, amp, count, threshold, sr: int, clock_hz: float) -> tuple:
    """Least time for the rhythm scan at these inputs: positions and
    amplitudes read and written / victim written once, or the dependent
    chain (``RHYTHM_STEP_ALU``'s comment).  Returns (ms, 'bytes'|'operations',
    longest run, the dividing scan's chain in ms)."""
    bsz, cap = pos.shape
    t_bytes = bsz * (cap * (4 + amp.element_size() + 1 + 4) + 4 + amp.element_size()) \
        / PEAK_BYTES_S * 1e3
    run = rhythm_longest_run(pos, amp, count, threshold, sr)
    t_ops = (DIV_CYCLES + run * RHYTHM_STEP_ALU * ALU_CYCLES) / clock_hz * 1e3
    alu, div = RHYTHM_DIVIDING_STEP
    dividing = cap * (alu * ALU_CYCLES + div * DIV_CYCLES) / clock_hz * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", run, dividing
    return t_ops, "operations", run, dividing


def trace_error(got, exp) -> float:
    """Max abs difference between two (peak_class, trace-or-None) results,
    over the classes and every trace field; inf where their NaNs differ."""
    pairs = [(got[0], exp[0])]
    if exp[1] is not None:
        pairs += list(zip(got[1], exp[1]))
    worst = 0.0
    for g, e in pairs:
        g, e = g.double(), e.double()
        if not torch.equal(torch.isnan(g), torch.isnan(e)):
            return float("inf")
        fin = ~torch.isnan(e)
        if fin.any():
            worst = max(worst, float((g[fin] - e[fin]).abs().max()))
    return worst


def rhythm_error(got, exp) -> float:
    """Max abs difference between two (written, victim) results."""
    return float(max((got[0].int() - exp[0].int()).abs().max(),
                     (got[1] - exp[1]).abs().max()))


def scan_input_cases(x, n):
    """The classifier scan's inputs as the path gave them, with rows 0-3 cut
    to 0, 1, 2 and 4 raw peaks, and cut to row 0's count (a row at full
    capacity)."""
    from bpm_analysis_tpu_torch.models.classifier import ScanInputs

    cases = [("path", x)]
    pos, count = x.positions.clone(), x.count.clone()
    for r, k in enumerate((0, 1, 2, 4)[:pos.shape[0]]):
        pos[r, k:] = n
        count[r] = k
    cases.append(("few_peaks", x._replace(positions=pos, count=count)))
    k = int(x.count[0])
    if k > 0:
        cut = {f: (v[:, :k].contiguous() if v.dim() == 2 else v)
               for f, v in x._asdict().items()}
        cut["count"] = torch.clamp(x.count, max=k)
        cases.append(("full_capacity", ScanInputs(**cut)))
    return cases


def rhythm_cases(pos, amp, count, threshold, n: int, sr: int) -> list:
    """(name, pos, amp, count, threshold, n) cases of the rhythm scan, built
    from one call's inputs on their device: the call as it is; cut to row
    0's count (a row at full capacity); "conflicts", every third beat with a
    neighbour 15 samples later, alternately louder (it replaces the beat)
    and quieter (dropped); and from that: rows cut to 0, 1, 2 and 4 slots;
    thresholds NaN, +inf, -1 and -inf; a threshold equal to f(d) = d / sr
    in the working type for a distance d in the row, and its two neighbours;
    unsorted rows (one reversed, pairs swapped, one at a negative
    threshold) beside sorted ones; one run over the whole row (each slot 10
    samples after the last, alternately louder and quieter); and rows of
    more than two of the kernel's tiles: one run through all of them, a
    tile that starts below the carried position, an unsorted tile, a count
    that ends inside a tile."""
    T = np.float32 if amp.dtype == torch.float32 else np.float64
    P, A, C, TH = (t.cpu().numpy() for t in (pos, amp, count, threshold))
    bsz, cap = P.shape
    rows = np.arange(bsz)
    cases = [("pipeline", P, A, C, TH, n)]
    k = max(int(C[0]), 1)
    cases.append(("full_capacity", P[:, :k], A[:, :k], np.minimum(C, k), TH, n))

    def with_neighbours(p_row, a_row, c, width):
        extra = np.arange(0, c, 3)
        p = np.concatenate([p_row[:c], p_row[extra] + 15])
        a = np.concatenate([a_row[:c], a_row[extra] * np.where(extra % 2 == 0, T(1.25),
                                                               T(0.8))])
        order = np.argsort(p, kind="stable")[:width]
        return p[order], a[order]

    P2, A2, C2 = np.full_like(P, n), np.zeros_like(A), np.zeros_like(C)
    for b in rows:
        p, a = with_neighbours(P[b], A[b], int(C[b]), cap)
        P2[b, :len(p)], A2[b, :len(p)], C2[b] = p, a, len(p)
    cases.append(("conflicts", P2, A2, C2, TH, n))
    P3, C3 = P2.copy(), C2.copy()
    for r, k in enumerate((0, 1, 2, 4)[:bsz]):
        P3[r, k:] = n
        C3[r] = k
    cases.append(("few_slots", P3, A2, C3, TH, n))
    edges = np.array([np.nan, np.inf, -1.0, -np.inf], T)
    cases.append(("edge_thresholds", P2, A2, C2, edges[rows % 4], n))
    d = np.where((rows % 2 == 0) | (C2 < 4), 15, P2[:, 3] - P2[:, 2])
    f = d.astype(T) / T(sr)
    for name, th in (("at_f(d)", f), ("below_f(d)", np.nextafter(f, T(-np.inf))),
                     ("above_f(d)", np.nextafter(f, T(np.inf)))):
        cases.append((name, P2, A2, C2, th, n))

    def swap_pairs(p_row, a_row, first, stop, step):
        for i in range(first, stop - 1, step):
            p_row[[i, i + 1]], a_row[[i, i + 1]] = p_row[[i + 1, i]], a_row[[i + 1, i]]

    P4, A4, TH4 = P2.copy(), A2.copy(), TH.copy()
    c0 = int(C2[0])
    P4[0, :c0], A4[0, :c0] = P2[0, :c0][::-1], A2[0, :c0][::-1]
    for b in rows[1:3]:
        swap_pairs(P4[b], A4[b], 1, int(C2[b]), 5)
    if bsz > 2:
        TH4[2] = T(-0.05)        # a slot 16 or more samples behind the last kept conflicts
    cases.append(("unsorted", P4, A4, C2, TH4, n))

    def alternating(m):
        i = np.arange(m)
        return np.where(i % 2 == 0, 1 + i * 1e-3, 0.5).astype(T)

    P5, A5, C5, TH5 = P2.copy(), A2.copy(), C2.copy(), TH.copy()
    P5[0], A5[0], C5[0], TH5[0] = 5 + 10 * np.arange(cap), alternating(cap), cap, T(0.28)
    cases.append(("one_run", P5, A5, C5, TH5, max(n, 5 + 10 * cap)))

    rng = np.random.RandomState(11)
    tcap = 2 * RHYTHM_TILE + 613
    beats = np.cumsum(rng.randint(180, 240, size=tcap))
    amps = rng.uniform(0.5, 1.5, size=tcap).astype(T)
    p1, a1 = with_neighbours(beats, amps, tcap, tcap)
    P6 = np.stack([10 * np.arange(tcap), p1, p1, p1])
    A6 = np.stack([alternating(tcap), a1, a1, a1])
    swap_pairs(P6[3], A6[3], 3, 600, 7)          # row 3: an unsorted first tile
    P6[2, RHYTHM_TILE:] -= 400                   # tile 1 starts below the carry
    C6 = np.array([tcap, tcap, tcap, 3000])
    TH6 = np.full(4, 0.28, T)
    cases.append(("tiles", P6, A6, C6, TH6, int(P6.max()) + 1))

    def on_device(p, a, c, th):
        return (torch.as_tensor(np.ascontiguousarray(p), dtype=torch.int32, device=pos.device),
                torch.as_tensor(np.ascontiguousarray(a, dtype=T), device=pos.device),
                torch.as_tensor(np.asarray(c), dtype=torch.int32, device=pos.device),
                torch.as_tensor(np.asarray(th, dtype=T), device=pos.device))

    assert tuple(c[0] for c in cases) == RHYTHM_CASES
    return [(name, *on_device(p, a, c, th), int(nn)) for name, p, a, c, th, nn in cases]


def scan_config(dtype: str, kickstart: bool):
    """The card tests' small configuration (512 raw-peak slots)."""
    from bpm_analysis_tpu_torch.config import AnalyzerConfig, CompatConfig, RuntimeConfig

    return AnalyzerConfig(
        runtime=RuntimeConfig(max_raw_peaks=512, max_troughs=512, max_candidates=256,
                              extrema_capacity=4096, noise_quantile_stride=64,
                              quantile_backend="auto", dtype=dtype),
        compat=CompatConfig(kickstart_effective=kickstart))


def scan_calls(batch, cfg) -> tuple:
    """Drive the main path on the card once and return the arguments of its
    (``classifier.classify_scan`` calls, ``corrections.rhythm_scan`` calls),
    each of which launched its kernel."""
    from bpm_analysis_tpu_torch.models import classifier, corrections

    c_calls, r_calls = [], []
    counted_run(batch, cfg, {(classifier, "classify_scan"): c_calls,
                             (corrections, "rhythm_scan"): r_calls})
    return c_calls, r_calls


def check_scan_cases(dev) -> tuple:
    """Both scan kernels against their plain versions on the card, on 4
    one-minute recordings, in float32 and float64: the classifier on the cut
    cases of ``scan_input_cases``, kick-start off and on, with and without
    the trace; the rhythm scan on ``rhythm_cases`` of the path's call.
    Returns the worst (classify, rhythm) max abs error."""
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.models import classifier, corrections
    from bpm_analysis_tpu_torch.ops.cuda import rhythm_kernel

    batch = np.stack([synth._quantize_int16(synth.synth_recording(s)[:SR * 60])
                      for s in range(4)]).astype(np.float32)
    worst_c = worst_r = 0.0
    for dtype in ("float32", "float64"):
        for kickstart in (False, True):
            cfg = scan_config(dtype, kickstart)
            c_calls, r_calls = scan_calls(batch.astype(dtype), cfg)
            (x, n, sr, _), _ = c_calls[-1]
            for name, xc in scan_input_cases(x, n):
                for want_trace in (False, True):
                    got = classifier.classify_scan(xc, n, sr, cfg, want_trace=want_trace)
                    exp = classifier.scan_plain(xc, sr, cfg, want_trace=want_trace)
                    torch.cuda.synchronize()
                    err = trace_error(got, exp)
                    worst_c = max(worst_c, err)
                    check(err == 0, f"classify kernel differs from its plain version on "
                                    f"{name} ({dtype}, kickstart {kickstart}, trace "
                                    f"{want_trace}): max abs err {err}")
            log(f"  classify kernel vs plain [{dtype}, kickstart {kickstart}]: "
                f"{[c[0] for c in scan_input_cases(x, n)]} x trace on/off, max abs err "
                f"{worst_c}")
        (pos, amp, count, threshold, n, sr), _ = r_calls[-1]
        cases = rhythm_cases(pos, amp, count, threshold, n, sr)
        for name, *args in cases:
            got = rhythm_kernel.rhythm_scan(*args, sr)
            exp = corrections.rhythm_scan_plain(*args[:4], sr)
            torch.cuda.synchronize()
            err = rhythm_error(got, exp)
            worst_r = max(worst_r, err)
            check(err == 0, f"rhythm kernel differs from its plain version on {name} "
                            f"({dtype}): max abs err {err}")
        log(f"  rhythm kernel vs plain [{dtype}]: {[c[0] for c in cases]}, written and "
            f"victim max abs err {worst_r}")
    return worst_c, worst_r


def filter_bound(x, L: int, m: int, clock_hz: float) -> tuple:
    """Least time for the blocked filter of ``x`` (B, n): the row read and
    written once over HBM bandwidth, and the larger of its unfused
    operations (block contributions, the carry scan, each output's carry-in
    product and in-block Toeplitz sum) over the float32 peak and a row's
    carry-scan chain (nb steps of m + 1 dependent operations) at the SM
    clock.  Returns (ms, 'bytes'|'operations')."""
    bsz, n = x.shape
    nb = -(-n // L)
    pos = np.arange(n) % L                       # each output's lag count
    ops_row = (nb * (L * m + (L - 1) * m)        # C = X @ U
               + nb * (m * m + (m - 1) * m + m)  # the carry scan
               + n * (1 + m + (m - 1) + 2)       # b0 x, S0 @ G^T, two adds
               + 2 * int(pos.sum()))             # the Toeplitz lags
    t_ops = max(bsz * ops_row / PEAK_F32_FLOPS, nb * (m + 1) * ALU_CYCLES / clock_hz) * 1e3
    t_bytes = (2 * x.numel() + bsz * m) * x.element_size() / PEAK_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def filter_cases():
    """(name, b, a, x, zi) for the blocked filter kernel: rows shorter than
    one block, a ragged last block, band-pass orders 1-3 (2-6 states), both
    dtypes, phase 4's batch length and one long row."""
    from bpm_analysis_tpu_torch.ops import filter as filt

    rng = np.random.RandomState(23)
    cases = []
    for name, order, shape, dtype in (("short_rows", 2, (3, 5), np.float32),
                                      ("ragged_block", 2, (4, 1000), np.float32),
                                      ("order_1", 1, (2, 3000), np.float32),
                                      ("order_3_f64", 3, (2, 3000), np.float64),
                                      ("float64", 2, (4, 5000), np.float64),
                                      ("engine_length", 2, (BATCH, 181230), np.float32),
                                      ("long_row", 2, (1, FILTER_LONG_ROW), np.float32)):
        b, a = filt.butter_bandpass(order, 20.0, 150.0, SR)
        x = (rng.randn(*shape) * 500).astype(dtype)
        zi = filt.lfilter_zi(b, a)[None, :] * x[:, :1]
        cases.append((name, b, a, x, np.ascontiguousarray(zi.astype(dtype))))
    return cases


def filter_phase_errors(b, a, x: torch.Tensor, zi: torch.Tensor) -> dict:
    """Max abs error of each phase entry point (``ops/filter.contributions`` /
    ``carry_scan`` / ``apply``, on the card the filter kernel's) against its
    ``BlockFilter`` piece on the same inputs, on ``x``'s device; inf where
    they are not equal bit for bit."""
    from bpm_analysis_tpu_torch.ops import filter as filt

    bsz, n = x.shape
    L = min(256, max(8, n))
    nb = -(-n // L)
    bf = filt.BlockFilter.build(b, a, L, x.dtype, x.device)
    X = torch.nn.functional.pad(x, (0, nb * L - n)).reshape(bsz, nb, L).contiguous()
    C = bf.contributions(X)
    s_exit, S0 = bf.carry_scan(C, zi)
    pairs = {"contributions": (filt.contributions(bf, X), C)}
    s_got, S0_got = filt.carry_scan(bf, C, zi)
    pairs["carry_scan"] = (torch.stack([s_got, S0_got[:, -1]]), torch.stack([s_exit, S0[:, -1]]))
    pairs["carry_ins"] = (S0_got, S0)
    pairs["apply"] = (filt.apply(bf, X, S0), bf.apply(X, S0))
    torch.cuda.synchronize()
    return {name: (float((g - e).abs().max()) if torch.equal(g, e) else float("inf"))
            for name, (g, e) in pairs.items()}


def check_filter_cases(dev) -> float:
    """The blocked filter kernel and each of its phase entry points against
    the plain version on the card: equal bit for bit.  Returns the max abs
    error (0)."""
    from bpm_analysis_tpu_torch.ops import filter as filt

    worst = 0.0
    for name, b, a, x, zi in filter_cases():
        xt, zt = torch.from_numpy(x).to(dev), torch.from_numpy(zi).to(dev)
        got = filt.lfilter(b, a, xt, zt)
        exp = filt.lfilter_plain(b, a, xt, zt)
        torch.cuda.synchronize()
        err = float((got - exp).abs().max())
        worst = max(worst, err)
        phases = filter_phase_errors(b, a, xt, zt)
        worst = max(worst, *phases.values())
        log(f"  filter kernel vs plain [{name}] {x.shape} {x.dtype}: max abs err {err}; "
            f"phase entry points {phases}")
        check(torch.equal(got, exp), f"filter kernel differs from its plain version on {name}")
        check(all(v == 0 for v in phases.values()),
              f"a filter phase entry point differs from its BlockFilter piece on {name}: "
              f"{phases}")
    return worst


# The kernel libraries, by the names their launches are counted under
# (``kernels/build.launches``); the block filter's phase entry points are
# counted apart, under FILTER_PHASES.
KERNELS = ("knot_quantile", "strided_quantile", "row_quantile", "rolling_quantile",
           "classify_scan", "rhythm_scan", "block_filter", "metrics")
FILTER_PHASES = ("block_filter_contributions", "block_filter_carry", "block_filter_apply")


def reset_launches():
    from bpm_analysis_tpu_torch.kernels import build

    build.reset_launches()


def read_launches(names=KERNELS) -> dict:
    from bpm_analysis_tpu_torch.kernels import build

    return {name: build.launches[name] for name in names}


# Launches of one batch through preprocess and analyze_batch: the filtfilt's
# two passes, two classifier passes, one rhythm correction, the noise
# floor's quantile kernel twice (the knot or strided kernel at stride 64, the
# rolling-quantile kernel at stride 1: draft and final floor), and the row
# quantile four times (three global quantiles of the noise floor, the raw
# peaks' prominence), and the metrics stage once.
PER_BATCH = {"classify_scan": 2, "rhythm_scan": 1, "row_quantile": 4, "metrics": 1}
AUTO_LAUNCHES = {"knot_quantile": 2, "strided_quantile": 0, "rolling_quantile": 0,
                 **PER_BATCH, "block_filter": 2}
PALLAS_LAUNCHES = {"knot_quantile": 0, "strided_quantile": 2, "rolling_quantile": 0,
                   **PER_BATCH, "block_filter": 2}
EXACT_LAUNCHES = {"knot_quantile": 0, "strided_quantile": 0, "rolling_quantile": 2,
                  **PER_BATCH, "block_filter": 2}


def run_main_path(batch_np, cfg, device):
    from bpm_analysis_tpu_torch.models import envelope as envm, pipeline

    env = envm.preprocess(batch_np, SR, cfg, device=device)[0]
    return pipeline.analyze_batch(env, SR, cfg, device=device)


def stage_spans(batch_np, cfg) -> str:
    """The main path's batch in one ``utils/profiling.device_trace``
    capture, as a table of the program's ``bpm.*`` spans: count, host ms,
    device ms (by correlation id) and launches of each."""
    from bpm_analysis_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spans_") as tmp:
        with profiling.device_trace(tmp):
            run_main_path(batch_np, cfg, "cuda")
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            table = profiling.stage_table(json.load(f)["traceEvents"])
    return "; ".join(f"{name} {r['spans']}x host {r['host_ms']:.1f} ms device "
                     f"{r['device_ms']:.1f} ms {r['launches']} launches"
                     for name, r in table.items())


def build_all() -> dict:
    """Build every kernel library at once (one nvcc per source, started
    together); returns each build's seconds."""
    from bpm_analysis_tpu_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        build.load(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(timed, KERNELS)))


def check_metrics_cases(dev) -> None:
    """The metrics kernel against its plain version on the card, every field
    bit for bit, on ``metrics_cases`` at the fleet's and native-44k's
    capacities in float32 and float64, one launch a call."""
    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.kernels import build
    from bpm_analysis_tpu_torch.models import analytics

    cfg = AnalyzerConfig()
    for cap in (1536, 3072):
        for name, sr, pos, cnt in metrics_cases(cap):
            p, c = torch.from_numpy(pos).to(dev), torch.from_numpy(cnt).to(dev)
            for dtype in (torch.float32, torch.float64):
                before = build.launches["metrics"]
                got = analytics.compute_metrics(p, c, sr, cfg, dtype)
                check(build.launches["metrics"] == before + 1,
                      f"metrics case {name}: {build.launches['metrics'] - before} launches")
                bad = metrics_differ(got, analytics.compute_metrics_plain(p, c, sr, cfg, dtype))
                check(not bad, f"metrics kernel differs from its plain version on {name} "
                               f"(cap {cap}, {dtype}): {bad}")
    log(f"  metrics kernel vs plain: {len(metrics_cases(1536))} cases at caps 1536 and 3072, "
        f"float32 and float64: every field equal, one launch a call")


def time_metrics(card, calls) -> dict:
    """The metrics kernel against its plain version on the main path's own
    call, then timed at the fleet cell's shape (512 rows of cap 1536,
    float32) beside its bytes bound and the plain version."""
    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import analytics

    err = 0.0
    for a, k in calls:
        got, exp = analytics.compute_metrics(*a, **k), analytics.compute_metrics_plain(*a, **k)
        bad = metrics_differ(got, exp)
        check(not bad, f"metrics kernel differs from its plain version on the main path: {bad}")
        err = max(err, metrics_max_abs_err(got, exp))
    cfg = AnalyzerConfig(runtime=engine_config().runtime)
    pos, cnt = metrics_fleet_rows(512, 1536, SR, seed=1)
    p, c = torch.from_numpy(pos).cuda(), torch.from_numpy(cnt).cuda()
    got = analytics.compute_metrics(p, c, SR, cfg, torch.float32)
    exp = analytics.compute_metrics_plain(p, c, SR, cfg, torch.float32)
    bad = metrics_differ(got, exp)
    check(not bad, f"metrics kernel differs from its plain version at (512, 1536): {bad}")
    err = max(err, metrics_max_abs_err(got, exp))
    m_ms = device_ms(lambda: analytics.compute_metrics(p, c, SR, cfg, torch.float32), 20)
    m_paced = cuda_ms(lambda: analytics.compute_metrics(p, c, SR, cfg, torch.float32), 20)
    m_plain = cuda_ms(lambda: analytics.compute_metrics_plain(p, c, SR, cfg, torch.float32), 2)
    m_bound = metrics_bound(512, 1536, torch.float32)
    log(f"metrics kernel at the fleet shape (512, 1536) float32: every field equal (max abs "
        f"err {err}); "
        f"{m_ms:.4f} ms queued ({m_paced:.4f} ms a call issued back to back), bound "
        f"{m_bound:.5f} ms by bytes ({100 * m_bound / m_ms:.1f}% of it), plain "
        f"{m_plain:.1f} ms, on {card}")
    return {"name": "metrics", "route": "cuda",
            "source": "bpm_analysis_tpu_torch/csrc/metrics.cu",
            "replaces": "bpm_analysis_tpu/models/analytics.py compute_metrics",
            "max_abs_err": err, "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
            "bound_by": "bytes", "library_ms": None}


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
    from bpm_analysis_tpu_torch.ops import quantile
    from bpm_analysis_tpu_torch.ops.cuda import quantile_kernel

    worst_err = 0.0
    for name, x, window, stride, q, mp in strided_kernel_cases():
        xt = torch.from_numpy(x).to(dev)
        got = quantile_kernel.strided_quantile_anchors(xt, window, q, mp, stride)
        exp = quantile.strided_quantile_anchors_f32_plain(xt, window, q, mp, stride)
        torch.cuda.synchronize()
        err, rel, ok = compare(got, exp, rtol=STRIDED_RTOL, atol=0.0)
        worst_err = max(worst_err, err)
        log(f"  strided kernel vs plain [{name}] {tuple(x.shape)} -> {tuple(got.shape)}: "
            f"max abs err {err:.3g}, max rel err {rel:.3g}")
        check(ok, f"strided kernel disagrees with its plain version on {name}")
    return worst_err


def check_row_quantile_cases(dev) -> None:
    """The row-quantile kernel against its plain version, bit for bit, on
    every case at q = 0, 0.1, 0.5 and 1, in both dtypes: three ragged rows
    of 7 (one block each) and each of three rows of the serial cell's
    envelope length alone (a cluster shares the row)."""
    from bpm_analysis_tpu_torch.ops import quantile
    from bpm_analysis_tpu_torch.ops.cuda import row_quantile_kernel

    for n, rows in ((7, (slice(0, 3),)), (229_825, (slice(0, 1), slice(1, 2), slice(2, 3)))):
        for dtype in (torch.float32, torch.float64):
            for name, x, valid in row_quantile_cases(n):
                xt = torch.from_numpy(x).to(dev, dtype)
                vt = None if valid is None else torch.from_numpy(valid).to(dev)
                for r in rows:
                    xb, vb = xt[r].contiguous(), None if vt is None else vt[r].contiguous()
                    for q in ROW_QUANTILE_QS:
                        got = row_quantile_kernel.quantile_exact(xb, q, vb)
                        exp = quantile.quantile_exact_plain(xb, q, vb)
                        check(same_values(got, exp),
                              f"row-quantile kernel differs from its plain version on {name} "
                              f"{tuple(xb.shape)} {dtype} q={q}: {got} vs {exp}")
    log(f"  row-quantile kernel vs plain: every case equal at (3, 7) and (1, 229825), "
        f"float32 and float64 (split at B=1: {row_quantile_kernel.split(1)} blocks a row)")


ROLLING_SHAPES = ((3, 1000), (2, 20_000), (4, 181_200), (1, 229_825))


def check_rolling_quantile_cases(dev) -> float:
    """The rolling-quantile kernel against its plain version, bit for bit,
    on every case at each of its quantiles, in both dtypes, at three short
    rows (one tile), two rows of 20,000 (a whole-row window sorted in global
    scratch), four rows of the exact cell's width and the serial cell's
    envelope alone; one launch a call.  Returns the worst absolute
    error."""
    from bpm_analysis_tpu_torch.kernels import build
    from bpm_analysis_tpu_torch.ops import quantile
    from bpm_analysis_tpu_torch.ops.cuda import rolling_quantile_kernel

    worst = 0.0
    for bsz, n in ROLLING_SHAPES:
        for dtype in (torch.float32, torch.float64):
            for name, x, window, qs, mp in rolling_quantile_cases(n, bsz):
                xt = torch.from_numpy(x).to(dev, dtype)
                for q in qs:
                    before = build.launches["rolling_quantile"]
                    got = rolling_quantile_kernel.rolling_quantile_centered(xt, window, q, mp)
                    exp = quantile.rolling_quantile_centered_plain(xt, window, q, mp)
                    check(build.launches["rolling_quantile"] == before + 1,
                          f"rolling-quantile kernel: {name} launched "
                          f"{build.launches['rolling_quantile'] - before}, expected 1")
                    worst = max(worst, float((got - exp).abs().nan_to_num(0.0).max()))
                    check(same_values(got, exp),
                          f"rolling-quantile kernel differs from its plain version on {name} "
                          f"{tuple(xt.shape)} {dtype} window {window} q={q}")
    log(f"  rolling-quantile kernel vs plain: every case equal at {ROLLING_SHAPES}, float32 "
        f"and float64; windows up to {rolling_quantile_kernel.shared_window()} in shared "
        f"memory, wider ones in global scratch")
    return worst


def time_rolling_quantile(card, batch, err: float) -> dict:
    """The exact floor's kernel on phase 4's recordings in float64 at
    stride 1 (the ``exact-f64`` cell's configuration): launch counts, the
    draft and final floors' calls against the plain version, then the
    final floor's input tiled to the cell's (256, 181,200) float64, a
    float32 row of the serial cell's envelope length (the default
    configuration's B=1) and a float32 row of a ten-minute 384 kHz
    recording's envelope (768,000 samples at 1,280 Hz) at its default
    window of 12,800 (sorted in global scratch), each timed beside its
    bound and the plain version, and the float32 rows beside
    ``torch.nanquantile`` over unfolded windows.  Returns the kernel
    table's row."""
    from bpm_analysis_tpu_torch.ops import quantile
    from bpm_analysis_tpu_torch.ops.cuda import rolling_quantile_kernel

    cfg = engine_config()
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, noise_quantile_stride=1,
                                                  dtype="float64"))
    captured = []
    _, launches = counted_run(batch.astype(np.float64), cfg, {
        (rolling_quantile_kernel, "rolling_quantile_centered"): captured})
    log(f"kernel launches on the exact path (stride 1, float64): {launches}")
    check(launches == EXACT_LAUNCHES, f"expected {EXACT_LAUNCHES}, got {launches}")
    kernel = rolling_quantile_kernel.rolling_quantile_centered
    plain = quantile.rolling_quantile_centered_plain
    for label, (a, k) in zip(("draft floor", "final floor"), captured):
        check(same_values(kernel(*a, **k), plain(*a, **k)),
              f"rolling-quantile kernel differs from its plain version on the {label}")
    (x16, window, q, mp), _ = captured[-1]
    shapes = {}
    rows32 = x16.reshape(-1).to(torch.float32)
    for label, x, w in (
            ("exact cell", x16.repeat(-(-256 // x16.shape[0]), 1)[:256].contiguous(), window),
            ("B=1", rows32[None, :229_825].contiguous(), window),
            ("384 kHz", rows32[None, :768_000].contiguous(), 12_800)):
        got = kernel(x, w, q, mp)
        exp = plain(x, w, q, mp)
        check(same_values(got, exp),
              f"rolling-quantile kernel differs from its plain version at {tuple(x.shape)}")
        ms = cuda_ms(lambda: kernel(x, w, q, mp), 10)
        plain_ms = cuda_ms(lambda: plain(x, w, q, mp), 1)
        library_ms = None
        if x.dtype == torch.float32:
            library_ms = cuda_ms(lambda: nanquantile_rows(x, w, q, mp, 1), 1)
        bound_ms = rolling_bound(x)
        plan = rolling_quantile_kernel.tile_plan(
            w, x.shape[0], x.shape[1],
            torch.cuda.get_device_properties(0).multi_processor_count)
        shapes[label] = {"shape": list(x.shape), "dtype": str(x.dtype), "window": w,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "log_union_tile": list(plan)}
        library = "" if library_ms is None else f", torch.nanquantile {library_ms:.3f} ms"
        log(f"rolling-quantile kernel at {tuple(x.shape)} {x.dtype}, window {w}, q={q} "
            f"(union 2^{plan[0]}, tile {plan[1]}): {ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"bytes ({100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.3f} ms{library}, "
            f"equal, on {card}")
    cell = shapes["exact cell"]
    return {"name": "rolling_quantile", "route": "cuda",
            "source": "bpm_analysis_tpu_torch/csrc/rolling_quantile.cu",
            "replaces": "bpm_analysis_tpu/ops/quantile.py rolling_quantile_centered",
            "launches": launches["rolling_quantile"], "max_abs_err": err,
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "b1": shapes["B=1"],
            "wide_window": shapes["384 kHz"]}


def row_quantile_bound(x, valid) -> float:
    """Least time for one row quantile of ``x`` (B, n): each element, and
    its mask byte if there is a mask, read once at HBM bandwidth, in ms."""
    return x.numel() * (x.element_size() + (valid is not None)) / PEAK_BYTES_S * 1e3


def nanquantile_batch(x, q, valid):
    """The library yardstick for the row quantile: ``torch.nanquantile`` of
    each row with the invalid elements as NaN, in chunks of rows under its
    2^24-element input limit."""
    xm = x if valid is None else torch.where(valid, x, torch.full_like(x, float("nan")))
    rows = max(1, (1 << 24) // x.shape[1])
    return torch.cat([torch.nanquantile(xm[r:r + rows], q, dim=1)
                      for r in range(0, x.shape[0], rows)])


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
    from bpm_analysis_tpu_torch.accuracy import result_curves

    curves = result_curves(res, SR)
    gate_curves(curves, oracle, SEEDS, label)
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
        launches = read_launches()
        log(f"  vulpine, default config, prominence_backend={backend!r}, float64: "
            f"{seconds:.2f}s on {card}; {got}; launches {launches}")
        check(launches == {**EXACT_LAUNCHES, "block_filter": 0},
              f"{backend}: expected the float64 scan, rolling- and row-quantile kernels "
              f"only, got {launches}")
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


def native_config():
    """The JAX bench's sizing for its 44.1 kHz files (bench.py:606-610 via
    ``_bench_cfg``): 4096 raw peaks and troughs, 3072 candidates, work
    factor 8, prominence factor 2.0, 32768 extrema slots; stride 64,
    float32, "auto" as on the main path."""
    from bpm_analysis_tpu_torch.config import AnalyzerConfig, RuntimeConfig

    return AnalyzerConfig(runtime=RuntimeConfig(
        max_raw_peaks=4096, max_troughs=4096, max_candidates=3072,
        dtype="float32", noise_quantile_stride=64, quantile_backend="auto",
        find_peaks_work_factor=8, prominence_work_factor=2.0,
        prominence_residual_capacity=1024, raw_candidate_capacity=0,
        extrema_capacity=32768))


def normalized(path: str) -> list:
    """An artifact's lines without the generation-timestamp lines."""
    with open(path, "rb") as f:
        return [line for line in f.read().split(b"\n")
                if not line.startswith((b"*Generated on:", b"Analysis performed on:"))]


_AMP_LINE = re.compile(rb"^(- \*\*(?:Raw Amp|Noise Floor)\*\*: `)(-?[\d.]+)(`)$")


def artifacts_differ(a: str, b: str, suffix: str):
    """None when two artifacts meet the serial/batched contract of
    tests/test_host_batch.py (byte-equal without timestamps; the debug log's
    amplitude display lines may move by one 0.1 quantum), else a message."""
    la, lb = normalized(a), normalized(b)
    if la == lb:
        return None
    if suffix != "_Debug_Log.md" or len(la) != len(lb):
        diff = [i for i, (x, y) in enumerate(zip(la, lb)) if x != y]
        first = diff[0] if diff else min(len(la), len(lb))
        return (f"{suffix}: {len(la)} vs {len(lb)} lines, {len(diff)} differ, the first "
                f"at line {first + 1}: {la[first:first + 1]!r} vs {lb[first:first + 1]!r}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x == y:
            continue
        mx, my = _AMP_LINE.match(x), _AMP_LINE.match(y)
        if not (mx and my and mx.group(1) == my.group(1)
                and abs(float(mx.group(2)) - float(my.group(2))) <= 0.1001):
            return f"{suffix} line {i + 1}: {x!r} != {y!r}"
    return None


def host_curves(results, paths, rate):
    """Per-file (beat_times, bpm_times, bpm_values) of numpy result rows."""
    out = []
    for p in paths:
        r = results[p]
        k = int(r.metrics.bpm.count)
        out.append((r.final_positions[: int(r.final_count)] / rate,
                    r.metrics.bpm.times[:k], r.metrics.bpm.smoothed[:k]))
    return out


def gate_curves(curves, oracle, seeds, label):
    """The accuracy gates: worst beat F1 >= 0.99 and BPM MAE < 0.5 of each
    file's (beat_times, bpm_times, bpm_values) against its oracle."""
    from bpm_analysis_tpu_torch.accuracy import F1_FLOOR, MAE_CEIL, beat_f1, bpm_mae

    f1s, maes = [], []
    for s, (beats, times, values) in zip(seeds, curves):
        ref = oracle[str(s)]
        f1s.append(beat_f1(beats, ref["beat_times"]))
        maes.append(bpm_mae(ref["bpm_times"], ref["bpm_values"], times, values))
    log(f"{label} accuracy vs CPU reference over {len(seeds)} files: worst beat F1 "
        f"{min(f1s):.6f}, worst BPM MAE {max(maes):.6f}")
    check(min(f1s) >= F1_FLOOR, f"{label}: worst beat F1 {min(f1s)} < {F1_FLOOR}")
    check(max(maes) < MAE_CEIL, f"{label}: worst BPM MAE {max(maes)} >= {MAE_CEIL}")


def lanes_text(lanes: dict) -> str:
    return ", ".join(f"{k} {v:.3f}s" if k != "chunks" else f"chunks {int(v)}"
                     for k, v in sorted(lanes.items()))


def timed_dispatches(host_batch, renders: list, dispatches: list):
    """Wrap the batched front-end's per-chunk device call and the renderer
    so each call's (start, end) is recorded; returns the originals."""
    from bpm_analysis_tpu_torch import host

    saved = [(host_batch, "_analyze_padded_batch"), (host, "render_artifacts")]
    originals = [getattr(m, a) for m, a in saved]

    def wrap(fn, into):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                into.append((t0, time.perf_counter()))
        return wrapper

    host_batch._analyze_padded_batch = wrap(originals[0], dispatches)
    host.render_artifacts = wrap(originals[1], renders)
    return saved, originals


def check_host_path(card, cfg, batch_i16, res_mem, oracle, tmp):
    """Phase 9: the host path (files in, artifacts out) at full width."""
    from bpm_analysis_tpu_torch import host, host_batch, synth
    from bpm_analysis_tpu_torch.io import native, wav

    t_phase = time.perf_counter()
    check(native.available(), "the native WAV decoder did not build or load")
    paths = []
    for s in SEEDS:
        paths.append(os.path.join(tmp, "src", f"rec_{s:02d}.wav"))
        os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
        wav.write(paths[-1], SR, batch_i16[s])

    # Batched, one chunk of 16, every artifact.
    out_b = os.path.join(tmp, "batched")
    lanes = {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results, errors = host_batch.analyze_files_batched(paths, cfg, out_b, max_batch=BATCH,
                                                       lane_stats=lanes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(errors == [], f"batched host errors: {errors[:3]}")
    log(f"batched host, {BATCH} files in one chunk: kernel launches {launches}")
    check(launches == AUTO_LAUNCHES,
          f"expected {AUTO_LAUNCHES} launches on the host chunk, got {launches}")
    for p in paths:
        base = os.path.splitext(os.path.basename(p))[0]
        for suffix in ARTIFACTS:
            check(os.path.exists(os.path.join(out_b, base + suffix)), f"missing {base}{suffix}")
        check(results[p] is not None and not bool(results[p].overflowed),
              f"{base}: no result or overflow")
    mem_pos = res_mem.final_positions.cpu().numpy()
    mem_cnt = res_mem.final_count.cpu().numpy()
    differ = 0
    for s, p in zip(SEEDS, paths):
        got = results[p].final_positions[: int(results[p].final_count)]
        differ += len(np.setxor1d(got, mem_pos[s, : mem_cnt[s]]))
    log(f"  final positions differing from phase 4's in-memory run (n={batch_i16.shape[1]}; "
        f"the host pads to {host_batch.length_bucket(batch_i16.shape[1])} with n_valid): "
        f"{differ}")
    log(f"  wall {wall:.3f}s = {BATCH * synth.MINUTES / wall:.2f} audio-min/s on {card}; lanes: "
        f"{lanes_text(lanes)}")
    gate_curves(host_curves(results, paths, SR), oracle, SEEDS, "phase 9 batched host")

    # The same files in two chunks: chunk 2's dispatch runs beside chunk 1's
    # render on the fetch thread, chunk 1's beside no render.
    lanes2, renders, dispatches = {}, [], []
    saved, originals = timed_dispatches(host_batch, renders, dispatches)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results2, errors = host_batch.analyze_files_batched(
            paths, cfg, os.path.join(tmp, "batched8"), max_batch=BATCH // 2, lane_stats=lanes2)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        for (mod, attr), fn in zip(saved, originals):
            setattr(mod, attr, fn)
    half = BATCH // 2
    check(errors == [] and len(dispatches) == 2 and len(renders) == BATCH,
          f"two-chunk run: {errors[:3]}")
    (d1s, d1e), (d2s, d2e) = dispatches
    beside = sum(max(0.0, min(e, d2e) - max(s, d2s)) for s, e in renders)
    render1 = sum(e - s for s, e in renders[:half]) / half
    render2 = sum(e - s for s, e in renders[half:]) / half
    differ2 = sum(len(np.setxor1d(results[p].final_positions[: int(results[p].final_count)],
                                  results2[p].final_positions[: int(results2[p].final_count)]))
                  for p in paths)
    log(f"two chunks of {half}: wall {wall2:.3f}s = {BATCH * synth.MINUTES / wall2:.2f} "
        f"audio-min/s on {card}; dispatch chunk 1 {d1e - d1s:.3f}s (no render beside it), "
        f"chunk 2 {d2e - d2s:.3f}s ({beside:.3f}s of chunk 1's render ran beside it); render "
        f"per file {render1:.3f}s for chunk 1 (beside chunk 2's dispatch), {render2:.3f}s for "
        f"chunk 2 (alone); lanes: {lanes_text(lanes2)}; positions differing from the "
        f"one-chunk run: {differ2}")

    # Serial on recording 0, against the batched artifacts.
    out_s = os.path.join(tmp, "serial")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res_s = host.analyze_wav_file(paths[0], cfg, output_directory=out_s)
    torch.cuda.synchronize()
    log(f"serial host on recording 0: {time.perf_counter() - t0:.3f}s on {card}; "
        f"launches {read_launches()}")
    check(res_s is not None, "serial host: no result")
    got = res_s.final_positions[: int(res_s.final_count)]
    exp = results[paths[0]].final_positions[: int(results[paths[0]].final_count)]
    log(f"  serial vs batched final positions: {len(got)} vs {len(exp)} beats, "
        f"{len(np.setxor1d(got, exp))} differ")
    for suffix in ARTIFACTS:
        if suffix in ("_bpm_plot.html", "_filtered_debug.wav"):
            continue        # outside the contract, as in tests/test_host_batch.py
        msg = artifacts_differ(os.path.join(out_s, "rec_00" + suffix),
                               os.path.join(out_b, "rec_00" + suffix), suffix)
        check(msg is None, f"serial vs batched: {msg}")
    log("  serial artifacts equal the batched ones (CSV, summary, settings byte-equal; "
        "debug log within one amplitude quantum)")

    # Native rate: 44.1 kHz files decimated on the host by the strided decode.
    t0 = time.perf_counter()
    npaths = []
    for s in (0, 1):
        npaths.append(os.path.join(tmp, "src", f"native_{s}.wav"))
        wav.write(npaths[-1], synth.NATIVE_SR,
                  synth._quantize_int16(synth.synth_recording_native(s)))
    log(f"  wrote two {synth.MINUTES}-min {synth.NATIVE_SR} Hz WAVs "
        f"({os.path.getsize(npaths[0]) / 1e6:.1f} MB each) in {time.perf_counter() - t0:.2f}s")
    ncfg = native_config()
    lanes_n = {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    nres, errors = host_batch.analyze_files_batched(npaths, ncfg, os.path.join(tmp, "native"),
                                                    max_batch=2, render=False,
                                                    lane_stats=lanes_n)
    torch.cuda.synchronize()
    wall_n = time.perf_counter() - t0
    launches_n = read_launches()
    check(errors == [], f"native-rate errors: {errors[:3]}")
    check(launches_n == AUTO_LAUNCHES, f"native-rate launches {launches_n}")
    log(f"native rate, 2 files: wall {wall_n:.3f}s = {2 * synth.MINUTES / wall_n:.2f} "
        f"audio-min/s on {card}; "
        f"launches {launches_n}; lanes: {lanes_text(lanes_n)}")
    with open(os.path.join(REPO, "bench_cpu_native.json")) as f:
        native_oracle = json.load(f)["per_seed"]
    rate = host.post_rate(synth.NATIVE_SR, ncfg)
    gate_curves(host_curves(nres, npaths, rate), native_oracle, (0, 1), "phase 9 native rate")

    # The CLI on the vulpine signal, in a subprocess on the card.
    oracle_v = np.load(VULPINE)
    vwav = os.path.join(tmp, "src", "vulpine.wav")
    wav.write(vwav, int(oracle_v["sample_rate"]), oracle_v["raw_signal"].astype(np.int16))
    out_c = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bpm_analysis_tpu_torch.apps.cli", vwav,
                           "--pre-filtered", "--dtype", "float64", "--output-dir", out_c],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    log(f"CLI on vulpine: exit {proc.returncode} in {time.perf_counter() - t0:.2f}s: "
        f"{proc.stdout.strip()}")
    check(proc.returncode == 0, f"CLI failed: {proc.stderr[-2000:]}")
    check(": 734 beats," in proc.stdout, "the CLI did not report 734 beats")
    with open(os.path.join(out_c, "vulpine_bpm_plot.csv")) as f:
        rows = [tuple(line.strip().split(",")) for line in f.readlines()[1:]]
    want = [(f"{t:.3f}", f"{b:.3f}") for t, b in zip(oracle_v["bpm_times"],
                                                      oracle_v["smoothed_bpm"])
            if not np.isnan(b)]
    check(rows == want, f"CLI CSV: {len(rows)} rows, {len(want)} expected, "
                        f"{sum(a != b for a, b in zip(rows, want))} differ")
    log(f"  CLI CSV: {len(rows)} rows equal to the golden series at the CSV's precision")
    log(f"phase 9 host path: ok in {time.perf_counter() - t_phase:.1f}s")
    return paths, results, out_b


def synchronize() -> None:
    """Wait for the card in a rank body (a no-op where a body is rehearsed
    on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def dp_rank(batch, cfg):
    """Phase 10's dp rank: phase 4's batch, preprocessed whole on every rank
    (the replicated input of ``analyze_batch_sharded``), this rank's 4
    recordings analyzed on the shared card; a cold run, then a warm run with
    the launch counts set to 0 just before it and read just after, timed
    between barriers."""
    import torch.distributed as dist

    from bpm_analysis_tpu_torch.accuracy import result_curves
    from bpm_analysis_tpu_torch.models import envelope as envm
    from bpm_analysis_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh()

    def run():
        env = envm.preprocess(batch, SR, cfg, device=m.device)[0]
        return pmesh.analyze_batch_sharded(m, env, SR, cfg)

    t0 = time.perf_counter()
    run()
    synchronize()
    cold = time.perf_counter() - t0
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    local = run()
    synchronize()
    launches = read_launches()
    dist.barrier()
    wall = time.perf_counter() - t0
    full = pmesh.gather_result(m, local)
    out = {"device": str(m.device), "backend": m.backend, "cold": cold, "wall": wall,
           "launches": launches, "fleet": pmesh.fleet_summary(m, local)}
    if m.index == 0:
        out.update(final_count=full.final_count.cpu().numpy(),
                   final_positions=full.final_positions.cpu().numpy(),
                   overflowed=full.overflowed.cpu().numpy(),
                   curves=result_curves(full, SR))
    return out


def nccl_rank(result_np):
    """Phase 10's world of 1 on NCCL: ``fleet_summary`` of phase 4's result
    on the card."""
    from bpm_analysis_tpu_torch.host import tree_map
    from bpm_analysis_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh()
    res = tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(m.device), result_np)
    return {"backend": m.backend, "device": str(m.device),
            "fleet": pmesh.fleet_summary(m, res)}


def sp_rank(x, series):
    """Phase 10's sp rank: its quarter of the two-hour recording on the
    card, each sharded function run cold, then timed between barriers, with
    the filter kernel's phase launches counted over the timed filtfilt; then
    the filtfilt once more on ``BlockFilter``'s plain pieces (the relay
    before it ran on the kernel's phases).  Rank 0 returns the gathered
    series."""
    import torch.distributed as dist

    from bpm_analysis_tpu_torch.ops import filter as filt
    from bpm_analysis_tpu_torch.parallel import mesh as pmesh, seqshard

    m = pmesh.make_mesh(sp=SP_RANKS)
    xb = seqshard.shard_sequence(m, torch.from_numpy(x)).to(m.device)
    yb = seqshard.shard_sequence(m, torch.from_numpy(series)).to(m.device)
    runs = {
        "envelope": lambda: seqshard.sequence_sharded_envelope(m, xb, SR // 10),
        "quantile": lambda: seqshard.sequence_sharded_rolling_quantile(m, yb, **SP_QUANTILE),
        "filtfilt": lambda: seqshard.sequence_sharded_bandpass_filtfilt(m, xb, SR, 20.0,
                                                                        150.0),
    }
    out = {"device": str(m.device), "seconds": {}, "whole": {}}

    def timed(name, fn):
        fn()
        synchronize()
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        block = fn()
        synchronize()
        dist.barrier()
        out["seconds"][name] = time.perf_counter() - t0
        whole = seqshard.gather_sequence(m, block)
        if m.index == 0:
            out["whole"][name] = whole.cpu().numpy()

    for name, fn in runs.items():
        timed(name, fn)
        if name == "filtfilt":
            out["phase_launches"] = read_launches(FILTER_PHASES)
    real = {name: getattr(filt, name) for name in ("contributions", "carry_scan", "apply")}
    try:
        filt.contributions = lambda bf, X: bf.contributions(X)
        filt.carry_scan = lambda bf, C, s: bf.carry_scan(C, s)
        filt.apply = lambda bf, X, S0: bf.apply(X, S0)
        timed("filtfilt_plain_pieces", runs["filtfilt"])
    finally:
        for name, fn in real.items():
            setattr(filt, name, fn)
    return out


def host_rank(paths, cfg, output_dir):
    """Phase 10's host rank: ``analyze_files_batched(mesh=...)`` on its
    share, with the launch counts around it."""
    from bpm_analysis_tpu_torch import host_batch
    from bpm_analysis_tpu_torch.parallel import mesh as pmesh

    m = pmesh.make_mesh()
    lanes = {}
    reset_launches()
    t0 = time.perf_counter()
    results, errors = host_batch.analyze_files_batched(paths, cfg, output_dir,
                                                       max_batch=BATCH, mesh=m,
                                                       lane_stats=lanes)
    synchronize()
    return {"wall": time.perf_counter() - t0, "launches": read_launches(),
            "errors": errors, "lanes": lanes,
            "positions": {p: r.final_positions[:int(r.final_count)] for p, r in
                          results.items()},
            "rows": {p: r._replace(trace=None, classes=None, precorrection_classes=None)
                     for p, r in results.items()}}


def fleet_reference(res) -> dict:
    """The six reductions of ``fleet_summary`` over a whole batch on one
    device, in its dtype."""
    m = res.metrics
    ok, found = res.ok, m.hrr.found
    zero = torch.zeros((), dtype=m.avg_bpm.dtype, device=ok.device)
    n_ok = torch.clamp(ok.sum().to(zero.dtype), min=1)
    return {
        "recordings_ok": int(ok.sum()),
        "mean_avg_bpm": float(torch.where(ok, m.avg_bpm, zero).sum() / n_ok),
        "min_bpm": float(torch.where(ok, m.min_bpm, zero + float("inf")).amin()),
        "max_bpm": float(torch.where(ok, m.max_bpm, zero - float("inf")).amax()),
        "mean_hrr": float(torch.where(found, m.hrr.hrr, zero).sum()
                          / torch.clamp(found.sum().to(zero.dtype), min=1)),
        "total_beats": int(torch.where(ok, res.final_count.long(), 0).sum()),
    }


def check_fleet(got: dict, exp: dict, label: str) -> None:
    for key in ("recordings_ok", "total_beats"):
        check(got[key] == exp[key], f"{label}: {key} {got[key]} != {exp[key]}")
    for key in ("mean_avg_bpm", "min_bpm", "max_bpm", "mean_hrr"):
        check(np.isclose(got[key], exp[key], rtol=FLEET_RTOL, atol=0),
              f"{label}: {key} {got[key]} vs {exp[key]}")


def profiled_kernels(card, knot, strided, tmp) -> None:
    """Both kernels, 10 calls each at the paths' inputs, inside
    ``utils.profiling.device_trace``: their CUDA time per call from the
    trace beside the CUDA-event time."""
    from bpm_analysis_tpu_torch.utils import profiling

    reps = 10
    event_ms = {}
    with profiling.device_trace(os.path.join(tmp, "trace")) as prof:
        for name, (fn, (a, k)) in (("knot_quantile", knot), ("strided_quantile", strided)):
            event_ms[name] = cuda_ms(lambda: fn(*a, **k), reps)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0 and "quantile_kernel" in e.key:
            rows.append((e.key, e.count, us / 1e3 / e.count))
    for name in event_ms:
        hits = [r for r in rows if f"{name}_kernel" in r[0]]
        if hits:
            key, n, ms = hits[0]
            log(f"  profiler: {key[:70]}: {n} launches, {ms:.4f} ms each from the trace; "
                f"{event_ms[name]:.4f} ms by CUDA events, on {card}")
        else:
            log(f"  profiler: no device time for {name} in the trace (CUDA events: "
                f"{event_ms[name]:.4f} ms)")
    size = os.path.getsize(os.path.join(tmp, "trace", "trace.json"))
    log(f"  profiler: Chrome trace of {size} bytes; kernels with device time: "
        f"{[r[0][:40] for r in rows]}")


def check_scale_out(card, cfg, batch, res, best, oracle, host_run, knot, strided, tmp):
    """Phase 10: scale-out on the one card; returns B1's launches per dp
    rank."""
    from bpm_analysis_tpu_torch import host, host_batch, synth
    from bpm_analysis_tpu_torch.accuracy import beat_f1
    from bpm_analysis_tpu_torch.ops import filter as filt, quantile as quant, rolling
    from bpm_analysis_tpu_torch.parallel import mesh as pmesh, seqshard

    t_phase = time.perf_counter()
    log(f"phase 10 scale-out: {os.cpu_count()} CPU cores on the host")

    # dp: 4 gloo ranks share the card, 4 recordings each.
    t0 = time.perf_counter()
    ranks = pmesh.spawn(dp_rank, DP_RANKS, "gloo", "cuda", batch, cfg)
    r0 = ranks[0]
    dp_launches = [r["launches"]["knot_quantile"] for r in ranks]
    log(f"dp: {DP_RANKS} ranks on {[r['device'] for r in ranks]} ({r0['backend']}), "
        f"{time.perf_counter() - t0:.1f}s with startup; cold {max(r['cold'] for r in ranks):.3f}s, "
        f"warm wall {r0['wall']:.3f}s = {BATCH * synth.MINUTES / r0['wall']:.2f} audio-min/s "
        f"(phase 4, one process: {best:.3f}s = {BATCH * synth.MINUTES / best:.2f}) on {card}; "
        f"launches per rank {[r['launches'] for r in ranks]}")
    check(all(r["launches"] == AUTO_LAUNCHES for r in ranks),
          f"dp: expected {AUTO_LAUNCHES} per rank, got {[r['launches'] for r in ranks]}")
    exp_count = res.final_count.cpu().numpy()
    exp_pos = res.final_positions.cpu().numpy()
    differ = int((r0["final_positions"] != exp_pos).sum())
    log(f"  gathered final counts equal phase 4's: {np.array_equal(r0['final_count'], exp_count)}; "
        f"final-position slots differing: {differ}; overflowed {int(r0['overflowed'].sum())}")
    check(np.array_equal(r0["final_count"], exp_count) and differ == 0,
          "dp: the gathered beats differ from phase 4's unsharded run")
    fleet_exp = fleet_reference(res)
    log(f"  fleet_summary (gloo, 4 ranks): {r0['fleet']}; one device: {fleet_exp}")
    for r in ranks:
        check_fleet(r["fleet"], fleet_exp, "dp fleet_summary")
    gate_curves(r0["curves"], oracle, SEEDS, "phase 10 dp")

    # A world of 1 on NCCL.
    t0 = time.perf_counter()
    slim = host.to_host(res._replace(floor=None, trace=None, smoothed_deviation=None))
    (nccl,) = pmesh.spawn(nccl_rank, 1, "nccl", "cuda", slim)
    log(f"NCCL world of 1 on {nccl['device']} ({nccl['backend']}), "
        f"{time.perf_counter() - t0:.1f}s with startup: {nccl['fleet']}")
    check(nccl["backend"] == "nccl", f"the NCCL world ran on {nccl['backend']}")
    check_fleet(nccl["fleet"], fleet_exp, "NCCL fleet_summary")

    # sp: a two-hour recording, a quarter per rank.
    n = SR * 60 * synth.MINUTES * SP_RECORDINGS
    n -= n % (SP_RANKS * SP_QUANTILE["stride"])
    x = np.concatenate([synth.synth_recording(s) for s in range(SP_RECORDINGS)])[:n]
    dev = torch.device("cuda")
    xt = torch.from_numpy(x).to(dev)[None]
    local, local_s = {}, {}

    def timed_local(name, fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local[name] = fn()[0]
        torch.cuda.synchronize()
        local_s[name] = time.perf_counter() - t0

    timed_local("envelope", lambda: rolling.rolling_mean_centered(xt.abs(), SR // 10))
    series = local["envelope"].cpu().numpy().copy()
    series[np.random.RandomState(3).rand(n) < 0.05] = np.nan
    yt = torch.from_numpy(series).to(dev)[None]
    timed_local("quantile", lambda: quant.rolling_quantile_centered_strided(yt, **SP_QUANTILE))
    timed_local("filtfilt", lambda: filt.bandpass_filtfilt(xt, SR, 20.0, 150.0))
    t0 = time.perf_counter()
    sp = pmesh.spawn(sp_rank, SP_RANKS, "gloo", "cuda", x, series)
    log(f"sp: {SP_RANKS} ranks on {[r['device'] for r in sp]}, {n} samples "
        f"({n // SP_RANKS} a rank), {time.perf_counter() - t0:.1f}s with startup")
    whole = sp[0]["whole"]
    phase_launches = [r["phase_launches"] for r in sp]
    log(f"  sp filtfilt: the filter kernel's phase launches per rank {phase_launches}")
    check(all(n > 0 for r in phase_launches for n in r.values()),
          f"sp filtfilt: a phase entry point was not launched: {phase_launches}")
    bits = f"u{whole['filtfilt'].itemsize}"
    same = np.array_equal(whole["filtfilt"].view(bits),
                          whole["filtfilt_plain_pieces"].view(bits))
    log(f"  sp filtfilt on the kernel's phases {sp[0]['seconds']['filtfilt']:.4f}s, on "
        f"BlockFilter's plain pieces {sp[0]['seconds']['filtfilt_plain_pieces']:.4f}s on "
        f"{card}; bit-equal: {same}")
    check(same, "sp filtfilt: the relay on the kernel's phases differs from the relay on "
                "the plain pieces")
    for name in ("envelope", "quantile", "filtfilt"):
        exp = local[name].cpu().numpy()
        got = whole[name]
        err = float(np.nanmax(np.abs(got - exp)))
        log(f"  {name}: sharded {sp[0]['seconds'][name]:.4f}s, local {local_s[name]:.4f}s "
            f"on {card}; max abs err {err:.6g} (peak {float(np.nanmax(np.abs(exp))):.6g})")
        if name == "filtfilt":
            bound = seqshard.FLOAT32_FILTFILT_BOUND * float(np.abs(exp).max())
            check(err <= bound, f"sp filtfilt: max abs err {err} > {bound}")
        else:
            check(np.array_equal(got, exp, equal_nan=True),
                  f"sp {name}: the sharded result is not equal to the local one")
    log(f"  sp: envelope and quantile equal to local; filtfilt within "
        f"{seqshard.FLOAT32_FILTFILT_BOUND} of its peak")

    # The host: analyze_files_batched(mesh=...) on 2 ranks, two of phase 9's
    # WAVs, one file a rank.  Held to the unsharded run at the ranks' batch
    # shape (one file a chunk), and both to phase 9's chunk of 16: a
    # recording's beats and CSV do not depend on its batch (ROADMAP C6).
    paths, results9, out9 = host_run
    paths = paths[:2]
    out_u = os.path.join(tmp, "unsharded_b1")
    t0 = time.perf_counter()
    results_u, errors = host_batch.analyze_files_batched(paths, cfg, out_u, max_batch=1)
    torch.cuda.synchronize()
    check(errors == [], f"unsharded host errors: {errors}")
    log(f"host, unsharded, one file a chunk: {time.perf_counter() - t0:.3f}s on {card}")
    out_m = os.path.join(tmp, "mesh")
    t0 = time.perf_counter()
    hosts = pmesh.spawn(host_rank, 2, "gloo", "cuda", paths, cfg, out_m)
    log(f"host, 2 ranks on 2 files: {time.perf_counter() - t0:.1f}s with startup; walls "
        f"{[round(h['wall'], 3) for h in hosts]} s on {card}; launches "
        f"{[h['launches'] for h in hosts]}; lanes {[lanes_text(h['lanes']) for h in hosts]}")
    check(all(h["errors"] == [] for h in hosts), f"host mesh errors: {hosts[0]['errors']}")
    check([h["launches"]["knot_quantile"] for h in hosts] == [2, 2],
          f"host mesh launches {[h['launches'] for h in hosts]}")
    for p in paths:
        exp = results_u[p].final_positions[:int(results_u[p].final_count)]
        for h in hosts:
            check(np.array_equal(h["positions"][p], exp), f"host mesh: {p} positions differ")
        base = os.path.splitext(os.path.basename(p))[0]
        for suffix in ("_bpm_plot.csv", "_Analysis_Summary.md", "_Debug_Log.md",
                       "_Analysis_Settings.json"):
            msg = artifacts_differ(os.path.join(out_u, base + suffix),
                                   os.path.join(out_m, base + suffix), suffix)
            check(msg is None, f"host mesh vs unsharded: {base}: {msg}")
        b16 = results9[p].final_positions[:int(results9[p].final_count)]
        csv = artifacts_differ(os.path.join(out9, base + "_bpm_plot.csv"),
                               os.path.join(out_m, base + "_bpm_plot.csv"), "_bpm_plot.csv")
        log(f"  {base}: {len(exp)} beats one file a batch, {len(b16)} in phase 9's chunk "
            f"of 16; {len(np.setxor1d(exp, b16))} positions differ "
            f"{np.setxor1d(exp, b16)[:10].tolist()}; beat F1 {beat_f1(exp / SR, b16 / SR):.6f}"
            f"; CSV against phase 9's: {csv or 'equal'}")
        check(np.array_equal(exp, b16) and csv is None,
              f"{base}: one file a batch differs from phase 9's chunk of 16 (C6)")
    gate_curves(host_curves({p: hosts[0]["rows"][p] for p in paths}, paths, SR), oracle,
                (0, 1), "phase 10 host mesh")
    log("  host mesh artifacts equal the unsharded run's at one file a batch (CSV, summary, "
        "settings byte-equal; debug log within one amplitude quantum); positions and CSV "
        "equal to phase 9's chunk of 16")

    profiled_kernels(card, knot, strided, tmp)
    log(f"phase 10 scale-out: ok in {time.perf_counter() - t_phase:.1f}s")
    return dp_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.models import noise_floor
    from bpm_analysis_tpu_torch.ops import knot_quantile as kq
    from bpm_analysis_tpu_torch.models import classifier, corrections
    from bpm_analysis_tpu_torch.ops import filter as filt
    from bpm_analysis_tpu_torch.ops import quantile
    from bpm_analysis_tpu_torch.models import analytics
    from bpm_analysis_tpu_torch.ops.cuda import (classify_kernel, filter_kernel, knot_kernel,
                                                 metrics_kernel, quantile_kernel, rhythm_kernel,
                                                 rolling_quantile_kernel, row_quantile_kernel)

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
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
    clock_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    log(f"phase 1 device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; max SM clock {clock_hz / 1e6:.0f} MHz")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the filter's float32 products must stay exact")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    builds = build_all()
    for wrapper in (knot_kernel, quantile_kernel, row_quantile_kernel,
                    rolling_quantile_kernel, classify_kernel, rhythm_kernel, filter_kernel,
                    metrics_kernel):
        wrapper.LIBRARY.load()
    log("phase 2 build: " + ", ".join(f"nvcc {k} {v:.2f}s" for k, v in builds.items())
        + f"; {time.perf_counter() - t0:.2f}s in all")
    from bpm_analysis_tpu_torch.kernels import build
    for name in builds:
        log(f"  ptxas {name}: " + ("; ".join(build.resources.get(name, []))
                                   or "cached library, not built in this run"))

    # ---- 3. kernels vs plain versions on the card --------------------------
    mismatches = sum(knot_kernel.division_mismatches(DIVISION_PAIRS, seed) for seed in range(4))
    log(f"  knot kernel's fast division vs IEEE division: {mismatches} of "
        f"{4 * DIVISION_PAIRS} operand pairs differ")
    check(mismatches == 0, "the knot kernel's fast division differs from IEEE division")
    divisors = classifier.constant_divisors(SR, engine_config())
    c_mismatches = sum(classify_kernel.division_mismatches(
        divisors, CLASSIFY_DIVISION_NUMERATORS, seed) for seed in range(2))
    r_mismatches = classify_kernel.division_mismatches(None, DIVISION_PAIRS, 5)
    log(f"  classify kernel's fast division vs IEEE division: {c_mismatches} of "
        f"{2 * CLASSIFY_DIVISION_NUMERATORS * len(divisors)} quotients by its constant "
        f"divisors {divisors.tolist()} differ, {r_mismatches} of {DIVISION_PAIRS} random pairs")
    check(c_mismatches == 0 and r_mismatches == 0,
          "the classify kernel's fast division differs from IEEE division")
    knot_err = check_knot_cases(dev)
    strided_err = check_strided_cases(dev)
    check_row_quantile_cases(dev)
    rolling_err = check_rolling_quantile_cases(dev)
    classify_err, rhythm_err = check_scan_cases(dev)
    filter_err = check_filter_cases(dev)
    check_metrics_cases(dev)
    log(f"phase 3 kernels vs plain: ok (knot rtol {RTOL} atol {ATOL}; strided rtol "
        f"{STRIDED_RTOL}; scans equal)")

    # ---- 4. main path at full width ----------------------------------------
    cfg = engine_config()
    t0 = time.perf_counter()
    batch_i16 = np.stack([synth._quantize_int16(synth.synth_recording(s)) for s in SEEDS])
    batch = batch_i16.astype(np.float32)
    log(f"synthesized {batch.shape} in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    res = run_main_path(batch, cfg, "cuda")
    torch.cuda.synchronize()
    log(f"first run (cold): {time.perf_counter() - t0:.2f}s")

    captured, c_captured, r_captured, f_captured, q_captured = [], [], [], [], []
    m_captured = []
    res, launches = counted_run(batch, cfg, {
        (analytics, "compute_metrics"): m_captured,
        (row_quantile_kernel, "quantile_exact"): q_captured,
        (knot_kernel, "knot_quantile_anchors"): captured,
        (classifier, "classify_scan"): c_captured,
        (corrections, "rhythm_scan"): r_captured,
        (filt, "lfilter"): f_captured})
    log(f"kernel launches on the main path: {launches}")
    check(launches == AUTO_LAUNCHES, f"expected {AUTO_LAUNCHES}, got {launches}")

    overflowed = res.overflowed.cpu().numpy()
    final_count = res.final_count.cpu().numpy()
    log(f"final beats per recording: min {final_count.min()} max {final_count.max()}; "
        f"overflowed {int(overflowed.sum())}")
    check(not overflowed.any(), "a capacity truncated events on the main path")
    check((final_count > 100).all(), f"too few beats: {final_count}")

    best = warm_best(batch, cfg, 2)
    log(f"warm wall time (best of 2): {best:.3f}s = {BATCH * 10 / best:.2f} audio-min/s "
        f"on {card}")

    log("stage spans (traced run): " + stage_spans(batch, cfg))

    # The kernel against its plain version at the main path's own inputs
    # (draft and final floor), then timed on the final-floor call.
    real_anchors = knot_kernel.knot_quantile_anchors

    def plain(*a, **k):
        return kq.rolling_quantile_knots(*a, **k, dtype=torch.float32)

    knot_call = captured[-1]
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

    # Both scan kernels against their plain versions at the main path's own
    # inputs (the preliminary and the main classifier pass, the rhythm
    # correction), each timed on its last call.
    real_classify, real_rhythm = classifier.classify_scan, corrections.rhythm_scan
    scan_ms = {}
    for label, (a, k) in zip(("preliminary", "main"), c_captured):
        got = real_classify(*a, **k)
        exp, ms = once_ms(lambda: classifier.scan_plain(a[0], *a[2:], **k))
        err = trace_error(got, exp)
        classify_err = max(classify_err, err)
        log(f"  classify kernel vs plain [main path, {label} pass] {tuple(a[0].positions.shape)}"
            f", trace {k['want_trace']}: max abs err {err} over the classes and "
            f"{0 if exp[1] is None else len(exp[1])} trace fields; plain {ms:.1f} ms")
        check(err == 0, f"classify kernel differs from its plain version on the {label} pass")
        scan_ms["classify_plain"] = ms
    for label, (a, k) in zip(("preliminary", "main"), c_captured):
        c_kernel_ms = cuda_ms(lambda: real_classify(*a, **k), 20)
        c_bound_ms, c_bound_by = scan_bound(a[0], k["want_trace"], clock_hz)
        log(f"classify kernel at the main path's shapes ({label} pass): {c_kernel_ms:.4f} ms "
            f"(bound {c_bound_ms:.5f} ms by {c_bound_by}, "
            f"{100 * c_bound_ms / c_kernel_ms:.1f}% of it) on {card}")
    log(f"  classify plain version (main pass): {scan_ms['classify_plain']:.1f} ms")
    rhythm_call = r_captured[-1]
    a, k = rhythm_call
    got = real_rhythm(*a, **k)
    exp, r_plain_ms = once_ms(lambda: corrections.rhythm_scan_plain(*a[:4], a[5]))
    rhythm_err = max(rhythm_err, rhythm_error(got, exp))
    check(rhythm_err == 0, "rhythm kernel differs from its plain version on the main path")
    r_kernel_ms = device_ms(lambda: real_rhythm(*a, **k), 50)
    r_paced_ms = cuda_ms(lambda: real_rhythm(*a, **k), 50)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 50)     # an empty launch
    r_bound_ms, r_bound_by, r_run, r_dividing_ms = rhythm_bound(*a[:4], a[5], clock_hz)
    log(f"rhythm kernel at the main path's shapes {tuple(a[0].shape)}: written and victim "
        f"equal; {r_kernel_ms:.4f} ms queued ({r_paced_ms:.4f} ms a call issued back to "
        f"back; an empty launch queued {floor_ms:.4f} ms), bound {r_bound_ms:.6f} ms by "
        f"{r_bound_by} ({100 * r_bound_ms / r_kernel_ms:.1f}% of it; longest run "
        f"{r_run} steps; a division every step over the capacity: {r_dividing_ms:.5f} ms), "
        f"plain {r_plain_ms:.1f} ms, on {card}")
    real_filter = filt.lfilter
    for label, (a, k) in zip(("forward", "backward"), f_captured):
        got = real_filter(*a, **k)
        exp, f_plain_ms = once_ms(lambda: filt.lfilter_plain(*a, **k))
        err = float((got - exp).abs().max())
        filter_err = max(filter_err, err)
        check(torch.equal(got, exp),
              f"filter kernel differs from its plain version on the {label} pass")
    f_kernel_ms = cuda_ms(lambda: real_filter(*a, **k), 20)
    f_L = min(256, max(8, a[2].shape[1]))
    f_bound_ms, f_bound_by = filter_bound(a[2], f_L, len(a[1]) - 1, clock_hz)
    log(f"filter kernel at the main path's shapes {tuple(a[2].shape)}: both passes equal; "
        f"{f_kernel_ms:.4f} ms (plain {f_plain_ms:.1f} ms, bound {f_bound_ms:.5f} ms by "
        f"{f_bound_by}, {100 * f_bound_ms / f_kernel_ms:.1f}% of it) on {card}")
    # The row quantile against its plain version on the path's four calls,
    # then at the fleet cell's shape: the last call's envelope tiled to 512
    # rows, without a mask as the fleet path calls it and with a valid
    # prefix as the host path does, each timed beside its bound, the plain
    # version and the library yardstick.
    real_quantile = row_quantile_kernel.quantile_exact
    for (a, k) in q_captured:
        check(same_values(real_quantile(*a, **k), quantile.quantile_exact_plain(*a, **k)),
              "row-quantile kernel differs from its plain version on the main path")
    env16, q_main = q_captured[-1][0][:2]
    x512 = env16.repeat(-(-512 // env16.shape[0]), 1)[:512].contiguous()
    q_n = x512.shape[1]
    q_prefix = (torch.arange(q_n, device=dev)[None, :]
                < q_n - 1000 * (torch.arange(512, device=dev)[:, None] % 7))
    q_rows = {}
    for label, v512 in (("no mask", None), ("valid prefix", q_prefix)):
        got = real_quantile(x512, q_main, valid=v512)
        exp = quantile.quantile_exact_plain(x512, q_main, valid=v512)
        q_err = float((got - exp).abs().max())
        check(same_values(got, exp),
              f"row-quantile kernel differs from its plain version at (512, n), {label}")
        q_kernel_ms = cuda_ms(lambda: real_quantile(x512, q_main, valid=v512), 20)
        q_plain_ms = cuda_ms(lambda: quantile.quantile_exact_plain(x512, q_main, valid=v512), 3)
        q_library_ms = cuda_ms(lambda: nanquantile_batch(x512, q_main, v512), 1)
        q_bound_ms = row_quantile_bound(x512, v512)
        q_rows[label] = {"max_abs_err": q_err, "ms": q_kernel_ms, "plain_ms": q_plain_ms,
                         "bound_ms": q_bound_ms, "bound_by": "bytes",
                         "library_ms": q_library_ms}
        log(f"row-quantile kernel at the fleet shape {tuple(x512.shape)} {x512.dtype}, "
            f"{label}, q={q_main}: {q_kernel_ms:.4f} ms, bound {q_bound_ms:.4f} ms by bytes "
            f"({100 * q_bound_ms / q_kernel_ms:.1f}% of it), plain {q_plain_ms:.3f} ms, "
            f"library (torch.nanquantile by rows) {q_library_ms:.3f} ms, max abs err {q_err} "
            f"on {card}")
    log(f"  the path's {len(q_captured)} row-quantile calls at {tuple(env16.shape)}: equal")
    metrics_row = {**time_metrics(card, m_captured), "launches": launches["metrics"]}
    log("phase 4 main path: ok")

    # ---- 5. accuracy against the CPU reference -----------------------------
    with open(os.path.join(REPO, "bench_cpu_baseline.json")) as f:
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
    check(launches_b2 == PALLAS_LAUNCHES, f"expected {PALLAS_LAUNCHES}, got {launches_b2}")
    overflowed = res_b2.overflowed.cpu().numpy()
    final_count = res_b2.final_count.cpu().numpy()
    log(f"final beats per recording: min {final_count.min()} max {final_count.max()}; "
        f"overflowed {int(overflowed.sum())}")
    check(not overflowed.any(), "a capacity truncated events on the strided-kernel path")
    best_b2 = warm_best(batch, cfg_b2, 2)
    log(f"strided-kernel path warm wall time (best of 2): {best_b2:.3f}s = "
        f"{BATCH * 10 / best_b2:.2f} audio-min/s on {card}")
    log("strided-kernel path stage spans (traced run): " + stage_spans(batch, cfg_b2))
    curves_b2 = check_accuracy(res_b2, oracle, "phase 7")

    real_strided = quantile_kernel.strided_quantile_anchors
    strided_call = s_captured[-1]
    for label, (a, k) in zip(("draft floor", "final floor"), s_captured):
        got = real_strided(*a, **k)
        err, rel, ok = compare(got, quantile.strided_quantile_anchors_f32_plain(*a, **k),
                               rtol=STRIDED_RTOL, atol=0.0)
        strided_err = max(strided_err, err)
        log(f"  strided kernel vs plain [strided-kernel path, {label}] "
            f"{tuple(a[0].shape)} -> {tuple(got.shape)}: max abs err {err:.3g}, "
            f"max rel err {rel:.3g}")
        check(ok, f"strided kernel disagrees with its plain version on the {label}")
    x_b2, window_b2, q_b2, mp_b2, stride_b2 = a[:5]
    s_kernel_ms = cuda_ms(lambda: real_strided(*a, **k), 10)
    s_plain_ms = cuda_ms(lambda: quantile.strided_quantile_anchors_f32_plain(*a, **k), 2)
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
    rolling_row = time_rolling_quantile(card, batch, rolling_err)
    log("phase 8 default configuration: ok")

    # ---- 9. the host path at full width -------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        host_run = check_host_path(card, cfg, batch_i16, res, oracle, tmp)

        # ---- 10. scale-out on the one card -----------------------------------
        torch.cuda.empty_cache()
        dp_launches = check_scale_out(card, cfg, batch, res, best, oracle, host_run,
                                      (real_anchors, knot_call),
                                      (real_strided, strided_call), tmp)

    table = {"kernels": [{
        "name": "knot_quantile",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/knot_quantile.cu",
        "replaces": "bpm_analysis_tpu/ops/pallas/knot_kernel.py:81",
        "launches": launches["knot_quantile"],
        "dp_launches_per_rank": dp_launches,
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
    }, {
        "name": "row_quantile",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/row_quantile.cu",
        "replaces": "bpm_analysis_tpu/ops/quantile.py:146",
        "launches": launches["row_quantile"],
        **q_rows["no mask"],
    }, rolling_row, {
        "name": "classify_scan",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/classify_scan.cu",
        "replaces": "bpm_analysis_tpu/models/classifier.py:465",
        "launches": launches["classify_scan"],
        "max_abs_err": classify_err,
        "ms": c_kernel_ms,
        "plain_ms": scan_ms["classify_plain"],
        "bound_ms": c_bound_ms,
        "bound_by": c_bound_by,
        "library_ms": None,
    }, {
        "name": "rhythm_scan",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/rhythm_scan.cu",
        "replaces": "bpm_analysis_tpu/models/corrections.py:92",
        "launches": launches["rhythm_scan"],
        "max_abs_err": rhythm_err,
        "ms": r_kernel_ms,
        "plain_ms": r_plain_ms,
        "bound_ms": r_bound_ms,
        "bound_by": r_bound_by,
        "library_ms": None,
    }, {
        "name": "block_filter",
        "route": "cuda",
        "source": "bpm_analysis_tpu_torch/csrc/block_filter.cu",
        "replaces": "bpm_analysis_tpu/ops/filter.py:136",
        "launches": launches["block_filter"],
        "max_abs_err": filter_err,
        "ms": f_kernel_ms,
        "plain_ms": f_plain_ms,
        "bound_ms": f_bound_ms,
        "bound_by": f_bound_by,
        "library_ms": None,
    }, metrics_row]}
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
