"""Two-hour recordings (the ``engine-2h-302hz`` configuration of
``bench_port``, cell ``long-2h-b64``) on the CPU: the distance NMS's plan at
the cell's two widths, the knot quantile at the cell's table width, the
configuration's extrema capacity against the envelope's local extrema of
ids 0-3, id 0 through ``envelope.preprocess`` → ``pipeline.analyze_batch``
against its frozen answer (and C9 pinned on it), and the frozen pool's
invariants."""
import numpy as np
import pytest
import torch

import chip_smoke
from bench_port import core
from bench_port.reference import compare, upstream
from bench_port.traffic import synth
from bpm_analysis_tpu_torch.models import analytics, envelope, pipeline
from bpm_analysis_tpu_torch.ops import find_peaks as fp
from bpm_analysis_tpu_torch.ops import knot_quantile as kq
from bpm_analysis_tpu_torch.ops.cuda import nms_kernel

SR = 302
CELL = "long-2h-b64"
POOL = "synth-302hz-2h"
IDS = [0, 1, 2, 3]
N = SR * 60 * 120                       # two hours: 2,174,400 samples
# The cell runs in float32 where the frozen answers are float64 at stride 1.
# Id 0 reads 0.00265 BPM: float32 beat times at 7,200 s step by 0.49 ms, five
# times the ten-minute gap (0.0005); in float64 the same path reads ~6e-12,
# and a beat a sample off moves the series by ~0.01.
BPM_MAE_TOL = 0.01


def _runtime() -> dict:
    return core.cell_spec(CELL).config["runtime"]


@pytest.fixture(scope="module")
def four_threads():
    """Four intra-op threads for this module's two-hour rows, the process's
    own count restored after it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def envelopes(four_threads):
    """The envelopes of ids 0-3 at two hours, int16-quantized as the cell
    sends them, in the configuration's float32."""
    x = np.stack([synth.quantize_int16(synth.synth_recording(i, 120)) for i in IDS])
    cfg = core.program_config(_runtime())
    return envelope.preprocess(x.astype(np.float32), SR, cfg, device="cpu")[0]


@pytest.mark.parametrize("finder, expected", [
    ("troughs", nms_kernel.Plan(1, 264_190, True)),
    ("raw_peaks", nms_kernel.Plan(8, 24_576, False))])
def test_nms_plan_at_the_cells_widths(finder, expected):
    """The trough NMS runs over the extrema width, past a cluster of 8
    blocks' shared memory: global scratch; the raw-peak NMS over the raw
    candidates: a cluster of 8."""
    rt = _runtime()
    width = (rt["extrema_capacity"] - 2 if finder == "troughs"
             else rt["raw_candidate_capacity"])
    assert nms_kernel.plan(width) == expected


KNOT_CASES = [c for c in chip_smoke.kernel_cases() if c[1].shape[1] < 2048]


@pytest.mark.parametrize("case", KNOT_CASES, ids=[c[0] for c in KNOT_CASES])
def test_knot_anchors_do_not_depend_on_the_table_width(case):
    """The plain knot quantile reads the same anchors with its tables padded
    to the cell's 32,768 slots (its ``max_troughs``), the width past a
    block's opt-in shared memory at which the card's kernel reads its table
    from global memory; the card test that forces that path on these cases
    holds the kernel to the plain version so."""
    assert _runtime()["max_troughs"] == 32_768

    def anchors(c):
        _, pos, val, cnt, n, window, stride, ms, nv = c
        return kq.rolling_quantile_knots(
            *(torch.from_numpy(a) for a in (pos, val, cnt)), n, window, 0.2, min_periods=3,
            stride=stride, min_spacing=ms, n_valid=None if nv is None else torch.from_numpy(nv),
            dtype=torch.float32)

    padded = chip_smoke.padded_knot_case(case, 32_768)
    assert chip_smoke.same_values(anchors(padded), anchors(case))


@pytest.mark.parametrize("row", range(len(IDS)))
def test_extrema_capacity_holds_the_local_extrema(envelopes, row):
    """Every local maximum and minimum of the envelope fits the extrema
    decomposition (~247k of each against 264,190 slots a kind)."""
    cap = _runtime()["extrema_capacity"]
    env = envelopes[row:row + 1]
    maxima, minima = (int(m.sum()) for m in fp.local_extrema_masks(env))
    assert 240_000 < maxima and maxima + minima <= 2 * (cap - 2), (maxima, minima)
    assert not fp.build_extrema(env, cap).overflowed.any()


@pytest.fixture(scope="module")
def id0_run(envelopes):
    """Id 0 through ``analyze_batch`` at the configuration, and its numbers
    against the frozen answer."""
    cfg = core.program_config(_runtime())
    res = pipeline.analyze_batch(envelopes[:1], SR, cfg, device="cpu")
    count, k = int(res.final_count[0]), int(res.metrics.bpm.count[0])
    got = {"positions": res.final_positions[0, :count].numpy().astype(np.int64),
           "bpm_times": res.metrics.bpm.times[0, :k].double().numpy(),
           "bpm": res.metrics.bpm.smoothed[0, :k].double().numpy()}
    return res, compare.numbers(got, upstream.pool(POOL).answer(IDS[0]))


def test_id0_does_not_overflow(id0_run):
    res, _ = id0_run
    assert not res.overflowed.any() and res.ok.all()
    assert int(res.final_count[0]) > 14_000


def test_id0_moves_no_more_beats_than_the_cells_limit(id0_run):
    _, numbers = id0_run
    limit = core.cell_spec(CELL).workload["check"]["limits"]["beats_moved_pct"]
    assert numbers["beats_moved_pct"] == 0.0 <= limit, numbers


def test_id0_bpm_series_within_float32_rounding(id0_run):
    _, numbers = id0_run
    assert numbers["bpm_mae"] < BPM_MAE_TOL, numbers


def test_id0_hrv_windows_stop_at_their_capacity(id0_run):
    """ROADMAP C9, a known defect pinned, not a contract: the windowed HRV
    holds ``HRV_CAPACITY`` windows (512, the JAX package's too), the first
    ~23 minutes of id 0, where its 15,045 beats make 3,001, and no overflow
    flag says so.  The repair (windows sized from the recording, or an
    overflow flag) turns these assertions round: the window count then
    equals ``windows``, or the row reads overflowed."""
    res, _ = id0_run
    o = core.program_config(_runtime()).output
    windows = (int(res.final_count[0]) - 1 - o.hrv_window_size_beats) // o.hrv_step_size_beats + 1
    assert int(res.metrics.hrv.count[0]) == analytics.HRV_CAPACITY < windows
    assert not res.overflowed.any()


def test_frozen_pool_is_32_two_hour_recordings():
    pool = upstream.pool(POOL)
    assert pool.ids == list(range(32))
    assert (pool.rate, pool.post_rate, pool.minutes, pool.generator) == (
        SR, SR, 120.0, "synth_recording")
    with np.load(f"{upstream.HERE}/answers/{POOL}.npz") as z:
        assert str(z["oracle"]) == "tools/freeze_long_answers.py"


def test_frozen_answers_are_sorted_beats_inside_the_recording():
    """Every id: beats sorted, distinct and inside the two hours (sample
    positions at the post rate; ``pool_arrays`` held the beat times to be
    exact samples when it froze them), ~15k of them, and the BPM series at
    increasing times within the recording."""
    pool = upstream.pool(POOL)
    for rid in pool.ids:
        ans = pool.answer(rid)
        pos, times = ans["positions"], ans["bpm_times"]
        assert pos.dtype == np.int64 and 14_000 < len(pos), rid
        assert np.all(np.diff(pos) > 0) and 0 <= pos[0] and pos[-1] < N, rid
        assert len(times) == len(ans["bpm"]) > 0 and np.all(np.diff(times) > 0), rid
        assert 0 <= times[0] and times[-1] <= N / SR, rid
