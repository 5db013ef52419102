"""The port on recordings from outside the exertion family (the
``engine-stress-302hz`` configuration of ``bench_port``): the stress
generator against ``bench.py``'s bit for bit, one recording of each family
through ``envelope.preprocess`` → ``pipeline.analyze_batch`` on the CPU
against the upstream analyzer's frozen answers, and the spans of the two
data-dependent host loops, one a round."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import bench
from bench_port import core
from bench_port.reference import compare, upstream
from bpm_analysis_tpu_torch import synth
from bpm_analysis_tpu_torch.models import corrections, envelope, pipeline
from bpm_analysis_tpu_torch.ops import find_peaks
from bpm_analysis_tpu_torch.utils import profiling

SR = 302
IDS = [0, 1, 2, 3]                     # one a family: clipping, dropouts, 40 BPM, 165 BPM
ROUNDS = {"nms": "bpm.nms.round", "fix": "bpm.fix.round"}
# The cell runs in float32 where upstream computes in float64.  The same four
# rows at the same stride 64 in float64 read at most 1.4e-14 BPM, so the gap
# is float32 rounding: 0.00042 BPM at most here (0.000418 on id 3), where a
# beat a sample off moves the series by ~0.01 and the bfloat16 envelope by
# more than 1.
BPM_MAE_TOL = 1e-3


@pytest.mark.parametrize("rid", IDS)
def test_stress_recording_equals_bench(rid):
    np.testing.assert_array_equal(synth.synth_stress_recording(rid),
                                  bench.synth_stress_recording(rid))


def _config():
    return core.program_config(core.cell_spec("stress-b512").config["runtime"])


def _rows(seconds: int = 600) -> np.ndarray:
    return np.stack([synth._quantize_int16(synth.synth_stress_recording(i)[:SR * seconds])
                     for i in IDS]).astype(np.float32)


@pytest.fixture(scope="module")
def four_threads():
    """Four intra-op threads for this module's ten-minute rows, the
    process's own count restored after it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def stress_run(four_threads):
    """The cell's configuration on ids 0-3 at their ten-minute length, and
    each row's numbers against the upstream answer."""
    cfg = _config()
    env = envelope.preprocess(_rows(), SR, cfg, device="cpu")[0]
    res = pipeline.analyze_batch(env, SR, cfg, device="cpu")
    pool = upstream.pool("stress-302hz")
    readings = []
    for r, rid in enumerate(IDS):
        count = int(res.final_count[r])
        k = int(res.metrics.bpm.count[r])
        got = {"positions": res.final_positions[r, :count].numpy().astype(np.int64),
               "bpm_times": res.metrics.bpm.times[r, :k].double().numpy(),
               "bpm": res.metrics.bpm.smoothed[r, :k].double().numpy()}
        readings.append(compare.numbers(got, pool.answer(rid)))
    return res, readings


def test_no_row_overflows_and_no_beat_moves(stress_run):
    res, readings = stress_run
    assert not res.overflowed.any() and res.ok.all()
    assert [r["beats_moved_pct"] for r in readings] == [0.0] * len(IDS)


def test_bpm_series_within_float32_rounding(stress_run):
    _, readings = stress_run
    worst = max(r["bpm_mae"] for r in readings)
    assert worst < BPM_MAE_TOL, readings


def test_loop_round_spans_one_per_granted_read(tmp_path, four_threads):
    """Under a capture, one ``bpm.nms.round`` / ``bpm.fix.round`` span for
    each ``nms`` / ``fix`` read that lets a round run (the first 30 s of
    ids 0-3, the cell's configuration at capacities cut to that length)."""
    cfg = _config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, max_raw_peaks=512, max_troughs=512, max_candidates=256,
        extrema_capacity=4096, prominence_residual_capacity=256))
    granted = {"nms": 0, "fix": 0}

    def counting(real):
        def host_read(site, tensor):
            go = real(site, tensor)
            granted[site] += go
            return go
        return host_read

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(find_peaks, "host_read", counting(find_peaks.host_read))
        mp.setattr(corrections, "host_read", counting(corrections.host_read))
        with profiling.device_trace(str(tmp_path)):
            env = envelope.preprocess(_rows(30), SR, cfg, device="cpu")[0]
            pipeline.analyze_batch(env, SR, cfg, device="cpu")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"].startswith("bpm.")]
    for site, span in ROUNDS.items():
        assert granted[site] > 0, site
        assert names.count(span) == granted[site], (site, names.count(span), granted)
        assert names.count(f"bpm.sync.{site}") > granted[site]
