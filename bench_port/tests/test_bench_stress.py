"""The stress cell, ``stress-b512``: its frozen answers equal the oracle, its
generator is deterministic per seed and sends the pool's recordings, the
cell is correct on the CPU while its bfloat16 control is not, and the
readers of the loop rounds' spans give known numbers on a hand-made trace
and None without the spans."""
import json
import os

import numpy as np
import pytest

from bench_port import core, trace
from bench_port.reference import freeze_stress, upstream
from bench_port.tests.test_bench_metrics import run_of
from bench_port.tests.test_bench_span_metrics import ev, hand_trace, span
from bench_port.traffic import fleet_stress, synth, synth_stress

SEED = 2**33 + 4099
SMALL = {"traffic": {"batch": 2}, "warmup_calls": 1}
READERS = ("loop_rounds_per_call.engine", "loop_host_ms.engine")


def test_frozen_stress_answers_equal_the_oracle():
    with open(os.path.join(core.ROOT, freeze_stress.META["oracle"])) as f:
        per_seed = json.load(f)["per_seed"]
    pool = upstream.pool(freeze_stress.POOL)
    assert sorted(pool.ids) == sorted(int(k) for k in per_seed) == list(range(128))
    assert (pool.rate, pool.post_rate, pool.minutes, pool.generator) == (
        302, 302, 10.0, "synth_stress_recording")
    for rid in pool.ids:
        want, got = per_seed[str(rid)], pool.answer(rid)
        assert np.array_equal(got["positions"] / pool.post_rate, want["beat_times"])
        assert np.array_equal(got["bpm_times"], want["bpm_times"])
        assert np.array_equal(got["bpm"], want["bpm_values"])


def test_stress_make_is_deterministic_per_seed(tmp_path):
    from bpm_analysis_tpu_torch import synth as port

    params = {"pool": "stress-302hz", "batch": 256, "batches": 2}
    a = fleet_stress.make(params, SEED, str(tmp_path))
    b = fleet_stress.make(params, SEED, str(tmp_path))
    c = fleet_stress.make(params, SEED + 1, str(tmp_path))
    pool = sorted(upstream.pool("stress-302hz").ids)
    assert a["ids"] == b["ids"] != c["ids"] and a["ids"][0] != a["ids"][1]
    for ids in a["ids"] + c["ids"]:
        assert sorted(ids[:128]) == sorted(ids[128:]) == pool
    assert [x.shape for x in a["batches"]] == [(256, 181_200)] * 2
    for x, y, ids in zip(a["batches"], b["batches"], a["ids"]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.float32
        for r in (0, 1, 2, 3):
            row = synth.quantize_int16(synth_stress.synth_stress_recording(ids[r]))
            np.testing.assert_array_equal(x[r], row)
            np.testing.assert_array_equal(row, port._quantize_int16(
                port.synth_stress_recording(ids[r])))


@pytest.mark.parametrize("control", [False, True], ids=["sound", "bfloat16"])
def test_stress_cell_correct_and_its_control_not(control):
    result = core.run_cell("stress-b512", SEED, 0.1, False, "cpu", overrides=SMALL,
                           control=control)
    assert result["correct"] is (not control), result["checks"]
    assert result["failed"] == 0 and result["checks"]["answers_failed"]["value"] == 0


def test_loop_readers_on_a_hand_made_trace_and_without_the_spans():
    rounds = [span("bpm.nms.round", 171, 20), span("bpm.nms.round", 241, 9),
              span("bpm.fix.round", 300, 15), span("bpm.nms.round", 661, 30),
              ev("user_annotation", "bpm.fix.round", 302, 10)]    # nested: counted once in ms
    run = run_of(trace.Trace(hand_trace() + rounds, calls=2))
    assert core.reader("loop_rounds_per_call.engine")(run) == 2.5
    assert core.reader("loop_host_ms.engine")(run) == pytest.approx((20 + 9 + 15 + 30) / 2e3)
    for name in READERS:
        assert core.reader(name)(run_of(None)) is None
        assert core.reader(name)(run_of(trace.Trace(hand_trace(), calls=2))) is None
