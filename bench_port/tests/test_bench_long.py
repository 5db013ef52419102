"""The two-hour cell, ``long-2h-b64``: its traffic is deterministic per seed
and sends the pool twice a batch, the readers of the scan and scratch spans
give known numbers on a hand-made trace and None without the spans, and the
frozen answers equal a fresh run of ``tools/freeze_long_answers.py``."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from bench_port import core, trace
from bench_port.reference import upstream
from bench_port.tests.test_bench_metrics import run_of
from bench_port.tests.test_bench_span_metrics import ev, hand_trace, span
from bench_port.traffic import fleet, synth

SEED = 2**33 + 2417
CELL = "long-2h-b64"
READERS = ("scan_device_ms.engine", "scratch_device_ms.engine")


def test_long_make_is_deterministic_per_seed(tmp_path):
    params = core.cell_spec(CELL).workload["traffic"]
    a = fleet.make(params, SEED, str(tmp_path))
    b = fleet.make(params, SEED, str(tmp_path))
    pool = sorted(upstream.pool(params["pool"]).ids)
    assert a["minutes"] == 120.0 and a["rate"] == 302
    assert a["ids"] == b["ids"] and a["ids"][0] != a["ids"][1]
    for ids in a["ids"]:
        assert sorted(ids[:32]) == sorted(ids[32:]) == pool
    assert [x.shape for x in a["batches"]] == [(64, 2_174_400)] * 2
    for x, y, ids in zip(a["batches"], b["batches"], a["ids"]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x[0], synth.quantize_int16(
            synth.synth_recording(ids[0], 120)))
    del b
    c = fleet.make({**params, "batch": 32, "batches": 1}, SEED + 1, str(tmp_path))
    assert c["ids"][0] != a["ids"][0][:32]


def test_scan_and_scratch_readers_on_a_hand_made_trace_and_without_the_spans():
    extra = [span("bpm.scan", 268, 10),           # around k_classify's launch: 60 us
             span("bpm.scan", 715, 15),
             ev("cuda_runtime", "cudaLaunchKernel", 720, 5, 11),
             ev("kernel", "k_rhythm", 730, 8, 11),
             span("bpm.scratch", 208, 8)]         # around k_raw's launch: 30 us
    run = run_of(trace.Trace(hand_trace() + extra, calls=2))
    assert core.reader("scan_device_ms.engine")(run) == pytest.approx((60 + 8) / 2e3)
    assert core.reader("scratch_device_ms.engine")(run) == pytest.approx(30 / 2e3)
    for name in READERS:
        assert core.reader(name)(run_of(None)) is None
        assert core.reader(name)(run_of(trace.Trace(hand_trace(), calls=2))) is None


def test_frozen_answers_equal_a_fresh_run_of_the_tool(tmp_path):
    """One id through the freezing tool anew (the JAX package in float64 at
    stride 1, in its own process so that this one loads no JAX): the same
    beats and BPM series as the committed pool."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the freezing tool needs JAX")
    rid, out = 5, tmp_path / "fresh.npz"
    proc = subprocess.run(
        [sys.executable, os.path.join(core.ROOT, "tools", "freeze_long_answers.py"),
         "--ids", str(rid), "--out", str(out)],
        cwd=core.ROOT, capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    committed = upstream.pool("synth-302hz-2h").answer(rid)
    with np.load(out) as z:
        assert list(z["ids"]) == [rid] and int(z["minutes"]) == 120
        fresh = {"positions": z["positions"], "bpm_times": z["bpm_times"],
                 "bpm": z["bpm_values"]}
    for key in ("positions", "bpm_times", "bpm"):
        np.testing.assert_array_equal(fresh[key], committed[key], err_msg=key)
