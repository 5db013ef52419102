"""The port's spans (``utils/profiling``) on the CPU: the stage spans of
``pipeline.analyze_batch`` in order and nested, with the blocking reads of
the NMS loop and the correction rounds and those loops' round spans; the
spans of one request through ``host.analyze_any_file``; no
``record_function`` call without a capture; the same results with and
without one; ``stage_table`` on a hand-made trace."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bpm_analysis_tpu_torch import host, synth
from bpm_analysis_tpu_torch.config import DEFAULT_CONFIG
from bpm_analysis_tpu_torch.io import wav
from bpm_analysis_tpu_torch.models import envelope, pipeline
from bpm_analysis_tpu_torch.utils import profiling

torch.set_num_threads(1)

SR = 302
STAGES = ["bpm.extrema", "bpm.noise_floor", "bpm.raw_peaks", "bpm.classify_preliminary",
          "bpm.classify_main", "bpm.corrections", "bpm.metrics"]
ROUNDS = ["bpm.nms.round", "bpm.fix.round"]
RENDER = ["bpm.render.filtered_wav", "bpm.render.settings", "bpm.render.csv",
          "bpm.render.summary", "bpm.render.debug_log", "bpm.render.plot"]
CFG = dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
    DEFAULT_CONFIG.runtime, max_raw_peaks=512, max_troughs=512, max_candidates=256,
    extrema_capacity=4096, noise_quantile_stride=64, quantile_backend="knots",
    dtype="float32"))


def _recording(seed: int, seconds: int = 30) -> np.ndarray:
    return synth._quantize_int16(synth.synth_recording(seed)[:SR * seconds])


def _traced(tmp_path, fn, passes: int = 1):
    """``fn``'s results over ``passes`` calls in one ``device_trace``
    capture, and the capture's ``bpm.*`` spans as (name, start, end) in
    start order, outer first."""
    with profiling.device_trace(str(tmp_path / "trace")):
        out = [fn() for _ in range(passes)]
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("bpm.")), key=lambda s: (s[1], -s[2]))
    return out, spans, events


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _assert_equal(a, b):
    if a is None or isinstance(a, (str, int, float)):
        assert a == b or (a != a and b != b)
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _analyze(env):
    return pipeline.analyze_batch(env, SR, CFG, device="cpu")


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory):
    batch = np.stack([_recording(s) for s in (0, 1, 2)]).astype(np.float32)
    env = envelope.preprocess(batch, SR, CFG, device="cpu")[0]
    plain = _analyze(env)
    traced, spans, _ = _traced(tmp_path_factory.mktemp("batch"), lambda: _analyze(env), 2)
    return plain, traced, spans


def test_analyze_batch_emits_every_stage_once_per_pass_in_order(batch_runs):
    _, _, spans = batch_runs
    stages = [s for s in spans if s[0] in STAGES]
    assert [s[0] for s in stages] == STAGES * 2
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1], (a, b)
    # Every read lies in a stage; each pass reads in the stages named (the
    # NMS loop also runs in the analytics' slope peaks).
    for name, stage_names in (("bpm.sync.nms", ("bpm.noise_floor", "bpm.raw_peaks")),
                              ("bpm.sync.fix", ("bpm.corrections",))):
        reads = [s for s in spans if s[0] == name]
        for r in reads:
            assert any(_inside(r, s) for s in stages), r
        for s in stages:
            if s[0] in stage_names:
                assert any(_inside(r, s) for r in reads), (name, s)
    assert {s[0] for s in spans} == set(STAGES) | {"bpm.sync.nms", "bpm.sync.fix"} | set(ROUNDS)
    # Each round of a loop lies in the stage of the read that let it run.
    for name, stage_names in (("bpm.nms.round", ("bpm.noise_floor", "bpm.raw_peaks",
                                                 "bpm.metrics")),
                              ("bpm.fix.round", ("bpm.corrections",))):
        for r in (s for s in spans if s[0] == name):
            assert any(_inside(r, s) for s in stages if s[0] in stage_names), r


def test_results_equal_with_and_without_a_capture(batch_runs):
    plain, traced, _ = batch_runs
    for res in traced:
        _assert_equal(plain, res)


@pytest.fixture(scope="module")
def request_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("request")
    src = str(d / "rec.wav")
    wav.write(src, SR, _recording(3, 40))

    def request(out):
        res = host.analyze_any_file(src, CFG, output_directory=str(d / out), device="cpu")
        return res, (d / out / "rec_bpm_plot.csv").read_bytes()

    plain = request("plain")
    traced, spans, _ = _traced(d, lambda: request("traced"))
    return plain, traced[0], spans


def test_request_spans_nest_under_the_request(request_runs):
    _, (res, _), spans = request_runs
    assert res is not None and bool(res.ok)
    names = [s[0] for s in spans if not s[0].startswith("bpm.sync.") and s[0] not in ROUNDS]
    assert names == (["bpm.request", "bpm.read", "bpm.to_device", "bpm.preprocess"] + STAGES
                     + ["bpm.to_host", "bpm.render"] + RENDER)
    request = spans[0]
    assert request[0] == "bpm.request" and all(_inside(s, request) for s in spans)
    top = [s for s in spans if s[0] in ("bpm.read", "bpm.to_device", "bpm.preprocess",
                                        "bpm.to_host", "bpm.render") or s[0] in STAGES]
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1], (a, b)
    render = next(s for s in spans if s[0] == "bpm.render")
    assert all(_inside(s, render) for s in spans if s[0] in RENDER)
    assert {s[0] for s in spans if s[0].startswith("bpm.sync.")} == {"bpm.sync.nms",
                                                                     "bpm.sync.fix"}


def test_request_equal_with_and_without_a_capture(request_runs):
    (res, csv), (res_traced, csv_traced), _ = request_runs
    _assert_equal(res, res_traced)
    assert csv == csv_traced


def test_no_record_function_without_a_capture(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no capture active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("bpm.a") is profiling.span("bpm.b")
    with profiling.span("bpm.a"):
        assert profiling.host_read("site", torch.tensor([0, 2]).any())
    assert not profiling.host_read("site", torch.tensor(False))
    env = envelope.preprocess(_recording(0, 20)[None].astype(np.float32), SR, CFG,
                              device="cpu")[0]
    host.to_host(_analyze(env))


def test_host_read_is_a_sync_span(tmp_path):
    (got,), spans, _ = _traced(tmp_path, lambda: profiling.host_read("probe", torch.ones(1)))
    assert got is True and [s[0] for s in spans] == ["bpm.sync.probe"]


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_stage_table_on_a_hand_made_trace():
    events = [
        _ev("user_annotation", "bpm.extrema", 0, 100),
        _ev("user_annotation", "bpm.sync.nms", 40, 20),
        _ev("user_annotation", "bpm.metrics", 100, 50),
        _ev("user_annotation", "other", 0, 200),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 5, 1), _ev("kernel", "k1", 20, 30, 1),
        _ev("cuda_runtime", "cudaStreamSynchronize", 45, 10),
        _ev("cuda_runtime", "cudaMemcpyAsync", 90, 20, 2),   # ends after the span
        _ev("gpu_memcpy", "Memcpy DtoH", 95, 10, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 5, 3, tid=2),   # another thread
        _ev("kernel", "k3", 125, 10, 3),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 130, 5, 4), _ev("kernel", "k4", 135, 7, 4),
        {"ph": "i", "name": "mark", "ts": 5},
    ]
    table = profiling.stage_table(events)
    assert set(table) == {"bpm.extrema", "bpm.sync.nms", "bpm.metrics"}
    assert table["bpm.extrema"] == pytest.approx(
        {"spans": 1, "host_ms": 0.1, "device_ms": 0.03, "launches": 1})
    assert table["bpm.sync.nms"] == pytest.approx(
        {"spans": 1, "host_ms": 0.02, "device_ms": 0.0, "launches": 0})
    assert table["bpm.metrics"] == pytest.approx(
        {"spans": 1, "host_ms": 0.05, "device_ms": 0.007, "launches": 1})
