"""The readers of the program's ``bpm.*`` spans on a hand-made trace give
known numbers, and None without a trace or without ``bpm.`` spans (a
program that has none)."""
import pytest

from bench_port import core, trace
from bench_port.tests.test_bench_metrics import run_of
from bench_port.yardstick import spans

SPAN_READERS = ("peaks_device_ms.engine", "transfer_idle_ms.engine",
                "host_syncs_per_call.engine", "host_syncs_per_call.request",
                "read_ms.request", "render_ms.request")


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def hand_trace():
    """Two calls over 0-1000 us on thread 1.  The peak stages launch 20 +
    10 + 30 us of device work in call 1 and 10 + 5 in call 2; a launch on
    thread 2 inside a stage's time does not belong to it.  The transfer
    spans hold 25 + 30 + 120 + 250 us of device idle."""
    return [
        ev("user_annotation", trace.CALL, 0, 500), ev("user_annotation", trace.CALL, 500, 500),
        span("bpm.read", 0, 10), span("bpm.to_device", 10, 50), span("bpm.extrema", 60, 60),
        span("bpm.noise_floor", 120, 80), span("bpm.sync.nms", 150, 20),
        span("bpm.raw_peaks", 200, 60), span("bpm.sync.nms", 230, 10),
        span("bpm.classify_main", 260, 90), span("bpm.to_host", 350, 130),
        span("bpm.sync.to_host", 400, 70), span("bpm.render", 480, 20),
        span("bpm.read", 500, 10), span("bpm.to_device", 510, 30), span("bpm.extrema", 540, 60),
        span("bpm.raw_peaks", 600, 100), span("bpm.sync.nms", 650, 10),
        span("bpm.to_host", 700, 250), span("bpm.render", 950, 50),
        ev("cuda_runtime", "cudaMemcpyAsync", 20, 30, 1),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30, 25, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 70, 5, 2), ev("kernel", "k_extrema", 80, 20, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 130, 5, 3), ev("kernel", "k_floor", 140, 10, 3),
        ev("cuda_runtime", "cudaStreamSynchronize", 155, 10),
        ev("cpu_op", "aten::_local_scalar_dense", 152, 16),
        ev("cuda_runtime", "cudaLaunchKernel", 210, 5, 5), ev("kernel", "k_raw", 215, 30, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 270, 5, 6), ev("kernel", "k_classify", 280, 60, 6),
        ev("cuda_runtime", "cudaMemcpyAsync", 360, 5, 7),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 380, 10, 7),
        ev("cuda_runtime", "cudaLaunchKernel", 545, 5, 8), ev("kernel", "k_extrema", 550, 10, 8),
        ev("cuda_runtime", "cudaLaunchKernel", 610, 5, 9, tid=2),
        ev("kernel", "k_other_thread", 620, 20, 9),
        ev("cuda_runtime", "cudaMemsetAsync", 620, 5, 10),
        ev("gpu_memset", "Memset (Device)", 625, 5, 10),
    ]


def test_span_readers_give_known_numbers():
    run = run_of(trace.Trace(hand_trace(), calls=2))
    assert core.reader("peaks_device_ms.engine")(run) == pytest.approx((60 + 15) / 2 * 1e-3)
    assert core.reader("transfer_idle_ms.engine")(run) == pytest.approx(
        (25 + 30 + 120 + 250) / 2 * 1e-3)
    for cell in ("engine", "request"):
        assert core.reader(f"host_syncs_per_call.{cell}")(run) == 2.0
    assert core.reader("read_ms.request")(run) == pytest.approx(10e-3)
    assert core.reader("render_ms.request")(run) == pytest.approx(35e-3)


def test_span_arithmetic():
    tr = trace.Trace(hand_trace(), calls=2)
    assert len(spans.spans(tr, lambda n: n.startswith(spans.SYNC))) == 4
    assert spans.launched_device_s(tr, spans.named("bpm.classify_main")) \
        == pytest.approx(60e-6)
    # Nothing was launched from the render span, and nested spans of one
    # name count once.
    assert spans.launched_device_s(tr, spans.named("bpm.render")) == 0.0
    assert spans.host_s(tr, spans.named("bpm.to_host", "bpm.sync.to_host")) \
        == pytest.approx(380e-6)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_without_their_source(name):
    assert core.reader(name)(run_of(None)) is None
    plain = [e for e in hand_trace() if not e["name"].startswith("bpm.")]
    assert core.reader(name)(run_of(trace.Trace(plain, calls=2))) is None


def test_stage_readers_without_their_stage():
    only_syncs = [e for e in hand_trace() if not e["name"].startswith("bpm.")
                  or e["name"].startswith("bpm.sync.")]
    run = run_of(trace.Trace(only_syncs, calls=2))
    assert core.reader("host_syncs_per_call.engine")(run) == 2.0
    for name in ("peaks_device_ms.engine", "transfer_idle_ms.engine", "read_ms.request",
                 "render_ms.request"):
        assert core.reader(name)(run) is None
