"""The metric readers on a hand-made trace and lane record give known
numbers; a reader that finds nothing returns None."""
import pytest

from bench_port import core, trace
from bench_port.yardstick import bounds

N = 181_200


def ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}


def hand_trace():
    """Two calls over 0-1000 us; device busy 100-300, 250-400 (overlap),
    600-700 and a kernel half outside the window; 4 launches inside."""
    return [
        ev("user_annotation", trace.CALL, 0, 500), ev("user_annotation", trace.CALL, 500, 500),
        ev("cpu_op", "aten::add", 80, 40), ev("cpu_op", "aten::item", 420, 150),
        ev("cpu_op", "aten::_local_scalar_dense", 430, 120),
        ev("cuda_runtime", "cudaLaunchKernel", 90, 5), ev("cuda_runtime", "cudaLaunchKernel", 95, 5),
        ev("cuda_driver", "cuLaunchKernel", 590, 5), ev("cuda_runtime", "cudaLaunchKernelExC", 595, 5),
        ev("cuda_runtime", "cudaMemcpyAsync", 240, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 1200, 5),
        ev("kernel", "void (anonymous namespace)::classify_scan_kernel<float, true, false>(int "
                     "const*)", 100, 200),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 250, 150),
        ev("kernel", "void (anonymous namespace)::apply_kernel<float>(float const*)", 600, 60),
        ev("kernel", "void carry_kernel<float>(float const*)", 660, 40),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()", 950, 100),
        ev("kernel", "void classify_scan_kernel<float>(int const*)", 2000, 50),
    ]


def run_of(tr, records=(), shapes=None):
    from types import SimpleNamespace

    return SimpleNamespace(trace=tr, records=list(records),
                           window_s=2.0, shapes=shapes or {"batch": 128, "n": N, "rate": 302},
                           config=core.load_json(core.HERE, "configs", "engine-302hz.json"))


def test_trace_reduction():
    tr = trace.Trace(hand_trace(), calls=2)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx((300 + 100 + 50) * 1e-6)
    assert tr.launches == 4
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["(host outside torch ops)", "aten::_local_scalar_dense",
                                   "(host outside torch ops)"]
    assert [g[1] for g in gaps] == pytest.approx([250e-6, 200e-6, 100e-6])
    assert tr.top_device_ops()[0][1] == pytest.approx(200e-6)
    assert "classify_scan_kernel" in tr.top_device_ops()[0][0]


def test_device_readers():
    run = run_of(trace.Trace(hand_trace(), calls=2))
    assert core.reader("launches_per_call.engine")(run) == 2.0
    assert core.reader("launches_per_call.request")(run) == 2.0
    for cell in ("engine", "request"):
        assert core.reader(f"device_idle_pct.{cell}")(run) == pytest.approx(55.0)
    cls = 2 * 1e-3 * sum(bounds.classify_scan_ms(128, 2560, 4, t)[0] for t in (False, True))
    assert core.reader("classify_scan_roofline")(run) == pytest.approx(100 * cls / 200e-6)
    n_ext = N + 30
    flt = 2 * 2 * 1e-3 * bounds.filter_ms(128, n_ext, 256, 4, 4)[0]
    assert core.reader("block_filter_roofline")(run) == pytest.approx(100 * flt / 100e-6)


def test_readers_without_their_source():
    empty = run_of(None)
    for name in ("launches_per_call.engine", "device_idle_pct.engine",
                 "classify_scan_roofline", "block_filter_roofline",
                 "launches_per_call.request", "device_idle_pct.request"):
        assert core.reader(name)(empty) is None
    no_kernels = run_of(trace.Trace([e for e in hand_trace() if e["cat"] != "kernel"], 2))
    assert core.reader("classify_scan_roofline")(no_kernels) is None
    assert core.reader("block_filter_roofline")(no_kernels) is None


def test_host_readers():
    recs = [{"t0": 0.0, "t1": t, "audio_min": 160.0, "files": 16} for t in (1.0, 2.0, 3.0, 4.0)]
    run = run_of(None, recs)
    assert core.reader("engine_audio_min_per_s")(run) == pytest.approx(640 / 2.0)
    lat = [{"t0": 0.0, "t1": k / 1000, "audio_min": 10.0} for k in range(1, 101)]
    assert core.reader("request_p90_ms")(run_of(None, lat)) == pytest.approx(90.1)
