"""Arithmetic the metric readers share."""
import re
import statistics

ITEMSIZE = {"float32": 4, "float64": 8}
# Kernel names as the trace gives them: "void (anonymous namespace)::
# classify_scan_kernel<float, true, false>(...)".
CLASSIFY = re.compile(r"^void (\(anonymous namespace\)::)?classify_scan_kernel<")
FILTER = re.compile(r"^void (\(anonymous namespace\)::)?(contributions|carry|apply)_kernel<")


def audio_rate(run):
    """Audio-minutes of the answers completed in the window, per second."""
    return sum(r["audio_min"] for r in run.records) / run.window_s


def percentile_ms(run, pct: int):
    """The ``pct``-th percentile of the calls' latencies, ms."""
    lat = [r["t1"] - r["t0"] for r in run.records]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[pct - 1] * 1e3


def launches_per_call(run):
    if run.trace is None or run.trace.launches == 0:
        return None
    return run.trace.launches / run.trace.calls


def device_idle_pct(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
