"""Performance tracing (reference: wall-clock timing only,
bpm_analysis.py:1727,1767-1768).

The program marks its layers with ``span``: named ranges that exist only
inside a ``torch.profiler`` capture, where they share the clock of every
kernel, copy and runtime call they enclose.  With no capture active a span
is one flag read.  ``host_read`` is the program's one way to read a device
value on the host, each read inside its own ``bpm.sync.<site>`` span
(``sync``, which ``device.upload`` also puts around the copies of host
constants to the card), so a trace counts the blocking exchanges.  ``device_trace`` is the operator's
capture: it writes the Chrome trace that holds the spans, and
``stage_table`` reduces such a trace to the spans' host and device time."""
from __future__ import annotations

import bisect
import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")


def span(name: str):
    """A context manager naming the block ``name`` in an active
    ``torch.profiler`` capture (``record_function``); otherwise a shared
    no-op: one flag read, no dispatcher call, no allocation, no
    synchronisation."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def span_if(condition: bool, name: str):
    """``span(name)`` where ``condition`` holds, else the shared no-op."""
    return span(name) if condition else _NO_SPAN


def sync(site: str):
    """The span ``bpm.sync.<site>`` around an exchange with the card that
    waits for it (a host read of a device value, a copy from pageable host
    memory); with no capture active, ``span``'s shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"bpm.sync.{site}")
    return _NO_SPAN


def host_read(site: str, tensor: torch.Tensor) -> bool:
    """``bool(tensor)``: a blocking read of the device on the host, inside
    ``sync(site)``."""
    with sync(site):
        return bool(tensor)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, when a card is
    present, CUDA activity; on exit it is written into ``log_dir`` as a
    Chrome trace (``trace.json``: chrome://tracing, Perfetto), the
    program's ``bpm.*`` spans among its events.  Yields the profiler, whose
    ``key_averages()`` tables the kernels' times."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def stage_table(events: list) -> dict:
    """Each ``bpm.*`` span name of a Chrome trace's ``traceEvents`` (as
    ``device_trace`` writes them): ``spans`` (how many; for a
    ``bpm.sync.*`` site, its rounds), ``host_ms`` inside them,
    ``device_ms`` of the kernels, copies and memsets whose runtime call (by
    correlation id) lies inside one of them on its thread, and the kernel
    ``launches`` among those calls.  Nested spans count in each of their
    names."""
    done = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device: dict = {}
    for e in done:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and corr is not None:
            device[corr] = device.get(corr, 0.0) + e["dur"]
    calls: dict = {}
    for e in done:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            calls.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"], device.get(corr, 0.0), e["name"] in LAUNCH_CALLS))
    starts = {}
    for tid, rows in calls.items():
        rows.sort()
        starts[tid] = [r[0] for r in rows]
    table: dict = {}
    for e in done:
        if e.get("cat") != "user_annotation" or not e["name"].startswith("bpm."):
            continue
        a, b, tid = e["ts"], e["ts"] + e["dur"], e.get("tid")
        row = table.setdefault(e["name"], {"spans": 0, "host_ms": 0.0, "device_ms": 0.0,
                                           "launches": 0})
        row["spans"] += 1
        row["host_ms"] += e["dur"] * 1e-3
        if tid in calls:
            lo, hi = bisect.bisect_left(starts[tid], a), bisect.bisect_right(starts[tid], b)
            for _, end, dev_us, launch in calls[tid][lo:hi]:
                if end <= b:
                    row["device_ms"] += dev_us * 1e-3
                    row["launches"] += launch
    return table
