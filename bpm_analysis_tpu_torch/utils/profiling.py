"""Performance tracing (reference: wall-clock timing only,
bpm_analysis.py:1727,1767-1768).

Port of ``bpm_analysis_tpu/utils/profiling.py``: wall-clock stage timers
plus a ``torch.profiler`` capture (CPU and CUDA activities) for
kernel-level inspection."""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch


def _sync() -> None:
    """Wait for the card's queued work, if this process has used a card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str, results: dict | None = None):
    """Wall-clock stage timer (logs like the reference's per-run duration
    line).  In a process that has used the card, the card is synchronized
    before each clock read, so the interval holds the device work issued
    inside it."""
    _sync()
    t0 = time.time()
    yield
    _sync()
    dt = time.time() - t0
    if results is not None:
        results[name] = dt
    logging.info(f"--- {name} finished in {dt:.2f} seconds. ---")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, when a card is
    present, CUDA activity; on exit it is written into ``log_dir`` as a
    Chrome trace (``trace.json``: chrome://tracing, Perfetto).  Yields the
    profiler, whose ``key_averages()`` tables the kernels' times."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
