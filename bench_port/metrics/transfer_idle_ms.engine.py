"""Device-idle ms per call while the program moves data between host and
card: the idle time of the traced window inside its ``bpm.to_device`` or
``bpm.to_host`` span (pageable staging, pinned allocations, the wait)."""
from bench_port.yardstick import spans

TRANSFERS = spans.named("bpm.to_device", "bpm.to_host")


def read(run):
    if not spans.spans(run.trace, TRANSFERS):
        return None
    return spans.idle_inside_s(run.trace, TRANSFERS) * 1e3 / run.trace.calls
