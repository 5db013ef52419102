"""Blocking host reads per request: the program's ``bpm.sync.*`` spans in
the traced window over the traced requests."""
from bench_port.yardstick import spans


def read(run):
    if not spans.has_spans(run.trace):
        return None
    return len(spans.spans(run.trace, lambda name: name.startswith(spans.SYNC))) \
        / run.trace.calls
