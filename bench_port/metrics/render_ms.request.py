"""Host ms per request inside the program's ``bpm.render`` span: the
filtered WAV, settings, BPM CSV, summary, debug log and plot."""
from bench_port.yardstick import spans

RENDER = spans.named("bpm.render")


def read(run):
    if not spans.spans(run.trace, RENDER):
        return None
    return spans.host_s(run.trace, RENDER) * 1e3 / run.trace.calls
