"""Host ms per request inside the program's ``bpm.read`` span: the WAV
read, its cast and its padding."""
from bench_port.yardstick import spans

READ = spans.named("bpm.read")


def read(run):
    if not spans.spans(run.trace, READ):
        return None
    return spans.host_s(run.trace, READ) * 1e3 / run.trace.calls
