"""Host ms per call inside the rounds of the data-dependent host loops: the
program's ``bpm.nms.round`` and ``bpm.fix.round`` spans in the traced
window, their union's length over the traced calls (the host read that
decides each next round lies outside them); None where the program has no
such span."""
from bench_port.yardstick import spans

ROUNDS = spans.named("bpm.nms.round", "bpm.fix.round")


def read(run):
    if not spans.spans(run.trace, ROUNDS):
        return None
    return spans.host_s(run.trace, ROUNDS) * 1e3 / run.trace.calls
