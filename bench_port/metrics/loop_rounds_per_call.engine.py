"""Rounds of the data-dependent host loops per call: the program's
``bpm.nms.round`` (a round of the distance NMS, ``ops/find_peaks``) and
``bpm.fix.round`` (a round of the corrections' fix loop,
``models/corrections``) spans in the traced window over the traced calls;
None where the program has no such span."""
from bench_port.yardstick import spans

ROUNDS = spans.named("bpm.nms.round", "bpm.fix.round")


def read(run):
    rounds = spans.spans(run.trace, ROUNDS)
    if not rounds:
        return None
    return len(rounds) / run.trace.calls
