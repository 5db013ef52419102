"""Kernel launches per call inside the program's ``bpm.rolling_exact`` span
(the exact stride-1 noise floor): the CPU-side launch calls that lie inside
the span on its thread, over the traced calls; None where the program has
no such span."""
from bench_port import trace as tracing
from bench_port.yardstick import spans

EXACT = spans.named("bpm.rolling_exact")


def read(run):
    inside = spans.spans(run.trace, EXACT)
    if not inside:
        return None
    launches = sum(
        1 for e in run.trace.host
        if e.get("cat") in spans.RUNTIME_CATS and e.get("name") in tracing.LAUNCH_CALLS
        and any(tid == e.get("tid") and a <= e["ts"] and e["ts"] + e["dur"] <= b
                for a, b, tid in inside))
    return launches / run.trace.calls
