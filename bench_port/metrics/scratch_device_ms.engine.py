"""Device ms per call of the kernels' global-scratch paths: the kernels,
memcpys and memsets whose launching runtime call (by correlation id) lies
inside the program's ``bpm.scratch`` span (a distance-NMS or metrics launch
whose rows take a global scratch region); None where no launch took scratch
or the program has no such span."""
from bench_port.yardstick import spans

SCRATCH = spans.named("bpm.scratch")


def read(run):
    if not spans.spans(run.trace, SCRATCH):
        return None
    return spans.launched_device_s(run.trace, SCRATCH) * 1e3 / run.trace.calls
