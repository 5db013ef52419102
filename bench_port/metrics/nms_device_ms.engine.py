"""Device ms per call of the peak finders' distance NMS: the kernels,
memcpys and memsets whose launching runtime call (by correlation id) lies
inside the program's ``bpm.nms`` span (the distance-NMS kernel's launch,
twice a call); None where the program has no such span."""
from bench_port.yardstick import spans

NMS = spans.named("bpm.nms")


def read(run):
    if not spans.spans(run.trace, NMS):
        return None
    return spans.launched_device_s(run.trace, NMS) * 1e3 / run.trace.calls
