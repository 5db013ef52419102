"""Device ms per call of the carry-dependent scans: the kernels, memcpys and
memsets whose launching runtime call (by correlation id) lies inside the
program's ``bpm.scan`` span (the classifier scan's two launches and the
rhythm scan's one, three a call); None where the program has no such span."""
from bench_port.yardstick import spans

SCAN = spans.named("bpm.scan")


def read(run):
    if not spans.spans(run.trace, SCAN):
        return None
    return spans.launched_device_s(run.trace, SCAN) * 1e3 / run.trace.calls
