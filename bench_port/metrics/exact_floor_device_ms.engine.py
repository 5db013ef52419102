"""Device ms per call of the exact stride-1 noise floor: the kernels,
memcpys and memsets whose launching runtime call (by correlation id) lies
inside the program's ``bpm.rolling_exact`` span (the wavelet-tree rolling
quantile, twice a batch); None where the program has no such span."""
from bench_port.yardstick import spans

EXACT = spans.named("bpm.rolling_exact")


def read(run):
    if not spans.spans(run.trace, EXACT):
        return None
    return spans.launched_device_s(run.trace, EXACT) * 1e3 / run.trace.calls
