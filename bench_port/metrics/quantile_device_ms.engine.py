"""Device ms per call of the exact row quantiles: the kernels, memcpys and
memsets whose launching runtime call (by correlation id) lies inside the
program's ``bpm.quantile`` span; None where the program has no such span."""
from bench_port.yardstick import spans

QUANTILE = spans.named("bpm.quantile")


def read(run):
    if not spans.spans(run.trace, QUANTILE):
        return None
    return spans.launched_device_s(run.trace, QUANTILE) * 1e3 / run.trace.calls
