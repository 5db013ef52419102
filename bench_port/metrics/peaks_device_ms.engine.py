"""Device ms per call of the peak-finding stages: the kernels, memcpys and
memsets whose launching runtime call (by correlation id) lies inside the
program's ``bpm.extrema``, ``bpm.noise_floor`` or ``bpm.raw_peaks`` span."""
from bench_port.yardstick import spans

STAGES = spans.named("bpm.extrema", "bpm.noise_floor", "bpm.raw_peaks")


def read(run):
    if not spans.spans(run.trace, STAGES):
        return None
    return spans.launched_device_s(run.trace, STAGES) * 1e3 / run.trace.calls
