"""CUDA kernel launches issued by the host per call: the profiler's
CPU-side launch calls in the traced window over the traced calls."""
from bench_port.yardstick import readers


def read(run):
    return readers.launches_per_call(run)
