"""CUDA kernel launches issued by the host per request at B=1: the
profiler's CPU-side launch calls in the traced window over the traced
requests."""
from bench_port.yardstick import readers


def read(run):
    return readers.launches_per_call(run)
