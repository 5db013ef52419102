"""The 90th percentile of every request's latency in the window, from the
call to its return, ms."""
from bench_port.yardstick import readers


def read(run):
    return readers.percentile_ms(run, 90)
