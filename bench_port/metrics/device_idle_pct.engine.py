"""The share of the traced window in which no kernel, memcpy or memset
ran on the card, %."""
from bench_port.yardstick import readers


def read(run):
    return readers.device_idle_pct(run)
