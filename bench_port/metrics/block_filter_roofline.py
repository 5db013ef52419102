"""``csrc/block_filter.cu``'s share of its roofline: the least time of the
call's two filtfilt passes (``yardstick/bounds.filter_ms`` over the rows
with their odd extension, blocks of 256, 2 x order states) over the device
time of the kernel's three launches per pass, %."""
from bench_port.yardstick import bounds, readers

ORDER = 2       # the band-pass order of the configurations (20-150 Hz Butterworth)


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(readers.FILTER.match)
    if t <= 0:
        return None
    sh = run.shapes
    n_ext = sh["n"] + 2 * 3 * (2 * ORDER + 1)
    item = readers.ITEMSIZE[run.config["runtime"]["dtype"]]
    pass_ms = bounds.filter_ms(sh["batch"], n_ext, min(256, max(8, n_ext)), 2 * ORDER, item)[0]
    return 100.0 * 2 * pass_ms * 1e-3 * run.trace.calls / t
