"""``csrc/classify_scan.cu``'s share of its roofline: the least time of a
call's two scans (the preliminary pass without the trace, the main pass
with it; ``yardstick/bounds.classify_scan_ms`` over the batch and the raw
peak capacity) over the device time of the kernel's launches per call, %."""
from bench_port.yardstick import bounds, readers


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(readers.CLASSIFY.match)
    if t <= 0:
        return None
    rt = run.config["runtime"]
    sh = run.shapes
    cap = min(rt["max_raw_peaks"], bounds.distance_capacity(sh["n"], int(0.05 * sh["rate"])))
    item = readers.ITEMSIZE[rt["dtype"]]
    bound_ms = sum(bounds.classify_scan_ms(sh["batch"], cap, item, tr)[0] for tr in (False, True))
    return 100.0 * bound_ms * 1e-3 * run.trace.calls / t
