"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activities) around the traced calls, exported as a Chrome trace and reduced
to what the per-layer readers take.

The window runs from the start of the first call's ``bench_port.call``
annotation to the end of the last one's (every call ends with its results
on the host, so its device work lies inside).  Device activity is the union
of kernel, memcpy and memset intervals inside the window.  Launches are the
CPU-side CUDA runtime and driver calls that launch a kernel."""
import contextlib
import json
import os
import tempfile

CALL = "bench_port.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def capture(out: dict):
    """Profile the block; on exit ``out["events"]`` holds the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """The reduced trace: times in microseconds on the trace's clock."""

    def __init__(self, events: list, calls: int):
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in complete if e.get("name") == CALL
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError("the trace holds no call annotation")
        self.t0 = min(e["ts"] for e in marks)
        self.t1 = max(e["ts"] + e["dur"] for e in marks)
        self.calls = calls
        inside = [e for e in complete if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.launches = sum(1 for e in inside if e.get("cat") in ("cuda_runtime", "cuda_driver")
                            and e.get("name") in LAUNCH_CALLS)
        self.host = [e for e in inside if e.get("cat") in HOST_CATS and e.get("name") != CALL]
        clip = [(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)) for e in self.device]
        self.busy = _union(clip)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(e["dur"] for e in self.kernels if match(e["name"])) * 1e-6

    def kernel_count(self, match) -> int:
        return sum(1 for e in self.kernels if match(e["name"]))

    def top_device_ops(self, k: int = 10) -> list:
        totals: dict = {}
        for e in self.device:
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"] * 1e-6
        return sorted(([n[:120], s] for n, s in totals.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps of the device, each named by the
        innermost host event running at its middle."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
                if edges[j + 1] > edges[j]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (a + b) / 2
            around = [e for e in self.host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = (min(around, key=lambda e: e["dur"])["name"][:120] if around
                    else "(host outside torch ops)")
            out.append([name, (b - a) * 1e-6])
        return out
