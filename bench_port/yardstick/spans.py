"""The program's own spans in a traced run: ``torch.profiler``
``record_function`` ranges named ``bpm.*``, which the port opens at its
layer boundaries and which share the trace's clock with every runtime call
and device event.  A device event belongs to a span when the runtime call
that launched it (the same ``args.correlation``) lies inside the span on
the span's thread.  A run of a program without spans reads None."""
import bisect

PREFIX = "bpm."
SYNC = "bpm.sync."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def spans(trace, match) -> list:
    """The ``bpm.*`` spans of the traced window whose name ``match``
    accepts, as (start, end, thread) in microseconds; none without a
    trace."""
    if trace is None:
        return []
    return [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in trace.host
            if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)
            and match(e["name"])]


def has_spans(trace) -> bool:
    return bool(spans(trace, lambda name: True))


def named(*names):
    return lambda name: name in names


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _inside(merged, starts, a, b) -> bool:
    """Whether [a, b] lies inside one interval of ``merged``."""
    i = bisect.bisect_right(starts, a) - 1
    return i >= 0 and b <= merged[i][1]


def launched_device_s(trace, match) -> float:
    """Device seconds of the kernels, memcpys and memsets whose launching
    runtime call lies inside a span that ``match`` accepts."""
    by_thread: dict = {}
    for a, b, tid in spans(trace, match):
        by_thread.setdefault(tid, []).append((a, b))
    merged = {tid: _union(iv) for tid, iv in by_thread.items()}
    starts = {tid: [m[0] for m in iv] for tid, iv in merged.items()}
    corr = set()
    for e in trace.host:
        tid = e.get("tid")
        if e.get("cat") in RUNTIME_CATS and tid in merged \
                and _inside(merged[tid], starts[tid], e["ts"], e["ts"] + e["dur"]):
            corr.add(e.get("args", {}).get("correlation"))
    corr.discard(None)
    return sum(e["dur"] for e in trace.device
               if e.get("args", {}).get("correlation") in corr) * 1e-6


def idle_inside_s(trace, match) -> float:
    """Seconds of the traced window in which the device ran nothing and a
    span that ``match`` accepts was open."""
    covered = _union([(max(a, trace.t0), min(b, trace.t1))
                      for a, b, _ in spans(trace, match) if b > trace.t0 and a < trace.t1])
    busy = trace.busy
    idle = 0.0
    for a, b in covered:
        overlap = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
        idle += (b - a) - overlap
    return idle * 1e-6


def host_s(trace, match) -> float:
    """Host seconds inside the spans that ``match`` accepts (nested spans
    of one name counted once)."""
    return sum(b - a for a, b in _union([(a, b) for a, b, _ in spans(trace, match)])) * 1e-6
