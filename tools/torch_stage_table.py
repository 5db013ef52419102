#!/usr/bin/env python3
"""Where a benchmark cell's time goes, by the program's own ``bpm.*`` spans.

    python3 tools/torch_stage_table.py --workload fleet-b512 --seed 7 [--sites] [--save PATH]

Runs one traced run of the cell through ``bench_port`` (the benchmark's own
set-up, traced calls and capture; a card is needed) and prints, per traced
call:

* each span name's count, host ms, device ms (kernels, copies and memsets
  whose runtime call lies inside it, by correlation id) and launches
  (``utils/profiling.stage_table``); a ``bpm.sync.<site>`` count is the
  site's rounds;
* the largest device ops of each stage, each device event given to the
  innermost span (other than ``bpm.sync.*``) around its runtime call;
* coverage: the share of device time launched from inside a span other than
  ``bpm.request``, the share of the window's device-idle time inside such a
  span, and every blocking runtime call (``cudaStreamSynchronize``,
  ``cudaDeviceSynchronize``, ``cudaEventSynchronize``,
  ``aten::_local_scalar_dense``) outside a ``bpm.sync.*`` or
  ``bpm.to_device`` span;
* under ``--sites``, the program's lines that read a device value on the
  host or copy between host and card without ``non_blocking`` (a
  ``TorchDispatchMode`` around the traced calls, which slows them), each
  with its count per call.

The last line of standard output is the whole as JSON; ``--save`` writes
the trace's events as gzipped JSON.  Exits 2 without a card."""
import argparse
import collections
import contextlib
import gzip
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "aten::_local_scalar_dense")


def innermost(trace, events, keep) -> list:
    """For each of ``events`` (host events), the innermost ``bpm.*`` span
    on its thread whose name ``keep`` accepts and which holds it, or None;
    spans nest on a thread, so the innermost open one is the last pushed."""
    opened = sorted(((e["ts"], -e["dur"], i) for i, e in enumerate(trace.host)
                     if e.get("cat") == "user_annotation" and e["name"].startswith("bpm.")
                     and keep(e["name"])))
    order = sorted(range(len(events)), key=lambda i: events[i]["ts"])
    out = [None] * len(events)
    stacks: dict = {}
    j = 0
    for i in order:
        e = events[i]
        while j < len(opened) and opened[j][0] <= e["ts"]:
            s = trace.host[opened[j][2]]
            stacks.setdefault(s.get("tid"), []).append(s)
            j += 1
        stack = stacks.get(e.get("tid"), [])
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"] + e["dur"]:
            stack.pop()
        out[i] = stack[-1]["name"] if stack else None
    return out


def site_recorder():
    """A ``TorchDispatchMode`` that counts, by the program's innermost three
    lines on the stack, every host read of a device value and every copy
    between host and card that waits for the card."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    def dev(x):
        return x.device.type if isinstance(x, torch.Tensor) else None

    class Sites(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            kind = None
            if func is aten._local_scalar_dense.default:
                kind = "read"
            elif func is aten.lift_fresh.default and dev(args[0]) == "cuda":
                kind = "h2d (torch.tensor on the card)"
            elif func is aten._to_copy.default and not kwargs.get("non_blocking"):
                to = kwargs.get("device")
                to = torch.device(to).type if to is not None else dev(args[0])
                if {dev(args[0]), to} == {"cpu", "cuda"}:
                    kind = f"{dev(args[0])} -> {to}"
            elif func is aten.copy_.default:
                blocking = not (args[2] if len(args) > 2 else kwargs.get("non_blocking"))
                if blocking and {dev(args[0]), dev(args[1])} == {"cpu", "cuda"}:
                    kind = f"{dev(args[1])} -> {dev(args[0])}"
            if kind is not None:
                lines = [f"{fs.filename.split('bpm_analysis_tpu_torch/')[-1]}:{fs.lineno}"
                         for fs in traceback.extract_stack()
                         if "bpm_analysis_tpu_torch" in fs.filename
                         and not fs.filename.endswith("utils/profiling.py")]
                self.count[(kind, " < ".join(reversed(lines[-3:])))] += 1
            return func(*args, **kwargs)

    return Sites()


def report(events, calls) -> dict:
    from bench_port import trace as tracing
    from bench_port.yardstick import spans
    from bpm_analysis_tpu_torch.utils import profiling

    tr = tracing.Trace(events, calls)
    in_window = [e for e in events if e.get("ph") == "X" and "dur" in e
                 and tr.t0 <= e["ts"] <= tr.t1]
    table = {name: {k: v / calls for k, v in row.items()}
             for name, row in sorted(profiling.stage_table(in_window).items())}
    named = lambda name: name != "bpm.request"  # noqa: E731
    device_s = sum(e["dur"] for e in tr.device) * 1e-6
    idle_s = tr.window_s - tr.busy_s
    # Device ops by the innermost stage that launched them.
    runtime = [e for e in tr.host if e.get("cat") in spans.RUNTIME_CATS]
    stage_of = dict(zip((e.get("args", {}).get("correlation") for e in runtime),
                        innermost(tr, runtime, lambda n: not n.startswith(spans.SYNC))))
    by_stage: dict = {}
    for e in tr.device:
        stage = stage_of.get(e.get("args", {}).get("correlation"))
        ops = by_stage.setdefault(str(stage), {})
        ops[e["name"][:100]] = ops.get(e["name"][:100], 0.0) + e["dur"] * 1e-3 / calls
    top_ops = {stage: sorted(ops.items(), key=lambda kv: -kv[1])[:4]
               for stage, ops in sorted(by_stage.items())}
    blocking = [e for e in tr.host if e["name"] in BLOCKING]
    allowed = innermost(tr, blocking,
                        lambda n: n.startswith(spans.SYNC) or n == "bpm.to_device")
    inner = innermost(tr, blocking, lambda n: True)
    outside = [{"name": e["name"], "ts": e["ts"], "span": s}
               for e, a, s in zip(blocking, allowed, inner) if a is None]
    return {
        "calls": calls, "window_s": tr.window_s, "busy_s": tr.busy_s,
        "stages_per_call": table,
        "top_device_ms_per_call_by_stage": top_ops,
        "device_share_in_spans": spans.launched_device_s(tr, named) / device_s
        if device_s else None,
        "idle_share_in_spans": spans.idle_inside_s(tr, named) / idle_s if idle_s else None,
        "idle_share_in_any_span": spans.idle_inside_s(tr, lambda n: True) / idle_s
        if idle_s else None,
        "blocking_calls": len(blocking),
        "blocking_outside_sync_spans": outside,
        "idle_gaps": tr.idle_gaps(),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sites", action="store_true")
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_table: no CUDA device", file=sys.stderr)
        return 2
    from bench_port import core
    from bench_port import trace as tracing

    saved = {}
    sites = site_recorder()
    bench_capture = tracing.capture

    @contextlib.contextmanager
    def capture(out):
        with bench_capture(out), sites if args.sites else contextlib.nullcontext():
            yield
        saved.update(out)

    tracing.capture = capture
    result = core.run_cell(args.workload, args.seed % (1 << 64), 0.0, True, "cuda")
    out = report(saved["events"], len([1 for e in saved["events"]
                                       if e.get("name") == tracing.CALL
                                       and e.get("cat") == "user_annotation"]))
    out["result"] = {k: result[k] for k in ("correct", "metrics", "device")}
    if args.sites:
        out["sites_per_call"] = [[kind, where, n / out["calls"]]
                                 for (kind, where), n in sites.count.most_common()]
    if args.save:
        with gzip.open(args.save, "wt") as f:
            json.dump(saved["events"], f)
    for name, row in out["stages_per_call"].items():
        print(f"{name:32s} {row['spans']:8.2f} spans {row['host_ms']:10.3f} host ms "
              f"{row['device_ms']:10.3f} device ms {row['launches']:9.1f} launches",
              file=sys.stderr)
    for key in ("device_share_in_spans", "idle_share_in_spans", "idle_share_in_any_span",
                "blocking_calls"):
        print(f"{key}: {out[key]}", file=sys.stderr)
    for b in out["blocking_outside_sync_spans"]:
        print(f"blocking outside a sync span: {b}", file=sys.stderr)
    for kind, where, n in out.get("sites_per_call", []):
        print(f"site {kind}: {n:g} a call at {where}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
