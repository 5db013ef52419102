"""One run of one cell, found by name: ``BENCHMARK.json`` names the cell's
configuration (``configs/<config>.json``) and traffic mix
(``workloads/<traffic>.json``); the mix names its generator
(``traffic/<kind>.py``) and the port's entry it drives
(``entries/<kind>.py``); each metric is read by ``metrics/<name>.py``.

A run: generate the inputs from the seed, set up the program and warm it
on the cell's own shapes (``setup_s`` ends here), then either call the
entry back to back for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or call it ``traced_calls`` times under the profiler (``--trace
1``: the per-layer metrics).  After the window: the device's memory peak,
then every answer the window returned compared with the upstream
analyzer's answer for the same recording, each number against its limit."""
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bpm_analysis_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> SimpleNamespace:
    """The cell, its configuration, its traffic mix and its metrics."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    applies = lambda m: name in m.get("workloads", [name])  # noqa: E731
    return SimpleNamespace(
        name=name, cell=cell, bench=bench,
        config=load_json(HERE, "configs", f"{cell['config']}.json"),
        workload=load_json(HERE, "workloads", f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's, Flax's
    or the JAX package's (whole names: the port's name begins with the JAX
    package's)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def program_config(runtime: dict):
    from bpm_analysis_tpu_torch.config import AnalyzerConfig, RuntimeConfig

    return AnalyzerConfig(runtime=RuntimeConfig(**runtime))


def check(spec, entry, state, records: list) -> tuple:
    """(correct, {number: (value, limit)}): every answer of every call in
    the window, and every BPM CSV the last call left, against the upstream
    analyzer's answer for the same recording."""
    from .reference import compare, upstream

    pool = upstream.pool(spec.workload["traffic"]["pool"])
    readings, failed, compared = [], sum(r["failed"] for r in records), 0
    for rec in records:
        for rid, ans in entry.answers(state, rec):
            if ans is None:
                continue                    # counted in the record's failed
            if rid not in pool.ids:
                failed += 1
                continue
            readings.append(compare.numbers(ans, pool.answer(rid)))
            compared += 1
    csvs = entry.csvs(state)
    for rid, series in csvs:
        if series is None or rid not in pool.ids:
            failed += 1
            continue
        ref = pool.answer(rid)
        readings.append({"csv_mae": compare.series_mae(*series, ref["bpm_times"], ref["bpm"])})
    print(f"compared {compared} answers and {len(csvs)} BPM CSVs with the upstream answers",
          file=sys.stderr)
    worst = compare.worst(readings)
    worst["answers_failed"] = float(failed + (compared == 0))
    limits = spec.workload["check"]["limits"]
    out = {name: (worst.get(name, float("inf")), limit) for name, limit in limits.items()}
    return all(v <= lim for v, lim in out.values()), out


@contextlib.contextmanager
def bfloat16_envelope():
    """The control: the program with its envelope, which every stage after
    preprocessing reads, rounded to bfloat16 (the precision below the
    configurations' float32) before ``pipeline.analyze_envelope``."""
    import torch
    from bpm_analysis_tpu_torch.models import pipeline

    real = pipeline.analyze_envelope

    def analyze_envelope(envelope, *args, **kwargs):
        return real(envelope.to(torch.bfloat16).to(envelope.dtype), *args, **kwargs)

    pipeline.analyze_envelope = analyze_envelope
    try:
        yield
    finally:
        pipeline.analyze_envelope = real


def host_state() -> dict:
    """What the host was doing: this process's CPU time, context switches
    and CPU, and the machine's load."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        cpu = -1
    return {"utime": ru.ru_utime, "stime": ru.ru_stime, "nvcsw": ru.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw, "cpu": cpu, "load1": os.getloadavg()[0]}


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query>``, one CSV line a card."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


class GcTimer:
    """Collections of each generation and their seconds while installed."""

    def __init__(self):
        self.count, self.seconds, self._t = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, overrides: dict = None, control: bool = False) -> dict:
    """The result of one run.  ``device="cpu"`` and ``overrides`` (merged
    into the traffic mix's file) are for the CPU tests; ``control`` runs the
    program with its envelope in bfloat16 (``bfloat16_envelope``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(name)
    wl = spec.workload = merged(spec.workload, overrides or {})
    traffic = importlib.import_module(f".traffic.{wl['traffic']['kind']}", __package__)
    entry = importlib.import_module(f".entries.{wl['entry']['kind']}", __package__)
    import torch

    cuda = device == "cuda"
    workdir = tempfile.mkdtemp(prefix="bench_port-")
    try:
        with bfloat16_envelope() if control else contextlib.nullcontext():
            inputs = traffic.make(wl["traffic"], seed, os.path.join(workdir, "out"))
            ctx = SimpleNamespace(seed=seed, device=device, inputs=inputs, config=spec.config,
                                  program_config=program_config(spec.config["runtime"]),
                                  entry=wl["entry"])
            state = entry.setup(ctx)
            for i in range(wl["warmup_calls"]):
                entry.call(state, i)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.perf_counter() - t_start
            records, events = [], {}
            i = wl["warmup_calls"]
            host0 = host_state()
            with GcTimer() as gct:
                if not trace:
                    t0 = time.perf_counter()
                    while not records or records[-1]["t1"] - t0 < seconds:
                        records.append(entry.call(state, i))
                        i += 1
                    window_s = records[-1]["t1"] - t0
                else:
                    from . import trace as tracing

                    with tracing.capture(events) if cuda else contextlib.nullcontext():
                        for _ in range(wl["traced_calls"]):
                            with torch.profiler.record_function(tracing.CALL):
                                records.append(entry.call(state, i))
                            i += 1
                    window_s = records[-1]["t1"] - records[0]["t0"]
            host1 = host_state()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        print(f"setup {setup_s:.3f} s; window {window_s:.3f} s, {len(records)} calls; "
              f"host in the window: user {host1['utime'] - host0['utime']:.2f} s, "
              f"system {host1['stime'] - host0['stime']:.2f} s, "
              f"context switches {host1['nvcsw'] - host0['nvcsw']} voluntary / "
              f"{host1['nivcsw'] - host0['nivcsw']} involuntary, cpu {host0['cpu']} -> "
              f"{host1['cpu']}, load {host0['load1']:.2f} -> {host1['load1']:.2f}; "
              f"gc collections {gct.count} taking {[round(x, 4) for x in gct.seconds]} s",
              file=sys.stderr)
        if cuda:
            print("card after the window: " + nvidia_smi(
                "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"),
                file=sys.stderr)
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(workdir) for f in files)
        print(f"files in the run's directory after the window: {written} bytes", file=sys.stderr)
        lat = sorted(r["t1"] - r["t0"] for r in records)
        print("call seconds (min, quartiles, max): " + ", ".join(
            f"{lat[min(len(lat) - 1, int(q * len(lat)))]:.4f}" for q in (0, .25, .5, .75, 1))
            + f"; in order: {[round(r['t1'] - r['t0'], 4) for r in records]}", file=sys.stderr)
        shapes = entry.shapes(state)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        correct, numbers = check(spec, entry, state, records)
        print(f"comparison: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    run = SimpleNamespace(records=records, window_s=window_s, setup_s=setup_s, shapes=shapes,
                          config=spec.config, workload=wl, trace=None)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from . import trace as tracing

        run.trace = tracing.Trace(events["events"], len(records)) if cuda else None
        if run.trace is not None:
            device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            breakdown = {"device_ops": run.trace.top_device_ops(),
                         "idle_gaps": run.trace.idle_gaps()}
        wanted = spec.per_layer
    else:
        wanted = [m for m in spec.end_to_end if m["name"] != "setup_s"]
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result = {"correct": bool(correct),
              "attempted": sum(r["attempted"] for r in records),
              "failed": sum(r["failed"] for r in records),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v if np.isfinite(v) else str(v), "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result
