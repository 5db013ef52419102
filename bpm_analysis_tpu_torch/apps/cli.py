"""Batch CLI — the port's primary front-end.

Port of ``bpm_analysis_tpu/apps/cli.py`` (the reference's Tk GUI worker
loop, gui.py:181-265, for headless use): multiple files, a per-file error
roster, BPM-hint persistence (auto-loaded from
``{base}_Analysis_Settings.json`` like gui.py:143-166), and auto-discovery
of supported audio in the working directory (gui.py:88-115).  It runs on
the CUDA card unless ``--device cpu``.  ``--batch --dp N`` shards the
batches over N ranks (``parallel.mesh.spawn``): NCCL when each rank has a
card of its own, gloo when ranks share a card or run on the CPU.

    python -m bpm_analysis_tpu_torch.apps.cli recording.wav --output-dir processed_files
    python -m bpm_analysis_tpu_torch.apps.cli *.wav --batch --bpm-hint 120
    python -m bpm_analysis_tpu_torch.apps.cli *.wav --batch --dp 4
    python -m bpm_analysis_tpu_torch.apps.cli sample_filtered_debug.wav --pre-filtered
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import torch

from ..config import DEFAULT_CONFIG
from ..device import resolve_device
from ..host import SUPPORTED_EXTENSIONS, analyze_any_file
from ..reports import settings as settings_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bpm-analyze-torch",
        description="Heartbeat BPM analyzer on PyTorch/CUDA (batch mode)",
    )
    p.add_argument("files", nargs="*", help="audio files (default: all supported in cwd)")
    p.add_argument("--output-dir", default="processed_files",
                   help="artifact directory (default: processed_files)")
    p.add_argument("--bpm-hint", type=float, default=None,
                   help="global starting-BPM hint (per-file saved hints take precedence)")
    p.add_argument("--pre-filtered", action="store_true",
                   help="inputs are already band-passed/decimated signals "
                        "(e.g. *_filtered_debug.wav artifacts)")
    p.add_argument("--no-saved-hints", action="store_true",
                   help="ignore per-file hints saved in _Analysis_Settings.json")
    p.add_argument("--batch", action="store_true",
                   help="analyze files in device batches (mixed lengths are "
                        "bucketed+padded; artifacts identical to serial mode)")
    p.add_argument("--batch-size", type=int, default=128,
                   help="max recordings per device batch (default 128)")
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="compute dtype (default: config value, float32). "
                        "float64 reproduces the CPU reference byte-exactly")
    p.add_argument("--dp", type=int, default=0,
                   help="with --batch, shard batches over this many ranks (0 = one "
                        "rank per visible card when >1, else unsharded)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipeline runs (default: cuda)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def discover_files() -> list:
    return sorted(
        f for f in os.listdir(".")
        if f.lower().endswith(SUPPORTED_EXTENSIONS) and os.path.isfile(f)
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s - [%(levelname)s] - %(message)s",
        stream=sys.stdout,
    )

    cfg = DEFAULT_CONFIG
    if args.dtype and args.dtype != cfg.runtime.dtype:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, dtype=args.dtype))
    args._cfg = cfg

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"{e} (--device cpu)", file=sys.stderr)
        return 2

    files = args.files or discover_files()
    if not files:
        print("No input files (and none discovered in the working directory).",
              file=sys.stderr)
        return 2

    def file_hint(path):
        hint = args.bpm_hint
        if not args.no_saved_hints:
            saved = settings_mod.load_hint(
                args.output_dir, os.path.splitext(os.path.basename(path))[0])
            if saved is not None:
                hint = saved
        return hint

    if args.batch:
        return run_batched(args, files, file_hint)

    errors = []
    for path in files:
        hint = file_hint(path)
        try:
            result = analyze_any_file(path, args._cfg, hint, args.output_dir,
                                      pre_filtered=args.pre_filtered, device=args.device)
            print_result(path, result, args.output_dir)
        except Exception as e:  # per-file isolation (gui.py:247-257)
            logging.exception(f"analysis failed for {path}")
            errors.append((path, str(e)))

    return report_errors(errors)


def print_result(path: str, result, output_dir: str) -> None:
    base = os.path.splitext(os.path.basename(path))[0]
    if result is None:
        print(f"{path}: not enough beats detected for a report")
    else:
        m = result.metrics
        print(f"{path}: {int(result.final_count)} beats, "
              f"avg/min/max BPM {float(m.avg_bpm):.1f}/"
              f"{float(m.min_bpm):.1f}/{float(m.max_bpm):.1f} "
              f"-> {output_dir}/{base}_*")


def report_errors(errors) -> int:
    if errors:
        print("\nFiles with errors:", file=sys.stderr)
        for path, msg in errors:
            print(f"  {path}: {msg}", file=sys.stderr)
        return 1
    return 0


def run_batched(args, files, file_hint) -> int:
    """Device-batched mode: bucket mixed-length files into shared shapes and
    analyze them as batches (optionally dp-sharded over ranks) — the
    parallel replacement of the reference's serial loop (gui.py:202)."""
    from .. import host_batch

    hints = [file_hint(f) for f in files]
    dp = args.dp
    if dp <= 0:
        dp = torch.cuda.device_count() if args.device == "cuda" else 1
    if dp > 1:
        from ..parallel.mesh import spawn

        return spawn(_batched_rank, dp, None, args.device, files, hints, args._cfg,
                     args.output_dir, args.batch_size, args.pre_filtered, args.verbose)[0]
    results, errors = host_batch.analyze_files_batched(
        files, args._cfg, args.output_dir, hints=hints,
        max_batch=args.batch_size, pre_filtered=args.pre_filtered, device=args.device,
    )
    return report_batched(files, results, errors, args.output_dir)


def report_batched(files, results, errors, output_dir: str) -> int:
    for path in files:
        if path in results:
            print_result(path, results[path], output_dir)
    return report_errors(errors)


def _batched_rank(files, hints, cfg, output_dir, batch_size, pre_filtered, verbose) -> int:
    """One rank of ``--batch --dp N``: its share of the batches; rank 0
    prints the roster every rank holds."""
    from .. import host_batch
    from ..parallel.mesh import make_mesh

    logging.basicConfig(level=logging.INFO if verbose else logging.WARNING,
                        format="%(asctime)s - [%(levelname)s] - %(message)s",
                        stream=sys.stdout)
    mesh = make_mesh()
    results, errors = host_batch.analyze_files_batched(
        files, cfg, output_dir, hints=hints, max_batch=batch_size,
        pre_filtered=pre_filtered, mesh=mesh)
    if mesh.index != 0:
        return 1 if errors else 0
    code = report_batched(files, results, errors, output_dir)
    sys.stdout.flush()
    sys.stderr.flush()
    return code


if __name__ == "__main__":
    sys.exit(main())
