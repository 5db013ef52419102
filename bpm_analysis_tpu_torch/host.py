"""Host-side orchestration: file in → device pipeline → artifact files out.

Port of ``bpm_analysis_tpu/host.py`` (reference ``analyze_wav_file``,
bpm_analysis.py:1725-1768, plus the GUI worker's convert-or-copy step,
gui.py:202-245).  The host decodes, transfers and renders; everything
between PCM and metrics is the port's batched pipeline
(``models.envelope`` → ``models.pipeline.analyze_envelope``), run here on a
batch of one.  Entry points run on CUDA unless the caller passes
``device="cpu"``.

The serial path pads each recording to a power-of-two bucket and passes the
true length as ``n_valid``, as the JAX package does; the masked pipeline
computes the unpadded analysis.  The filter's products and the rolling and
metric means are sums in an order fixed by the row alone, so a recording
gives the same result in any batch; the batched front-end's artifacts
equal this path's under the contract of tests/test_host_batch.py (every
byte, but for one 0.1 quantum on the debug log's amplitude display lines,
which the JAX package's contract allows).
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from .config import AnalyzerConfig, DEFAULT_CONFIG
from .device import resolve_device
from .io import wav
from .models import envelope as envm
from .models import pipeline
from .reports import csvout, debug_log, plot, settings, summary
from .reports import trace as trace_mod
from .utils.profiling import span

SUPPORTED_EXTENSIONS = (".wav", ".mp3", ".m4a", ".flac", ".ogg", ".mp4", ".mkv", ".mov")


def _length_bucket(n: int, min_bucket: int = 1 << 15) -> int:
    """Smallest power-of-two >= n (>= min_bucket): the serial path's padded
    length."""
    b = min_bucket
    while b < n:
        b <<= 1
    return b


def tree_map(fn, tree):
    """``fn`` over the leaves of nested (Named)tuples; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, x) for x in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return fn(tree)


def tree_row(tree, i: int):
    """Row ``i`` of every leaf of a batched tree."""
    return tree_map(lambda a: a[i], tree)


def to_host(tree):
    """A tree of tensors (a ``PipelineResult``, a ``RenderPack``, tuples of
    them, ``None`` leaves) as numpy, in one pass: every device-to-host copy
    starts at once, ``non_blocking`` into pinned buffers on the current
    stream, and the stream is synchronised once.  The renderers index the
    result per event; per-field or per-element ``.cpu()`` calls would pay
    one synchronisation each, thousands per file.  CPU tensors are viewed,
    not copied.  The whole is the span ``bpm.to_host``, its wait
    ``bpm.sync.to_host``."""
    pending = []

    def start(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type != "cuda":
            return x.detach()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        pending.append(buf)
        return buf

    with span("bpm.to_host"):
        staged = tree_map(start, tree)
        if pending:
            with span("bpm.sync.to_host"):
                torch.cuda.current_stream().synchronize()
        return tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, staged)


def compute_dtype(cfg: AnalyzerConfig) -> torch.dtype:
    return torch.float32 if cfg.runtime.dtype == "float32" else torch.float64


def post_rate(sample_rate: int, cfg: AnalyzerConfig) -> int:
    factor = envm.safe_downsample_factor(sample_rate, cfg)
    return sample_rate // factor if factor > 1 else sample_rate


def analyze_padded(audio: torch.Tensor, hints: torch.Tensor, n_valid: torch.Tensor,
                   sample_rate: int, cfg: AnalyzerConfig, pre_filtered: bool):
    """The device program of one zero-padded (B, L) batch on ``audio``'s
    device: PCM (int16 rows are cast to the compute dtype, exactly) →
    envelope → pipeline.  Returns (envelope, filtered or None, decimated
    valid lengths, PipelineResult).  Pre-filtered inputs skip decimation and
    the band-pass, and have no filtered signal (no ``*_filtered_debug.wav``
    is written for them)."""
    with torch.no_grad():
        x = audio.to(compute_dtype(cfg))
        if pre_filtered:
            env = envm.envelope_from_filtered(x, sample_rate, n_valid=n_valid)
            res = pipeline.analyze_envelope(env, sample_rate, cfg, hints, n_valid=n_valid)
            return env, None, n_valid, res
        env, filtered, rate, nv_dec = envm.preprocess(x, sample_rate, cfg, n_valid=n_valid,
                                                      device=x.device)
        res = pipeline.analyze_envelope(env, rate, cfg, hints, n_valid=nv_dec)
        return env, filtered, nv_dec, res


def convert_to_wav(file_path: str, target_path: str) -> bool:
    """Any format → mono WAV.  The reference shells out to FFmpeg via pydub
    (bpm_analysis.py:989-1005); this invokes the ffmpeg CLI directly."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg is required for non-WAV inputs but was not found on PATH")
    logging.info(f"Converting {os.path.basename(file_path)} to WAV format...")
    try:
        subprocess.run(
            [ffmpeg, "-y", "-i", file_path, "-ac", "1", target_path],
            check=True, capture_output=True,
        )
        return True
    except subprocess.CalledProcessError as e:
        logging.error(f"Could not convert file {file_path}. Error: {e.stderr[-500:]}")
        return False


def check_overflow(result, original_file_path: str) -> None:
    if bool(result.overflowed):
        raise RuntimeError(
            f"{os.path.basename(original_file_path)}: analysis capacity "
            "overflow — a fixed-size buffer (RuntimeConfig.max_raw_peaks/"
            "max_troughs/max_candidates) truncated detected events and the "
            "output would silently omit beats. Re-run with larger capacities."
        )


class SampledEnv:
    """Duck-typed stand-in for a dense per-sample array that only holds the
    values the renderers actually read — event positions (peaks/troughs) and
    the SVG downsample grid.  The batched front-end gathers these on the
    device (``host_batch.RenderPack``), so render mode fetches a few hundred
    KB per chunk instead of the dense rows, with byte-identical artifacts
    (the gathered values ARE the dense entries).

    Supports exactly the renderer access patterns: ``len(a)``, ``a[i]`` for
    scalar event positions, ``a[np.ndarray]`` for marker position arrays,
    and ``a[::step]`` for the SVG line (``step`` must be the grid step this
    view was built with).  Anything else raises — a loud contract, so a new
    renderer access pattern becomes a test failure, not silent corruption.
    """

    def __init__(self, n: int, positions: np.ndarray, values: np.ndarray,
                 ds_step: int, ds_values: np.ndarray):
        order = np.argsort(positions, kind="stable")
        self._pos = np.asarray(positions)[order]
        self._val = np.asarray(values)[order]
        self._n = int(n)
        self._ds_step = int(ds_step)
        self._ds = np.asarray(ds_values)

    def __len__(self):
        return self._n

    def _lookup(self, pos):
        pos = np.asarray(pos)
        i = np.searchsorted(self._pos, pos)
        ok = i < len(self._pos)
        found = ok & (self._pos[np.minimum(i, len(self._pos) - 1)] == pos)
        if not np.all(found):
            raise KeyError(
                f"SampledEnv: positions {pos[~found][:5]} were not gathered on "
                "the device — extend the render pack for this access")
        return self._val[i]

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.start is None and key.stop is None \
                    and (key.step or 1) == self._ds_step:
                return self._ds
            raise KeyError(f"SampledEnv: unsupported slice {key} "
                           f"(grid step is {self._ds_step})")
        if np.isscalar(key) or getattr(key, "ndim", 1) == 0:
            return float(self._lookup(np.asarray([key]))[0])
        return self._lookup(key)


def save_filtered_wav(filtered: np.ndarray, new_rate: int,
                      original_file_path: str, output_directory: str,
                      beside_wav_path: Optional[str] = None) -> None:
    """``*_filtered_debug.wav`` (int16-normalized) in the output directory
    (bpm_analysis.py:1056-1060) and — when ``beside_wav_path`` is given and
    resolves to a different file — beside the analyzed wav too, reproducing
    the reference's duplicate write (bpm_analysis.py:1047-1050)."""
    peak = np.max(np.abs(filtered)) or 1.0
    norm = np.int16(filtered / peak * 32767)
    write_filtered_wav_i16(norm, new_rate, original_file_path,
                           output_directory, beside_wav_path)


def write_filtered_wav_i16(norm: np.ndarray, new_rate: int,
                           original_file_path: str, output_directory: str,
                           beside_wav_path: Optional[str] = None) -> None:
    """Write an already int16-normalized filtered signal — the batched
    front-end normalizes on the device (the same peak, scale and truncation
    in the compute dtype, bit-identical samples) and fetches int16."""
    base = os.path.basename(os.path.splitext(original_file_path)[0])
    out_path = os.path.join(output_directory, f"{base}_filtered_debug.wav")
    wav.write(out_path, new_rate, norm)
    if beside_wav_path is not None:
        beside = f"{os.path.splitext(beside_wav_path)[0]}_filtered_debug.wav"
        if os.path.abspath(beside) != os.path.abspath(out_path):
            wav.write(beside, new_rate, norm)


def render_artifacts(result, cfg: AnalyzerConfig, env_np: np.ndarray,
                     new_rate: int, original_file_path: str,
                     output_directory: str, start_bpm_hint=None):
    """Persist the reference's artifact set for one analyzed recording (a
    numpy ``PipelineResult`` row): settings JSON, BPM CSV, summary MD, debug
    log MD, HTML plot (bpm_analysis.py:1756-1765).  Returns the result, or
    None when fewer than 2 final beats (the reference's no-report outcome)."""
    base = os.path.basename(os.path.splitext(original_file_path)[0])
    with span("bpm.render.settings"):
        settings.save(output_directory, base, start_bpm_hint)
    check_overflow(result, original_file_path)
    if not bool(result.ok):
        logging.warning("Not enough S1 peaks detected to generate full report.")
        return None
    with span("bpm.render.csv"):
        times, bpm = csvout.bpm_rows(result)
        csvout.write_bpm_csv(os.path.join(output_directory, f"{base}_bpm_plot.csv"),
                             times, bpm)
    with span("bpm.render.summary"):
        summary.save(result, original_file_path, output_directory)
    with span("bpm.render.debug_log"):
        # Read by both the debug log and the plot tooltips: build it once.
        debug = trace_mod.debug_strings(result, cfg)
        debug_log.save(result, cfg, env_np, new_rate, original_file_path,
                       output_directory, debug=debug)
    with span("bpm.render.plot"):
        plot.save(result, cfg, env_np, new_rate, original_file_path, output_directory,
                  debug=debug)
    return result


def analyze_wav_file(
    wav_file_path: str,
    cfg: AnalyzerConfig = DEFAULT_CONFIG,
    start_bpm_hint: Optional[float] = None,
    original_file_path: Optional[str] = None,
    output_directory: str = ".",
    pre_filtered: bool = False,
    device=None,
):
    """Single-file pipeline producing the reference's artifact set:
    ``{base}_bpm_plot.html`` + ``.csv``, ``{base}_Analysis_Summary.md``,
    ``{base}_Debug_Log.md``, ``{base}_Analysis_Settings.json`` and (unless
    ``pre_filtered``) ``{base}_filtered_debug.wav``.

    Returns the numpy PipelineResult row, or None when fewer than 2 final
    beats were found (reference bpm_analysis.py:1752-1754).  Runs on CUDA
    unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    start = time.time()
    original_file_path = original_file_path or wav_file_path
    logging.info(f"--- Processing file: {os.path.basename(original_file_path)} ---")
    os.makedirs(output_directory, exist_ok=True)

    with span("bpm.read"):
        sample_rate, data = wav.read(wav_file_path)
        mono = wav.to_mono(data).astype(np.float32 if cfg.runtime.dtype == "float32"
                                        else np.float64)
        n = int(mono.shape[0])
        if pre_filtered:
            # Input is already the band-passed (decimated) signal — e.g. a
            # ``*_filtered_debug.wav`` artifact; skip decimation/filtering the
            # way the reference's labeler does (heartbeat_labeler.py:62-67).
            new_rate = sample_rate
        else:
            factor = envm.safe_downsample_factor(sample_rate, cfg)
            new_rate = post_rate(sample_rate, cfg)
            # The masked filtfilt clamps (garbage) instead of erroring when
            # n_valid <= padlen, so reject too-short recordings here.
            padlen = 3 * (2 * cfg.preprocess.bandpass_order + 1)
            n_dec = -(-n // factor) if factor > 1 else n
            if n_dec <= padlen:
                raise ValueError(
                    f"decimated length {n_dec} must exceed filter padlen "
                    f"{padlen} (recording too short at rate {sample_rate})")

        bucket = _length_bucket(n)
        if bucket > n:
            mono = np.pad(mono, (0, bucket - n))
    hint = float(start_bpm_hint) if start_bpm_hint else float("nan")
    dtype = compute_dtype(cfg)
    with span("bpm.to_device"):
        audio = torch.from_numpy(mono)[None].to(dev)
        hints = torch.tensor([hint], dtype=dtype, device=dev)
        n_valid = torch.tensor([n], dtype=torch.int32, device=dev)
    env, filtered, nv_dec, result = analyze_padded(audio, hints, n_valid, sample_rate, cfg,
                                                   pre_filtered)
    env, filtered, nv_dec, result = tree_row(to_host((env, filtered, nv_dec, result)), 0)
    nv = int(nv_dec)
    with span("bpm.render"):
        if not pre_filtered and cfg.preprocess.save_filtered_wav:
            with span("bpm.render.filtered_wav"):
                save_filtered_wav(
                    filtered[:nv], new_rate, original_file_path, output_directory,
                    beside_wav_path=(wav_file_path if cfg.compat.filtered_wav_beside_input
                                     else None))
        out = render_artifacts(result, cfg, env[:nv], new_rate, original_file_path,
                               output_directory, start_bpm_hint)
    logging.info(f"--- Analysis finished in {time.time() - start:.2f} seconds. ---")
    return out


def analyze_any_file(
    file_path: str,
    cfg: AnalyzerConfig = DEFAULT_CONFIG,
    start_bpm_hint: Optional[float] = None,
    output_directory: str = "processed_files",
    pre_filtered: bool = False,
    device=None,
):
    """Convert-or-copy then analyze — the per-file body of the reference's
    batch worker (gui.py:202-245).  One call is the span ``bpm.request``."""
    with span("bpm.request"):
        os.makedirs(output_directory, exist_ok=True)
        base, ext = os.path.splitext(os.path.basename(file_path))
        target = os.path.join(output_directory, f"{base}.wav")
        if ext.lower() == ".wav":
            if os.path.abspath(target) != os.path.abspath(file_path):
                shutil.copyfile(file_path, target)
        elif not convert_to_wav(file_path, target):
            raise RuntimeError(f"conversion failed for {file_path}")
        return analyze_wav_file(target, cfg, start_bpm_hint, file_path, output_directory,
                                pre_filtered=pre_filtered, device=device)
