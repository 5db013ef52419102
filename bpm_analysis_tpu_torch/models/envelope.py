"""Preprocessing: PCM → band-passed signal → amplitude envelope, batched.

Port of ``bpm_analysis_tpu/models/envelope.py`` (reference
``preprocess_audio``, bpm_analysis.py:1007-1062): mono PCM → stride
decimation → 2nd-order Butterworth band-pass 20-150 Hz (filtfilt) → abs →
centered rolling mean of ``sr // 10`` samples.  The compat path decimates
by striding before filtering, as the reference does;
``compat.antialias_decimation=True`` decimates with the FIR low-pass
``ops/filter.fir_decimate`` first (the north-star path).
"""
from __future__ import annotations

import torch

from ..config import AnalyzerConfig
from ..device import as_tensor, resolve_device
from ..ops import rolling
from ..ops.filter import bandpass_filtfilt, fir_decimate
from ..ops.indexing import arange, take
from ..utils.profiling import span


def safe_downsample_factor(sample_rate: int, cfg: AnalyzerConfig) -> int:
    """Reference clamp: ``int(sr / (highcut*2) - 1)`` floor, min 1
    (bpm_analysis.py:1021-1029)."""
    factor = cfg.preprocess.downsample_factor
    max_safe = int(sample_rate / (cfg.preprocess.bandpass_high_hz * 2) - 1)
    if factor > max_safe:
        factor = max(1, max_safe)
    return factor


def edge_held(x: torch.Tensor, n_valid):
    """(valid mask, x with each row's padded tail held at ``x[n_valid-1]``)
    for (B, n) ``x`` and (B,) ``n_valid``; ``n_valid=None`` returns
    ``(None, x)``."""
    if n_valid is None:
        return None, x
    nv = n_valid.long()[:, None]
    valid = arange(x.shape[1], x)[None, :] < nv
    held = take(x, torch.clamp(nv - 1, min=0))
    return valid, torch.where(valid, x, held)


def envelope_from_filtered(filtered: torch.Tensor, sample_rate: int,
                           n_valid=None) -> torch.Tensor:
    """abs → centered rolling mean of ``sr // 10`` samples
    (bpm_analysis.py:1052-1054).  With ``n_valid``, windows truncate at each
    row's valid boundary as pandas truncates at the series end."""
    window = sample_rate // 10
    if n_valid is None:
        return rolling.rolling_mean_centered(filtered.abs(), window)
    valid = arange(filtered.shape[1], filtered)[None, :] < n_valid.long()[:, None]
    return rolling.rolling_mean_centered_masked(filtered.abs(), valid, window)


def preprocess(audio, sample_rate: int, cfg: AnalyzerConfig, n_valid=None,
               device=None):
    """Full preprocessing of a (B, N) batch of mono PCM at the native rate.

    Entry point: runs on CUDA unless ``device="cpu"``; ``audio`` may be a
    numpy array or a tensor, and keeps its floating dtype.  Returns
    ``(envelope, filtered_signal, new_sample_rate)``, plus the decimated
    valid lengths as a fourth element when ``n_valid`` (B,) marks each
    row's valid prefix of a zero-padded batch."""
    with span("bpm.preprocess"):
        dev = resolve_device(device)
        audio = as_tensor(audio, dev)
        if not audio.is_floating_point():
            raise TypeError(f"audio must be a floating tensor, got {audio.dtype}")
        factor = safe_downsample_factor(sample_rate, cfg)
        low = cfg.preprocess.bandpass_low_hz
        high = cfg.preprocess.bandpass_high_hz
        order = cfg.preprocess.bandpass_order
        masked = n_valid is not None
        if masked:
            n_valid = as_tensor(n_valid, dev).long()
            keep = arange(audio.shape[1], audio)[None, :] < n_valid[:, None]
            audio = torch.where(keep, audio, torch.zeros_like(audio))

        new_rate = sample_rate // factor if factor > 1 else sample_rate
        if cfg.compat.antialias_decimation:
            # North-star path: FIR anti-alias decimation, then the IIR band-pass
            # at the decimated rate, where its poles are well-conditioned.
            decimated = fir_decimate(audio, factor)
        else:
            # Compat path: stride-decimate first (aliases above the new Nyquist
            # fold in — reproducing bpm_analysis.py:1031-1045 exactly).
            decimated = audio[:, ::factor] if factor > 1 else audio
            if high >= 0.5 * new_rate:
                raise ValueError(
                    f"Cannot create a {high:g}Hz filter: effective rate {new_rate}Hz too low")

        if not masked:
            filtered = bandpass_filtfilt(decimated, new_rate, low, high, order)
            return envelope_from_filtered(filtered, new_rate), filtered, new_rate

        nv_dec = (-(-n_valid // factor) if factor > 1 else n_valid).to(torch.int32)
        filtered = bandpass_filtfilt(decimated, new_rate, low, high, order,
                                     n_valid=nv_dec)
        env = envelope_from_filtered(filtered, new_rate, n_valid=nv_dec)
        return env, filtered, new_rate, nv_dec
