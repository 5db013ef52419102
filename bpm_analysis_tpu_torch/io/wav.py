"""Host-side WAV reader/writer — pure numpy, no scipy dependency.

Replaces the reference's ``scipy.io.wavfile`` usage (bpm_analysis.py:1014,
1050).  Supports PCM 8/16/24/32-bit and IEEE float WAVs, returning the raw
integer/float arrays exactly as scipy does (no normalization) so the
downstream envelope math sees identical values.

An own copy of ``bpm_analysis_tpu/io/wav.py``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read(path: str) -> Tuple[int, np.ndarray]:
    """Read a WAV file.  Returns (sample_rate, data) with shape (n,) for
    mono or (n, channels); dtype matches the container (int16/int32/float32),
    24-bit is widened to int32 (matching scipy)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
            elif chunk_id == b"data":
                data = f.read(chunk_size)
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
                continue
            if chunk_size & 1:
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 1:  # PCM
        if bits == 8:
            arr = np.frombuffer(data, dtype=np.uint8)
        elif bits == 16:
            arr = np.frombuffer(data, dtype="<i2")
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            arr = (raw[:, 0].astype(np.uint32)
                   | (raw[:, 1].astype(np.uint32) << 8)
                   | (raw[:, 2].astype(np.uint32) << 16)).astype(np.int32)
            arr = (arr << 8) >> 8  # sign-extend
        elif bits == 32:
            arr = np.frombuffer(data, dtype="<i4")
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        arr = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    if channels > 1:
        arr = arr.reshape(-1, channels)
    return sample_rate, arr


def probe(path: str) -> Tuple[int, int]:
    """Header-only probe: (sample_rate, n_frames) without reading samples —
    the batch runner uses this to bucket files by length before decoding."""
    sr, n, _fmt, _ch, _bits = probe_full(path)
    return sr, n


def probe_full(path: str) -> Tuple[int, int, int, int, int]:
    """Header-only probe returning (sample_rate, n_frames, audio_format,
    channels, bits).  ``audio_format`` is the raw fmt tag (1 = PCM, 3 = IEEE
    float; WAVE_FORMAT_EXTENSIBLE is resolved to its sub-format when the
    extension block is present) — the batch runner uses it to pick the int16
    staging fast path for mono PCM16 sources."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        sample_rate = channels = bits = audio_format = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size + (chunk_size & 1))
                audio_format, channels, sample_rate, _br, _ba, bits = \
                    struct.unpack("<HHIIHH", fmt[:16])
                if audio_format == 0xFFFE and chunk_size >= 26:
                    audio_format = struct.unpack("<H", fmt[24:26])[0]
            else:
                if chunk_id == b"data":
                    data_size = chunk_size
                f.seek(chunk_size + (chunk_size & 1), 1)
            if sample_rate is not None and data_size is not None:
                break
    if sample_rate is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return (sample_rate, data_size // (channels * max(bits // 8, 1)),
            audio_format, channels, bits)


def write(path: str, sample_rate: int, data: np.ndarray) -> None:
    """Write a mono/multichannel WAV (int16 or float32)."""
    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    if data.dtype == np.int16:
        fmt_code, bits = 1, 16
    elif data.dtype == np.float32:
        fmt_code, bits = 3, 32
    elif data.dtype == np.int32:
        fmt_code, bits = 1, 32
    else:
        raise ValueError(f"unsupported dtype {data.dtype}")
    payload = data.astype(data.dtype.newbyteorder("<")).tobytes()
    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", fmt_code, channels, sample_rate, byte_rate,
                            block_align, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


def to_mono(data: np.ndarray) -> np.ndarray:
    """Channel mean, as the reference does (bpm_analysis.py:1015-1016)."""
    if data.ndim > 1:
        return np.mean(data, axis=1)
    return data
