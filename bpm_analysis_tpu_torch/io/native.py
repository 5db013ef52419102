"""ctypes bindings for the native host ingest library (native/wav_decoder.cpp).

Port of ``bpm_analysis_tpu/io/native.py``.  The library is built on first
use with ``g++`` from the checkout's ``native/wav_decoder.cpp`` into
``<checkout>/.torch_build/libbpmwav-<hash>.so``, keyed by a hash of the
source and the flags, written to a temporary name and renamed into place
(the pattern of ``kernels/build.py``); ``native/`` itself is never written.
Every entry point falls back to the pure-numpy decoder (``io.wav``) if the
library cannot be built or a decode fails, so the native path is a pure
acceleration layer for the batch feeder.  The library falling back as a
whole is logged as a warning.

Decodes are *strided*: passing ``stride`` > 1 emits every stride-th mono
frame — the host half of the compat decimation path (a pure slice,
bpm_analysis.py:1031-1045), done inside the decoder so skipped frames are
never even converted.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.build import BUILD_DIR
from . import wav as pywav

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wav_decoder.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> Path:
    """The built library's path, compiling it when its hash is new."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"libbpmwav-{digest[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise OSError(f"g++ failed on {SOURCE.name} (exit {proc.returncode}): "
                          f"{proc.stderr[-2000:]}")
        os.replace(tmp, target)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    f32p, i16p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16)
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.bpmwav_decode.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int64,
                                  i32p, i64p]
    lib.bpmwav_decode_batch.argtypes = [paths, ctypes.c_int32, f32p, ctypes.c_int64, i64p,
                                        i32p, i64p, i32p, ctypes.c_int32]
    lib.bpmwav_decode_batch_i16.argtypes = [paths, ctypes.c_int32, i16p, ctypes.c_int64,
                                            i64p, i32p, i64p, i32p, ctypes.c_int32]
    lib.bpmwav_decode_batch_fir.argtypes = [paths, ctypes.c_int32, f32p, ctypes.c_int64,
                                            i64p, ctypes.c_int32, i32p, i64p, i32p,
                                            ctypes.c_int32]
    for fn in (lib.bpmwav_decode, lib.bpmwav_decode_batch, lib.bpmwav_decode_batch_i16,
               lib.bpmwav_decode_batch_fir):
        fn.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        except (OSError, subprocess.SubprocessError) as e:
            logging.warning(f"native wav library unavailable ({e}); decoding with numpy")
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_mono_f32(path: str, max_samples: int, stride: int = 1
                    ) -> Tuple[int, np.ndarray]:
    """Decode one WAV to mono float32 (channel mean, scipy value convention),
    keeping every ``stride``-th frame.  Falls back to the numpy decoder."""
    lib = _load()
    if lib is not None:
        out = np.zeros(max_samples, np.float32)
        sr = ctypes.c_int32(0)
        n = ctypes.c_int64(0)
        rc = lib.bpmwav_decode(path.encode(), _ptr(out, ctypes.c_float), max_samples,
                               stride, ctypes.byref(sr), ctypes.byref(n))
        if rc == 0:
            return int(sr.value), out[: int(n.value)]
        logging.debug(f"native decode failed ({rc}) for {path}; numpy fallback")
    sr2, data = pywav.read(path)
    mono = pywav.to_mono(data).astype(np.float32)
    if stride > 1:
        mono = mono[::stride]
    return sr2, np.ascontiguousarray(mono[:max_samples])


def _batch_buffers(paths, max_samples, out, dtype):
    batch = len(paths)
    if out is None:
        out = np.zeros((batch, max_samples), dtype)
    elif (out.dtype != dtype or not out.flags.c_contiguous or out.shape[0] < batch
          or out.shape[1] != max_samples):
        raise ValueError(f"out must be C-contiguous {np.dtype(dtype).name} with row width "
                         f"{max_samples} and at least {batch} rows")
    return out, np.zeros(batch, np.int32), np.zeros(batch, np.int64)


def _native_batch(fn, paths, out, ctype, max_samples, per_file, rates, lengths,
                  num_threads, *extra) -> np.ndarray:
    """Run one batch entry point; returns the rows that failed (all rows when
    the library is unavailable)."""
    batch = len(paths)
    if fn is None or not batch:
        return np.arange(batch)
    errors = np.zeros(batch, np.int32)
    arr = (ctypes.c_char_p * batch)(*[p.encode() for p in paths])
    fn(arr, batch, _ptr(out, ctype), max_samples, _ptr(per_file, ctypes.c_int64), *extra,
       _ptr(rates, ctypes.c_int32), _ptr(lengths, ctypes.c_int64),
       _ptr(errors, ctypes.c_int32), num_threads)
    return np.nonzero(errors != 0)[0]


def _strides(strides, batch) -> np.ndarray:
    return (np.ones(batch, np.int64) if strides is None
            else np.asarray(list(strides), np.int64))


def decode_batch_f32(paths: List[str], max_samples: int,
                     strides: Optional[Sequence[int]] = None,
                     num_threads: int = 0,
                     out: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parallel native decode of ``paths`` into a zero-padded
    (batch, max_samples) float32 buffer, each file decimated by its own
    ``strides[i]``.  Returns (buffer, sample_rates, lengths) where lengths
    are the post-stride emitted counts.  Per-file failures fall back to the
    numpy decoder; files that still fail get length 0.

    ``out`` lets the caller decode straight into (the head of) a staging
    buffer it owns — C-contiguous float32 with row width ``max_samples``
    and at least ``len(paths)`` rows (a pinned host tensor's numpy view).
    """
    out, rates, lengths = _batch_buffers(paths, max_samples, out, np.float32)
    stride_arr = _strides(strides, len(paths))
    lib = _load()
    failed = _native_batch(lib and lib.bpmwav_decode_batch, paths, out, ctypes.c_float,
                           max_samples, stride_arr, rates, lengths, num_threads)
    for i in failed:
        try:
            sr, mono = decode_mono_f32(paths[i], max_samples, int(stride_arr[i]))
            out[i, : len(mono)] = mono
            out[i, len(mono):] = 0.0
            rates[i] = sr
            lengths[i] = len(mono)
        except Exception as e:
            logging.warning(f"decode failed for {paths[i]}: {e}")
            lengths[i] = 0
    return out, rates, lengths


def decode_batch_i16(paths: List[str], max_samples: int,
                     strides: Optional[Sequence[int]] = None,
                     num_threads: int = 0,
                     out: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parallel strided decode of mono-PCM16 WAVs into a zero-padded
    (batch, max_samples) **int16** buffer — the staging fast path: the
    device casts int16 rows to float (exact), so the host->device transfer
    ships half the bytes of the float32 path.  Per-file failures (including
    files that turn out not to be mono PCM16) fall back to the float decoder
    and are round-tripped through int16 — exact whenever the fallback's
    values are int16-representable (the caller pre-screens formats with
    ``wav.probe_full``, so a value outside int16 means the file changed
    between probe and decode, and the row fails); files that still fail get
    length 0.
    """
    out, rates, lengths = _batch_buffers(paths, max_samples, out, np.int16)
    stride_arr = _strides(strides, len(paths))
    lib = _load()
    failed = _native_batch(lib and lib.bpmwav_decode_batch_i16, paths, out, ctypes.c_int16,
                           max_samples, stride_arr, rates, lengths, num_threads)
    for i in failed:
        try:
            sr, mono = decode_mono_f32(paths[i], max_samples, int(stride_arr[i]))
            if len(mono) and (np.abs(mono) > 32767).any():
                # A wrapping cast would silently corrupt the signal.
                raise ValueError("fallback decode produced values outside "
                                 "int16 range (file changed since probe?)")
            out[i, : len(mono)] = mono.astype(np.int16)
            out[i, len(mono):] = 0
            rates[i] = sr
            lengths[i] = len(mono)
        except Exception as e:
            logging.warning(f"decode failed for {paths[i]}: {e}")
            lengths[i] = 0
    return out, rates, lengths


def fir_taps(factor: int, taps_per_phase: int = 8) -> np.ndarray:
    """The antialias decimation taps (float32) — the same Hann-windowed-sinc
    design as the device path (ops/filter.py:fir_decimate) and the native
    decoder's in-loop FIR (wav_decoder.cpp:decode_one_fir)."""
    half = taps_per_phase * factor // 2
    n_taps = 2 * half + 1
    t = np.arange(n_taps) - half
    cutoff = 0.9 / factor
    h = np.sinc(cutoff * t) * cutoff
    h *= np.hanning(n_taps)
    h /= h.sum()
    return h.astype(np.float32)


def _fir_decimate_np(mono: np.ndarray, factor: int,
                     taps_per_phase: int = 8) -> np.ndarray:
    """Numpy fallback of the decoder's streaming FIR (zero-padded edges,
    y[m] = sum_k h[k] * x[m*factor + k - half])."""
    if factor <= 1:
        return mono.astype(np.float32)
    h = fir_taps(factor, taps_per_phase)
    half = (len(h) - 1) // 2
    n = len(mono)
    out_len = -(-n // factor)
    xp = np.zeros(half + n + len(h), np.float32)
    xp[half: half + n] = mono
    y = np.empty(out_len, np.float32)
    for m in range(out_len):
        y[m] = np.dot(h, xp[m * factor: m * factor + len(h)])
    return y


def decode_batch_fir(paths: List[str], max_samples: int,
                     factors: Sequence[int], taps_per_phase: int = 8,
                     num_threads: int = 0,
                     out: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parallel anti-alias-decimating decode: each file is low-passed with
    the device FIR's Hann-windowed-sinc taps and decimated by ``factors[i]``
    inside the native streaming decode loop — the host half of the
    ``compat.antialias_decimation`` path, so a chunk stages the decimated
    samples instead of native-rate PCM.  Same buffer/result contract as
    ``decode_batch_f32``; per-file failures fall back to a numpy decode +
    FIR with identical semantics."""
    out, rates, lengths = _batch_buffers(paths, max_samples, out, np.float32)
    factor_arr = np.asarray(list(factors), np.int64)
    lib = _load()
    failed = _native_batch(lib and lib.bpmwav_decode_batch_fir, paths, out, ctypes.c_float,
                           max_samples, factor_arr, rates, lengths, num_threads,
                           taps_per_phase)
    for i in failed:
        try:
            sr, data = pywav.read(paths[i])
            mono = pywav.to_mono(data).astype(np.float32)
            y = _fir_decimate_np(mono, int(factor_arr[i]), taps_per_phase)[:max_samples]
            out[i, : len(y)] = y
            out[i, len(y):] = 0.0
            rates[i] = sr
            lengths[i] = len(y)
        except Exception as e:
            logging.warning(f"FIR decode failed for {paths[i]}: {e}")
            lengths[i] = 0
    return out, rates, lengths
