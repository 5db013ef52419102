"""Port vs JAX: the host ingest layer, ``io/wav.py`` and ``io/native.py``.

The WAV reader, probes and channel mean against ``bpm_analysis_tpu.io.wav``
on PCM16 mono and stereo, IEEE float32, 24-bit PCM (plain and
WAVE_FORMAT_EXTENSIBLE), 8-bit PCM and files with odd-sized chunks; the
native decodes (float32, int16, strided at several strides, FIR) against
``bpm_analysis_tpu.io.native`` on the same files, both libraries built here
with ``g++`` (the JAX loader's ``make`` in a private copy of ``native/``),
equal bit for bit (the same source, the same arithmetic); the
numpy fallbacks of both packages on the same files; and the FIR taps, equal.
"""
import shutil
import struct

import numpy as np
import pytest

from bpm_analysis_tpu.io import native as jnative
from bpm_analysis_tpu.io import wav as jwav
from bpm_analysis_tpu_torch.io import native as tnative
from bpm_analysis_tpu_torch.io import wav as twav


def _riff(path, fmt_chunk: bytes, data: bytes, extra_chunks=()):
    """A RIFF/WAVE file from a raw fmt body, data bytes and extra chunks
    placed before the data; odd-sized chunks get their pad byte."""
    body = b"WAVE"
    for cid, payload in (*extra_chunks, (b"fmt ", fmt_chunk), (b"data", data)):
        body += struct.pack("<4sI", cid, len(payload)) + payload + b"\0" * (len(payload) & 1)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI", b"RIFF", len(body)) + body)


def _fmt(code, channels, sr, bits, extensible_code=None):
    block = channels * bits // 8
    head = struct.pack("<HHIIHH", code, channels, sr, sr * block, block, bits)
    if extensible_code is None:
        return head
    # cbSize, valid bits, channel mask, sub-format GUID (its first 2 bytes).
    return head + struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", extensible_code) \
        + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def _int24(values: np.ndarray) -> bytes:
    u = values.astype(np.int32).astype(np.uint32)
    return np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], axis=-1) \
        .astype(np.uint8).tobytes()


def _make(kind: str, path: str):
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "pcm16_mono":
        twav.write(path, 302, (rng.randn(3001) * 8000).astype(np.int16))
    elif kind == "pcm16_stereo":
        twav.write(path, 44100, (rng.randn(2500, 2) * 8000).astype(np.int16))
    elif kind == "float32_mono":
        twav.write(path, 4832, rng.randn(2999).astype(np.float32))
    elif kind == "float32_stereo":
        twav.write(path, 8000, rng.randn(1200, 2).astype(np.float32))
    elif kind == "pcm24_mono":
        v = (rng.randn(2001) * 2e6).clip(-2 ** 23, 2 ** 23 - 1)
        _riff(path, _fmt(1, 1, 302, 24), _int24(v))
    elif kind == "pcm24_extensible_stereo":
        v = (rng.randn(1500, 2) * 2e6).clip(-2 ** 23, 2 ** 23 - 1)
        _riff(path, _fmt(0xFFFE, 2, 22050, 24, extensible_code=1), _int24(v))
    elif kind == "pcm8_odd_chunks":
        # 8-bit PCM with an odd sample count (an odd data chunk) after an
        # odd-sized LIST chunk: both carry a pad byte.
        data = rng.randint(0, 256, size=1001).astype(np.uint8).tobytes()
        _riff(path, _fmt(1, 1, 302, 8), data,
              extra_chunks=((b"LIST", b"INFOISFT\x05\0\0\0abcd\0"),))
    elif kind == "pcm16_odd_list_chunk":
        data = (rng.randn(1777) * 3000).astype("<i2").tobytes()
        _riff(path, _fmt(1, 1, 302, 16), data, extra_chunks=((b"junk", b"xyz"),))
    else:
        raise ValueError(kind)


KINDS = ["pcm16_mono", "pcm16_stereo", "float32_mono", "float32_stereo", "pcm24_mono",
         "pcm24_extensible_stereo", "pcm8_odd_chunks", "pcm16_odd_list_chunk"]


@pytest.mark.parametrize("kind", KINDS)
def test_wav_read_probe_to_mono_equal_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.wav")
    _make(kind, path)
    sr_t, data_t = twav.read(path)
    sr_j, data_j = jwav.read(path)
    assert sr_t == sr_j
    assert data_t.dtype == data_j.dtype and data_t.shape == data_j.shape
    np.testing.assert_array_equal(data_t, data_j)
    assert twav.probe(path) == jwav.probe(path)
    assert twav.probe_full(path) == jwav.probe_full(path)
    mono_t, mono_j = twav.to_mono(data_t), jwav.to_mono(data_j)
    assert mono_t.dtype == mono_j.dtype
    np.testing.assert_array_equal(mono_t, mono_j)


def test_wav_write_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    for i, arr in enumerate([(rng.randn(501) * 999).astype(np.int16),
                             rng.randn(300, 2).astype(np.float32),
                             (rng.randn(77) * 1e8).astype(np.int32)]):
        a, b = str(tmp_path / f"t{i}.wav"), str(tmp_path / f"j{i}.wav")
        twav.write(a, 302, arr)
        jwav.write(b, 302, arr)
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def native_files(tmp_path_factory):
    """The test files, with the JAX loader pointed at a private copy of
    ``native/`` so its ``make -B`` never races another test process over
    ``native/libbpmwav.so``."""
    private = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "wav_decoder.cpp"):
        shutil.copy(tnative.SOURCE.parent / name, private / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", str(private))
        mp.setattr(jnative, "_LIB_PATH", str(private / "libbpmwav.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        if not (tnative.available() and jnative.available()):
            pytest.skip("native library unavailable (no g++)")
        d = tmp_path_factory.mktemp("native")
        paths = {kind: str(d / f"{kind}.wav") for kind in KINDS}
        for kind, path in paths.items():
            _make(kind, path)
        yield paths


@pytest.mark.parametrize("stride", [1, 3, 7])
def test_native_decode_f32_equal_jax(native_files, stride):
    paths = list(native_files.values()) + ["/nonexistent/missing.wav"]
    out_t, rates_t, len_t = tnative.decode_batch_f32(paths, 3200, strides=[stride] * len(paths))
    out_j, rates_j, len_j = jnative.decode_batch_f32(paths, 3200, strides=[stride] * len(paths))
    np.testing.assert_array_equal(rates_t, rates_j)
    np.testing.assert_array_equal(len_t, len_j)
    np.testing.assert_array_equal(out_t, out_j)
    assert len_t[-1] == 0
    for path in native_files.values():
        sr_t, mono_t = tnative.decode_mono_f32(path, 3200, stride)
        sr_j, mono_j = jnative.decode_mono_f32(path, 3200, stride)
        assert sr_t == sr_j
        np.testing.assert_array_equal(mono_t, mono_j)


@pytest.mark.parametrize("stride", [1, 2, 5, 146])
def test_native_decode_i16_equal_jax(native_files, stride):
    paths = [native_files["pcm16_mono"], native_files["pcm16_odd_list_chunk"],
             native_files["pcm16_stereo"]]       # not mono: falls back per file
    buf_t = np.full((4, 4000), 7, np.int16)       # an extra row and a dirty fill
    buf_j = buf_t.copy()
    _, rates_t, len_t = tnative.decode_batch_i16(paths, 4000, strides=[stride] * 3, out=buf_t)
    _, rates_j, len_j = jnative.decode_batch_i16(paths, 4000, strides=[stride] * 3, out=buf_j)
    np.testing.assert_array_equal(rates_t, rates_j)
    np.testing.assert_array_equal(len_t, len_j)
    np.testing.assert_array_equal(buf_t, buf_j)
    _, ref = jwav.read(paths[0])
    np.testing.assert_array_equal(buf_t[0, : len_t[0]], ref[::stride])


@pytest.mark.parametrize("factor", [3, 15])
def test_native_decode_fir_equal_jax(native_files, factor):
    paths = [native_files["pcm16_mono"], native_files["float32_stereo"],
             native_files["pcm24_mono"]]
    out_t, rates_t, len_t = tnative.decode_batch_fir(paths, 1500, [factor] * 3)
    out_j, rates_j, len_j = jnative.decode_batch_fir(paths, 1500, [factor] * 3)
    np.testing.assert_array_equal(rates_t, rates_j)
    np.testing.assert_array_equal(len_t, len_j)
    np.testing.assert_array_equal(out_t, out_j)


def test_numpy_fallbacks_equal_jax(native_files, monkeypatch):
    """With the library unavailable, both packages decode with numpy alike."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    paths = [native_files["pcm16_mono"], native_files["pcm8_odd_chunks"]]
    for fn, kw in ((tnative.decode_batch_f32, dict(strides=[2, 3])),
                   (tnative.decode_batch_i16, dict(strides=[4, 1])),
                   (tnative.decode_batch_fir, dict(factors=[3, 5]))):
        got = fn(paths, 2000, **kw)
        exp = getattr(jnative, fn.__name__)(paths, 2000, **kw)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("factor,taps_per_phase", [(2, 8), (15, 8), (146, 8), (7, 4)])
def test_fir_taps_equal_jax(factor, taps_per_phase):
    np.testing.assert_array_equal(tnative.fir_taps(factor, taps_per_phase),
                                  jnative.fir_taps(factor, taps_per_phase))


def test_native_library_built_outside_the_tree():
    """The port's loader writes its library under .torch_build/, keyed by
    the source's hash, and never into native/."""
    if not tnative.available():
        pytest.skip("native library unavailable (no g++)")
    lib = tnative._build()
    assert lib.parent == tnative.BUILD_DIR and lib.name.startswith("libbpmwav-")
    assert tnative.SOURCE.parent.name == "native"
