"""Synthetic phonocardiograms: copies of the port's ``synth.synth_recording``,
``synth_recording_native`` and ``_quantize_int16`` (the same
``np.random.RandomState`` streams, so an id gives the bit-identical
recording at the ten-minute length), with the length as a parameter."""
import numpy as np

SR = 302
NATIVE_SR = 44100


def synth_recording(seed: int, minutes: float = 10) -> np.ndarray:
    """S1/S2 pulse train at 302 Hz following an exertion/recovery HR profile
    (80 -> 170 -> 95 BPM), light noise."""
    rng = np.random.RandomState(seed)
    n = int(SR * 60 * minutes)
    t = np.arange(n) / SR
    dur = t[-1]
    hr = np.interp(t, [0, dur * 0.3, dur * 0.5, dur * 0.8, dur],
                   [80, 170, 150, 95, 95]) + rng.randn(n).cumsum() * 1e-4
    hr = np.clip(hr, 60, 200)
    phase = np.cumsum(hr / 60.0 / SR)
    impulses = np.zeros(n, np.float32)
    beat_mask = np.diff(np.floor(phase), prepend=0.0) > 0
    beats = np.nonzero(beat_mask)[0]
    impulses[beats] = 1000.0 * (1 + 0.1 * rng.randn(len(beats)))
    rr = 60.0 / hr[beats] * SR
    s2 = (beats + 0.33 * rr).astype(int)
    s2 = s2[s2 < n]
    impulses[s2] = 450.0 * (1 + 0.1 * rng.randn(len(s2)))
    kernel = (np.exp(-np.arange(36) / 7.0) * np.cos(np.arange(36) * 0.85)).astype(np.float32)
    sig = np.convolve(impulses, kernel, mode="same")
    sig += rng.randn(n).astype(np.float32) * 8.0
    return sig.astype(np.float32)


def synth_recording_native(seed: int, minutes: float = 10, sr: int = NATIVE_SR) -> np.ndarray:
    """The same family at a native recording rate: the pulse kernel is the
    continuous-time version of the 302 Hz one."""
    rng = np.random.RandomState(10_000 + seed)
    n = int(sr * 60 * minutes)
    t = np.arange(n) / sr
    dur = t[-1]
    walk = rng.standard_normal(n).cumsum() * (1e-4 / np.sqrt(sr / SR))
    hr = np.interp(t, [0, dur * 0.3, dur * 0.5, dur * 0.8, dur],
                   [80, 170, 150, 95, 95]) + walk
    hr = np.clip(hr, 60, 200)
    phase = np.cumsum(hr / 60.0 / sr)
    beats = np.nonzero(np.diff(np.floor(phase), prepend=0.0) > 0)[0]

    taps = int(round(36 / SR * sr))
    kt = np.arange(taps) / sr
    kernel = (np.exp(-kt * SR / 7.0)
              * np.cos(2 * np.pi * (0.85 * SR / (2 * np.pi)) * kt)).astype(np.float32)

    sig = (rng.standard_normal(n) * 8.0).astype(np.float32)
    rr = 60.0 / hr[beats] * sr
    s2 = (beats + 0.33 * rr).astype(np.int64)
    for pos, amp in [(beats, 1000.0), (s2[s2 < n], 450.0)]:
        amps = amp * (1 + 0.1 * rng.randn(len(pos))).astype(np.float32)
        for p, a in zip(pos, amps):
            end = min(p + taps, n)
            sig[p:end] += a * kernel[: end - p]
    return sig


def quantize_int16(sig: np.ndarray) -> np.ndarray:
    peak = np.max(np.abs(sig)) or 1.0
    return np.int16(sig / peak * 32767)
