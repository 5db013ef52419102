"""Synthetic phonocardiograms for tests and chip runs.

Copies of ``bench.synth_recording``, ``bench.synth_stress_recording``,
``bench.synth_recording_native`` and ``bench._quantize_int16``: the same
generators, the same ``np.random.RandomState`` streams, so a seed gives
the bit-identical recording the CPU reference's cached beats were computed
from (``bench_cpu_baseline.json`` and ``bench_cpu_stress.json`` at 302 Hz,
``bench_cpu_native.json`` at 44.1 kHz).
"""
import numpy as np

SR = 302
NATIVE_SR = 44100
MINUTES = 10
N_SAMPLES = SR * 60 * MINUTES


def synth_recording(seed: int) -> np.ndarray:
    """Synthetic band-passed phonocardiogram at the decimated 302 Hz rate:
    S1/S2 pulse train following an exertion/recovery HR profile
    (80 -> 170 -> 95 BPM), light noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(N_SAMPLES) / SR
    dur = t[-1]
    hr = np.interp(t, [0, dur * 0.3, dur * 0.5, dur * 0.8, dur],
                   [80, 170, 150, 95, 95]) + rng.randn(N_SAMPLES).cumsum() * 1e-4
    hr = np.clip(hr, 60, 200)
    phase = np.cumsum(hr / 60.0 / SR)
    impulses = np.zeros(N_SAMPLES, np.float32)
    beat_mask = np.diff(np.floor(phase), prepend=0.0) > 0
    beats = np.nonzero(beat_mask)[0]
    impulses[beats] = 1000.0 * (1 + 0.1 * rng.randn(len(beats)))
    rr = 60.0 / hr[beats] * SR
    s2 = (beats + 0.33 * rr).astype(int)
    s2 = s2[s2 < N_SAMPLES]
    impulses[s2] = 450.0 * (1 + 0.1 * rng.randn(len(s2)))
    kernel = (np.exp(-np.arange(36) / 7.0) * np.cos(np.arange(36) * 0.85)).astype(np.float32)
    sig = np.convolve(impulses, kernel, mode="same")
    sig += rng.randn(N_SAMPLES).astype(np.float32) * 8.0
    return sig.astype(np.float32)


def synth_stress_recording(seed: int) -> np.ndarray:
    """Recordings outside the exertion family at 302 Hz, four families
    cycled by seed: 0 hard clipping at 35% of the peak, 1 three 8 s
    dropouts, 2 a constant 40 BPM, 3 a sustained 165 BPM with five 1 s
    noise bursts."""
    family = seed % 4
    rng = np.random.RandomState(50_000 + seed)
    t = np.arange(N_SAMPLES) / SR
    dur = t[-1]
    if family == 2:
        hr = np.full(N_SAMPLES, 40.0) + rng.randn(N_SAMPLES).cumsum() * 5e-5
    elif family == 3:
        hr = np.full(N_SAMPLES, 165.0) + rng.randn(N_SAMPLES).cumsum() * 1e-4
    else:
        hr = np.interp(t, [0, dur * 0.3, dur * 0.5, dur * 0.8, dur],
                       [80, 170, 150, 95, 95]) + rng.randn(N_SAMPLES).cumsum() * 1e-4
    hr = np.clip(hr, 35, 200)
    phase = np.cumsum(hr / 60.0 / SR)
    impulses = np.zeros(N_SAMPLES, np.float32)
    beats = np.nonzero(np.diff(np.floor(phase), prepend=0.0) > 0)[0]
    impulses[beats] = 1000.0 * (1 + 0.1 * rng.randn(len(beats)))
    rr = 60.0 / hr[beats] * SR
    s2 = (beats + 0.33 * rr).astype(int)
    s2 = s2[s2 < N_SAMPLES]
    impulses[s2] = 450.0 * (1 + 0.1 * rng.randn(len(s2)))
    kernel = (np.exp(-np.arange(36) / 7.0) * np.cos(np.arange(36) * 0.85)).astype(np.float32)
    sig = np.convolve(impulses, kernel, mode="same")
    sig += rng.randn(N_SAMPLES).astype(np.float32) * 8.0
    if family == 0:
        lim = 0.35 * np.abs(sig).max()
        sig = np.clip(sig, -lim, lim)
    elif family == 1:
        for _ in range(3):
            start = rng.randint(0, N_SAMPLES - 8 * SR)
            sig[start: start + 8 * SR] = 0.0
    elif family == 3:
        for _ in range(5):
            start = rng.randint(0, N_SAMPLES - SR)
            sig[start: start + SR] += rng.randn(SR).astype(np.float32) * 160.0
    return sig.astype(np.float32)


def synth_recording_native(seed: int, sr: int = NATIVE_SR) -> np.ndarray:
    """The same synthetic phonocardiogram family at a native recording rate:
    the pulse kernel is the continuous-time version of the 302 Hz one
    (decay tau = 7/302 s, carrier 0.85*302/2pi ~ 40.9 Hz, duration
    36/302 s), so the reference's stride decimation recovers an equivalent
    302 Hz signal."""
    rng = np.random.RandomState(10_000 + seed)
    n = sr * 60 * MINUTES
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


def _quantize_int16(sig: np.ndarray) -> np.ndarray:
    peak = np.max(np.abs(sig)) or 1.0
    return np.int16(sig / peak * 32767)
