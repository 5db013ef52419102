"""Synthetic phonocardiograms for tests and chip runs.

Copies of ``bench.synth_recording`` and ``bench._quantize_int16``: the same
generator, the same ``np.random.RandomState`` stream, so a seed gives the
bit-identical recording the CPU reference's cached beats
(``bench_cpu_baseline.json``) were computed from.
"""
import numpy as np

SR = 302
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


def _quantize_int16(sig: np.ndarray) -> np.ndarray:
    peak = np.max(np.abs(sig)) or 1.0
    return np.int16(sig / peak * 32767)
