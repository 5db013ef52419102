"""Synthetic phonocardiograms from outside the exertion family: a copy of
the port's ``synth.synth_stress_recording`` (the same
``np.random.RandomState`` stream, so an id gives the bit-identical
recording at the ten-minute length), with the length as a parameter."""
import numpy as np

from .synth import SR


def synth_stress_recording(seed: int, minutes: float = 10) -> np.ndarray:
    """Four families cycled by seed at 302 Hz: 0 hard clipping at 35% of
    the peak, 1 three 8 s dropouts, 2 a constant 40 BPM, 3 a sustained
    165 BPM with five 1 s noise bursts."""
    family = seed % 4
    rng = np.random.RandomState(50_000 + seed)
    n = int(SR * 60 * minutes)
    t = np.arange(n) / SR
    dur = t[-1]
    if family == 2:
        hr = np.full(n, 40.0) + rng.randn(n).cumsum() * 5e-5
    elif family == 3:
        hr = np.full(n, 165.0) + rng.randn(n).cumsum() * 1e-4
    else:
        hr = np.interp(t, [0, dur * 0.3, dur * 0.5, dur * 0.8, dur],
                       [80, 170, 150, 95, 95]) + rng.randn(n).cumsum() * 1e-4
    hr = np.clip(hr, 35, 200)
    phase = np.cumsum(hr / 60.0 / SR)
    impulses = np.zeros(n, np.float32)
    beats = np.nonzero(np.diff(np.floor(phase), prepend=0.0) > 0)[0]
    impulses[beats] = 1000.0 * (1 + 0.1 * rng.randn(len(beats)))
    rr = 60.0 / hr[beats] * SR
    s2 = (beats + 0.33 * rr).astype(int)
    s2 = s2[s2 < n]
    impulses[s2] = 450.0 * (1 + 0.1 * rng.randn(len(s2)))
    kernel = (np.exp(-np.arange(36) / 7.0) * np.cos(np.arange(36) * 0.85)).astype(np.float32)
    sig = np.convolve(impulses, kernel, mode="same")
    sig += rng.randn(n).astype(np.float32) * 8.0
    if family == 0:
        lim = 0.35 * np.abs(sig).max()
        sig = np.clip(sig, -lim, lim)
    elif family == 1:
        for _ in range(3):
            start = rng.randint(0, n - 8 * SR)
            sig[start: start + 8 * SR] = 0.0
    elif family == 3:
        for _ in range(5):
            start = rng.randint(0, n - SR)
            sig[start: start + SR] += rng.randn(SR).astype(np.float32) * 160.0
    return sig.astype(np.float32)
