"""Butterworth band-pass + zero-phase filtering (scipy ``filtfilt`` parity).

Port of ``bpm_analysis_tpu/ops/filter.py``.  The host-side design functions
(:func:`butter_bandpass`, :func:`lfilter_zi`) are numpy copies.  The device
side is the same block-affine formulation of the IIR recurrence
``s[n] = A s[n-1] + B x[n]``: split the signal into length-``L`` blocks; the
in-block output is a Toeplitz product plus a rank-``m`` carry-in term, and
the block carries compose through a length-``nb`` affine scan — here a
Python loop over blocks, vectorized over the batch.  :func:`fir_decimate`
is the antialias decimator of the north-star preprocessing path.

Every product is a sum taken in a fixed order (:func:`ordered_matmul`,
:func:`toeplitz_apply`): separate elementwise multiplies and adds, term by
term in ascending order.  A library matmul picks its kernel, and so its
association, from the whole shape, so a recording's filtered signal would
depend on the batch it is filtered in; here each row's output is a
function of that row alone, bit for bit, on any device.  On the card
:func:`lfilter` is the CUDA kernel ``csrc/block_filter.cu`` (the same
products in the same order, through ``ops/cuda/filter_kernel``);
:func:`lfilter_plain` is its plain version.  :class:`BlockFilter`'s pieces
serve the sequence-sharded relay too (``parallel/seqshard.py``) through
:func:`contributions`, :func:`carry_scan` and :func:`apply`: the pieces
themselves on the CPU, the kernel's phase entry points on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import upload
from .cuda import filter_kernel
from .indexing import arange, take

_KEEP = 16              # filter designs whose tables stay on the card
_designs: dict = {}     # (b, a, L, dtype, device) -> BlockFilter, for the kernel


def _butter_analog_poles(order: int) -> np.ndarray:
    k = np.arange(order)
    return np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))


def butter_bandpass(order: int, low_hz: float, high_hz: float, fs: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``scipy.signal.butter(order, [low, high], btype='band', fs=fs)``.

    Analog lowpass prototype → lp2bp (zpk) → bilinear (zpk) → tf, with
    scipy's frequency pre-warping."""
    nyq = fs / 2.0
    wn = np.array([low_hz, high_hz]) / nyq
    fs2 = 2.0
    warped = 2 * fs2 * np.tan(np.pi * wn / fs2)
    bw = warped[1] - warped[0]
    wo = np.sqrt(warped[0] * warped[1])

    # Analog prototype (zpk): no zeros, Butterworth poles, gain 1.
    p = _butter_analog_poles(order)
    k = 1.0

    # lp2bp_zpk
    p_lp = p * bw / 2
    p_bp = np.concatenate([
        p_lp + np.sqrt(p_lp ** 2 - wo ** 2),
        p_lp - np.sqrt(p_lp ** 2 - wo ** 2),
    ])
    z_bp = np.zeros(order)
    k_bp = k * bw ** order

    # bilinear_zpk
    fs2x = 2 * fs2
    z_d = (fs2x + z_bp) / (fs2x - z_bp)
    p_d = (fs2x + p_bp) / (fs2x - p_bp)
    z_d = np.concatenate([z_d, -np.ones(len(p_bp) - len(z_bp))])
    k_d = k_bp * np.real(np.prod(fs2x - z_bp) / np.prod(fs2x - p_bp))

    b = k_d * np.real(np.poly(z_d))
    a = np.real(np.poly(p_d))
    return b, a


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """scipy.signal.lfilter_zi: steady-state DF2T initial conditions."""
    n = len(a)
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - A, B)


def _df2t_matrices(b: np.ndarray, a: np.ndarray):
    """State-space (A, B, b0) of the direct-form-II-transposed recurrence
    with y folded out: s[n] = A s[n-1] + B x[n]; y[n] = b0 x[n] + s[n-1][0]."""
    n = len(a)
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return A, B, b[0]


def _block_filter_tables(b: np.ndarray, a: np.ndarray, L: int):
    """Host-side (float64) tables of the blocked lfilter: (A_L, G, U, h, b0)
    with ``A_L = A^L``, ``G[j] = (A^j)[0, :]``, ``U[i] = A^{L-1-i} B`` and
    the lags ``h[d] = (A^d B)[0]`` of the strict-upper Toeplitz
    ``T[i, j] = h[j-1-i]``."""
    A, B, b0 = _df2t_matrices(b, a)
    m = A.shape[0]
    powers = np.empty((L + 1, m, m))
    powers[0] = np.eye(m)
    for j in range(1, L + 1):
        powers[j] = powers[j - 1] @ A
    G = powers[:L, 0, :]
    U = np.einsum("lij,j->li", powers[L - 1::-1], B)
    h = np.einsum("lij,j->li", powers[:L], B)[:, 0]
    return powers[L], G, U, h, b0


def ordered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` (..., K) and ``w`` (K, N) as K separate
    multiplies and K - 1 adds in ascending term order:
    ``(x[0] w[0] + x[1] w[1]) + x[2] w[2] + ...``, whatever the shapes."""
    acc = x[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def toeplitz_apply(X: torch.Tensor, h) -> torch.Tensor:
    """``X @ T`` for the strict-upper Toeplitz ``T[i, j] = h[j-1-i]`` of
    :func:`_block_filter_tables`, over the last axis of ``X`` (..., L):
    ``y[i] = sum_d h[d] * x[i-1-d]``, one shifted multiply and add per lag
    ``d``, in ascending ``d``.  ``h`` holds Python floats already rounded to
    the working dtype."""
    L = X.shape[-1]
    y = torch.zeros_like(X)
    for d in range(L - 1):
        y[..., d + 1:] += X[..., :L - 1 - d] * h[d]
    return y


class BlockFilter(NamedTuple):
    """The blocked filter's tables in the working dtype: ``A_LT = (A^L).T``,
    ``U`` (L, m), ``GT = G.T`` (m, L), the Toeplitz lags ``h`` (Python
    floats) and ``b0``.  Its methods are the plain versions of the filter
    kernel's phases (``ops/cuda/filter_kernel``)."""
    A_LT: torch.Tensor
    U: torch.Tensor
    GT: torch.Tensor
    h: list
    b0: float

    @classmethod
    def build(cls, b: np.ndarray, a: np.ndarray, L: int, dtype, device) -> "BlockFilter":
        A_L, G, U, h, b0 = _block_filter_tables(b, a, L)
        npd = np.float32 if dtype == torch.float32 else np.float64
        h = [float(v) for v in np.asarray(h[:L - 1], npd)]

        def table(t):
            return torch.as_tensor(t, dtype=dtype, device=device)

        return cls(table(A_L).T, table(U), table(G).T, h, b0)

    def contributions(self, X: torch.Tensor) -> torch.Tensor:
        """(B, nb, m) carry contribution of each block of ``X`` (B, nb, L)."""
        return ordered_matmul(X, self.U)

    def carry_scan(self, C: torch.Tensor, s: torch.Tensor):
        """(exit state, (B, nb, m) carry-in of each block) of the block carry
        scan from the entry state ``s`` (B, m)."""
        carries = []
        for k in range(C.shape[1]):
            carries.append(s)
            s = ordered_matmul(s, self.A_LT) + C[:, k]
        return s, torch.stack(carries, dim=1)

    def apply(self, X: torch.Tensor, S0: torch.Tensor) -> torch.Tensor:
        """In-block outputs (B, nb, L) from the blocks and their carry-ins."""
        return self.b0 * X + ordered_matmul(S0, self.GT) + toeplitz_apply(X, self.h)


def _design(b: np.ndarray, a: np.ndarray, L: int, dtype, device) -> BlockFilter:
    """The :class:`BlockFilter` of (b, a) at block length ``L``, built once
    and kept (the last few designs), so a kernel call costs the launch
    alone."""
    key = (np.asarray(b, np.float64).tobytes(), np.asarray(a, np.float64).tobytes(), L,
           dtype, str(device))
    bf = _designs.get(key)
    if bf is None:
        if len(_designs) >= _KEEP:
            _designs.pop(next(iter(_designs)))
        bf = _designs[key] = BlockFilter.build(b, a, L, dtype, device)
    return bf


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """scipy ``lfilter(b, a, x[r], zi=zi[r])[0]`` for every row of ``x``
    (B, n), with ``zi`` (B, m): the CUDA kernel ``csrc/block_filter.cu`` on
    the card, :func:`lfilter_plain` on the CPU."""
    if x.device.type == "cpu":
        return lfilter_plain(b, a, x, zi, block)
    L = min(block, max(8, x.shape[-1]))
    return filter_kernel.lfilter(_design(b, a, L, x.dtype, x.device), x, zi)


def contributions(bf: BlockFilter, X: torch.Tensor) -> torch.Tensor:
    """``bf.contributions(X)``: on the CPU the piece itself, on the card the
    filter kernel's phase entry point, bit-equal to it."""
    if X.device.type == "cpu":
        return bf.contributions(X)
    return filter_kernel.contributions(bf, X)


def carry_scan(bf: BlockFilter, C: torch.Tensor, s: torch.Tensor):
    """``bf.carry_scan(C, s)``: on the CPU the piece itself, on the card the
    filter kernel's phase entry point, bit-equal to it."""
    if C.device.type == "cpu":
        return bf.carry_scan(C, s)
    return filter_kernel.carry_scan(bf, C, s)


def apply(bf: BlockFilter, X: torch.Tensor, S0: torch.Tensor) -> torch.Tensor:
    """``bf.apply(X, S0)``: on the CPU the piece itself, on the card the
    filter kernel's phase entry point, bit-equal to it."""
    if X.device.type == "cpu":
        return bf.apply(X, S0)
    return filter_kernel.apply(bf, X, S0)


def lfilter_plain(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: torch.Tensor,
                  block: int = 256) -> torch.Tensor:
    """:func:`lfilter` via the blocked formulation in torch operations: the
    plain version of ``csrc/block_filter.cu``, the same products in the same
    order."""
    bsz, n = x.shape
    L = min(block, max(8, n))
    bf = BlockFilter.build(b, a, L, x.dtype, x.device)
    nb = -(-n // L)
    X = torch.nn.functional.pad(x, (0, nb * L - n)).reshape(bsz, nb, L)
    _, S0 = bf.carry_scan(bf.contributions(X), zi.to(x.dtype))
    return bf.apply(X, S0).reshape(bsz, -1)[:, :n]


def filtfilt(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """scipy ``filtfilt(b, a, x)`` along the last axis, default odd padding."""
    padlen = 3 * max(len(a), len(b))
    n = x.shape[1]
    if n <= padlen:
        raise ValueError(f"input length {n} must exceed padlen {padlen}")
    zi = upload("filter_zi", lfilter_zi(b, a), x.dtype, x.device)
    front = 2 * x[:, :1] - x[:, 1:padlen + 1].flip(1)
    back = 2 * x[:, -1:] - x[:, n - padlen - 1:n - 1].flip(1)
    ext = torch.cat([front, x, back], dim=1)
    y = lfilter(b, a, ext, zi[None, :] * ext[:, :1])
    y = lfilter(b, a, y.flip(1), zi[None, :] * y[:, -1:]).flip(1)
    return y[:, padlen:-padlen]


def _rolled_window(y: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """``dynamic_slice(concat([y, y]), (start,), (len(y),))`` per row, with
    the start clamped into range as ``lax.dynamic_slice`` does."""
    n = y.shape[1]
    start = torch.clamp(start.long(), 0, n)[:, None]
    return take(torch.cat([y, y], dim=1), start + arange(n, y)[None, :])


def filtfilt_masked(b: np.ndarray, a: np.ndarray, x: torch.Tensor,
                    n_valid: torch.Tensor) -> torch.Tensor:
    """scipy ``filtfilt(b, a, x[r, :n_valid[r]])`` per row of a zero-padded
    batch: the odd end extension and the backward pass anchor at each row's
    boundary.  Outputs at positions >= n_valid are unspecified."""
    padlen = 3 * max(len(a), len(b))
    bsz, n = x.shape
    if n <= padlen:
        raise ValueError(f"input length {n} must exceed padlen {padlen}")
    nv = n_valid.long().reshape(bsz, 1)
    zi = upload("filter_zi", lfilter_zi(b, a), x.dtype, x.device)

    front = 2 * x[:, :1] - x[:, 1:padlen + 1].flip(1)
    ext = torch.cat([front, x, torch.zeros(bsz, padlen, dtype=x.dtype,
                                           device=x.device)], dim=1)
    # Odd extension about the row's end: 2*x[nv-1] - x[nv-2 .. nv-padlen-1].
    j = arange(padlen, x)[None, :]
    back = 2 * take(x, nv - 1) - take(x, torch.clamp(nv - 2 - j, min=0))
    n_ext = n + 2 * padlen
    start = torch.clamp(padlen + nv, max=n_ext - padlen)
    ext = ext.scatter(1, start + j, back)

    y = lfilter(b, a, ext, zi[None, :] * ext[:, :1])
    yr = _rolled_window(y.flip(1), (n_ext - (nv + 2 * padlen))[:, 0])
    z = lfilter(b, a, yr, zi[None, :] * yr[:, :1])
    # Undo the reversal and strip the pads: out[k] = z[nv + padlen - 1 - k].
    out = _rolled_window(z.flip(1), (n_ext - nv - padlen)[:, 0])
    return out[:, :n]


def bandpass_filtfilt(x: torch.Tensor, fs: float, low_hz: float, high_hz: float,
                      order: int = 2, n_valid=None) -> torch.Tensor:
    b, a = butter_bandpass(order, low_hz, high_hz, fs)
    if n_valid is None:
        return filtfilt(b, a, x)
    return filtfilt_masked(b, a, x, n_valid)


def fir_decimate(x: torch.Tensor, factor: int, taps_per_phase: int = 8) -> torch.Tensor:
    """Anti-aliased decimation of each row of ``x`` (B, N): a Hann-windowed
    sinc low-pass at 90% of the new Nyquist, evaluated only at the kept
    samples.  Returns (B, ceil(N / factor)).

    Polyphase form, as in the JAX package: with the tap index k = j*factor
    + p the strided convolution is one (M, factor) @ (factor, J) product
    ``Y = X @ Hp`` (``X[m, p] = xp[m*factor + p]``, ``Hp[p, j] =
    h[j*factor + p]``) plus J shifted column adds, ``y[m] = sum_j Y[m + j,
    j]``.  The product is :func:`ordered_matmul` in the input's dtype, so
    each row's output is independent of the batch."""
    if factor <= 1:
        return x
    half = taps_per_phase * factor // 2
    n_taps = 2 * half + 1
    t = np.arange(n_taps) - half
    cutoff = 0.9 / factor  # fraction of the input Nyquist
    h = np.sinc(cutoff * t) * cutoff
    h *= np.hanning(n_taps)
    h /= h.sum()

    bsz, n = x.shape
    out_len = -(-n // factor)
    n_phases = -(-n_taps // factor)  # J
    hp = np.zeros((n_phases, factor), dtype=h.dtype)
    hp.flat[:n_taps] = h
    m_rows = out_len + n_phases - 1
    xp = torch.nn.functional.pad(x, (half, m_rows * factor - n - half))
    hpt = upload("fir_taps", np.ascontiguousarray(hp.T), x.dtype, x.device)
    y2 = ordered_matmul(xp.reshape(bsz, m_rows, factor), hpt)   # (B, M, J)
    res = y2[:, 0:out_len, 0]
    for j in range(1, n_phases):
        res = res + y2[:, j:j + out_len, j]
    return res
