"""Butterworth band-pass + zero-phase filtering (scipy ``filtfilt`` parity).

Port of ``bpm_analysis_tpu/ops/filter.py``.  The host-side design functions
(:func:`butter_bandpass`, :func:`lfilter_zi`) are numpy copies.  The device
side is the same block-affine formulation of the IIR recurrence
``s[n] = A s[n-1] + B x[n]``: split the signal into length-``L`` blocks; the
in-block output is one Toeplitz matmul plus a rank-``m`` carry-in term, and
the block carries compose through a length-``nb`` affine scan — here a
Python loop over blocks, vectorized over the batch.

Products stay full float32 on the card: the float32 matmuls below rely on
``torch.backends.cuda.matmul.allow_tf32`` being False (PyTorch's default);
TF32 products re-amplify through the recursive carry.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .indexing import arange, take


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
    """Host-side (float64) tables of the blocked lfilter: (A_L, G, U, T, b0)
    with ``A_L = A^L``, ``G[j] = (A^j)[0, :]``, ``U[i] = A^{L-1-i} B`` and
    the strict-upper Toeplitz ``T[i, j] = h[j-1-i]``, ``h[d] = (A^d B)[0]``."""
    A, B, b0 = _df2t_matrices(b, a)
    m = A.shape[0]
    powers = np.empty((L + 1, m, m))
    powers[0] = np.eye(m)
    for j in range(1, L + 1):
        powers[j] = powers[j - 1] @ A
    G = powers[:L, 0, :]
    U = np.einsum("lij,j->li", powers[L - 1::-1], B)
    h = np.einsum("lij,j->li", powers[:L], B)[:, 0]
    ii, jj = np.indices((L, L))
    d = jj - 1 - ii
    T = np.where(d >= 0, h[np.clip(d, 0, L - 1)], 0.0)
    return powers[L], G, U, T, b0


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """scipy ``lfilter(b, a, x[r], zi=zi[r])[0]`` for every row of ``x``
    (B, n), with ``zi`` (B, m), via the blocked formulation."""
    dtype, dev = x.dtype, x.device
    bsz, n = x.shape
    L = min(block, max(8, n))
    A_L_np, G_np, U_np, T_np, b0 = _block_filter_tables(b, a, L)
    A_L = torch.as_tensor(A_L_np, dtype=dtype, device=dev)
    G = torch.as_tensor(G_np, dtype=dtype, device=dev)
    U = torch.as_tensor(U_np, dtype=dtype, device=dev)
    T = torch.as_tensor(T_np, dtype=dtype, device=dev)

    nb = -(-n // L)
    X = torch.nn.functional.pad(x, (0, nb * L - n)).reshape(bsz, nb, L)
    C = X @ U                                   # (B, nb, m) carry contributions

    s = zi.to(dtype)
    carries = []
    A_LT = A_L.T
    for k in range(nb):                         # carry-IN of each block
        carries.append(s)
        s = s @ A_LT + C[:, k]
    S0 = torch.stack(carries, dim=1)            # (B, nb, m)

    Y = b0 * X + S0 @ G.T + X @ T
    return Y.reshape(bsz, -1)[:, :n]


def filtfilt(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """scipy ``filtfilt(b, a, x)`` along the last axis, default odd padding."""
    padlen = 3 * max(len(a), len(b))
    n = x.shape[1]
    if n <= padlen:
        raise ValueError(f"input length {n} must exceed padlen {padlen}")
    zi = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype, device=x.device)
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
    zi = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype, device=x.device)

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
