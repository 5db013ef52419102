"""The filter's products are sums in a fixed order, so a recording filters to
the same bits in any batch (ROADMAP C6).

A library matmul picks its kernel, and so the association of its sums, from
the whole shape; on the card that once moved a beat between a recording
analysed alone and in a batch of 16.  Each filter function here is held row
by row, bit for bit (``torch.equal``), between the row alone and the same
row in batches of 2, 5 and 16, in float32 and float64, and the ordered
products are held bit for bit against numpy loops in their documented
order.  Parity with JAX and scipy stays in tests/test_torch_envelope.py.
The card test (tests/test_torch_cuda.py) repeats the batch check there.
"""
import numpy as np
import pytest
import torch

from bpm_analysis_tpu_torch.ops import filter as tfilter

SR = 302
N = 1500
BATCHES = (2, 5, 16)


def _signals(dtype, device="cpu", rows=16, n=N, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    x = (rng.randn(rows, n) * 300 + 2000 * np.sin(2 * np.pi * 1.7 * t)[None]
         + 800 * np.sin(2 * np.pi * 41.0 * t)[None])
    return torch.from_numpy(x.astype(dtype)).to(device)


def _filters(device="cpu"):
    b, a = tfilter.butter_bandpass(2, 20.0, 150.0, SR)
    zi = tfilter.lfilter_zi(b, a)
    n_valid = torch.tensor([N, 1200, 901, N - 1, 700, 1400, 1000, 1100,
                            N, 950, 1320, 1499, 800, 1010, 1234, 999], device=device)

    def lfilter(x, rows):
        zi_t = torch.as_tensor(zi, dtype=x.dtype, device=x.device)[None, :] * x[:, :1]
        return tfilter.lfilter(b, a, x, zi_t)

    return {
        "lfilter": lfilter,
        "filtfilt": lambda x, rows: tfilter.filtfilt(b, a, x),
        "filtfilt_masked": lambda x, rows: tfilter.filtfilt_masked(b, a, x, n_valid[rows]),
        "bandpass_filtfilt": lambda x, rows: tfilter.bandpass_filtfilt(x, SR, 20.0, 150.0, 2),
        "bandpass_filtfilt_n_valid": lambda x, rows: tfilter.bandpass_filtfilt(
            x, SR, 20.0, 150.0, 2, n_valid=n_valid[rows]),
        "fir_decimate": lambda x, rows: tfilter.fir_decimate(x, 7),
    }


FILTERS = tuple(sorted(_filters()))


def assert_rows_do_not_depend_on_the_batch(name, dtype, device):
    """Each row of filter ``name`` alone equals the same row in batches of
    2, 5 and 16, bit for bit, on ``device``."""
    fn = _filters(device)[name]
    x = _signals(dtype, device)
    alone = [fn(x[r:r + 1], torch.tensor([r], device=device))[0] for r in range(16)]
    for bsz in BATCHES:
        for start in range(0, 16, bsz):
            rows = torch.arange(start, min(start + bsz, 16), device=device)
            out = fn(x[rows], rows)
            for i, r in enumerate(rows.tolist()):
                assert torch.equal(out[i], alone[r]), (name, bsz, r)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", FILTERS)
def test_row_output_does_not_depend_on_the_batch(name, dtype):
    assert_rows_do_not_depend_on_the_batch(name, dtype, "cpu")


def test_ordered_matmul_is_ascending_term_order():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 37).astype(np.float32)
    w = rng.randn(37, 4).astype(np.float32)
    got = tfilter.ordered_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    exp = x[..., 0:1] * w[0]
    for k in range(1, 37):
        exp = exp + x[..., k:k + 1] * w[k]
    np.testing.assert_array_equal(got, exp)


def test_toeplitz_apply_is_ascending_lag_order():
    rng = np.random.RandomState(2)
    L = 24
    x = rng.randn(2, 3, L).astype(np.float32)
    h = [float(v) for v in rng.randn(L - 1).astype(np.float32)]
    got = tfilter.toeplitz_apply(torch.from_numpy(x), h).numpy()
    exp = np.zeros_like(x)
    for i in range(L):
        acc = np.float32(0)
        for d in range(i):
            acc = np.float32(acc + np.float32(h[d]) * x[..., i - 1 - d])
        exp[..., i] = acc
    np.testing.assert_array_equal(got, exp)
    # The same product as the dense Toeplitz matrix, up to association.
    T = np.zeros((L, L), np.float64)
    for i in range(L):
        for j in range(i + 1, L):
            T[i, j] = h[j - 1 - i]
    np.testing.assert_allclose(got, x.astype(np.float64) @ T, rtol=1e-5, atol=1e-5)
