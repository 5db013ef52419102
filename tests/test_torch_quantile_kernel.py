"""Port vs JAX: the dense rolling quantiles of the noise floor and the plain
version of the CUDA strided-quantile kernel.

* ``strided_quantile_anchors`` / ``rolling_quantile_centered_strided`` against
  the JAX "xla" ``rolling_quantile_centered_strided`` on the inputs of
  tests/test_pallas_quantile.py.  float32 at that file's rtol 1e-6; float64
  at rtol 1e-15: the selections pick the same element, and XLA:CPU at the
  slow tier's O2 contracts the final ``v_lo + frac * (v_hi - v_lo)`` into one
  fused multiply-add (1 ulp; bit-equal at the fast tier's O0).
* The kernel's plain version (``strided_quantile_anchors_f32_plain``) against the
  TPU kernel itself, ``strided_quantile_anchors_pallas`` in interpret mode,
  at rtol 1e-6, and its raw-bit validity (+inf, negatives and -0.0 are
  missing).  The CUDA kernel itself runs only on a card:
  tests/test_torch_cuda.py.
* The exact wavelet-tree ``rolling_quantile_centered`` against JAX: NaN runs,
  ties, ``min_periods`` edges, n = 1 and n not a power of two; equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu.ops import quantile as jq
from bpm_analysis_tpu.ops.pallas import quantile_kernel as jqk
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.kernels import build

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-15}

WINDOWS = [(603, 8), pytest.param(301, 4, marks=pytest.mark.slow)]   # twin per tier


def _pallas_case_input(dtype=np.float32):
    """tests/test_pallas_quantile.py's input: |randn| * 100, NaN prefix."""
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(2, 3000).astype(np.float32)) * 100
    x[0, :40] = np.nan
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("window,stride", WINDOWS)
def test_strided_matches_jax_xla(window, stride, dtype):
    x = _pallas_case_input(dtype)
    x[1, 500:700] = np.round(x[1, 500:700] / 40)            # ties
    got = tq.rolling_quantile_centered_strided(torch.from_numpy(x), window, 0.2, 3,
                                               stride=stride, chunk=96).numpy()
    exp = np.stack([np.asarray(jq.rolling_quantile_centered_strided(
        jnp.asarray(r), window, 0.2, 3, stride=stride)) for r in x])
    assert got.dtype == exp.dtype and got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL[dtype], atol=0, equal_nan=True)
    anchors = tq.strided_quantile_anchors(torch.from_numpy(x), window, 0.2, 3,
                                          stride=stride).numpy()
    np.testing.assert_array_equal(anchors, got[:, ::stride])


@pytest.mark.parametrize("window,stride", WINDOWS)
def test_plain_version_matches_pallas_kernel_interpret(window, stride):
    x = _pallas_case_input()
    got = tq.strided_quantile_anchors_f32_plain(torch.from_numpy(x), window, 0.2, 3,
                                                stride=stride).numpy()
    exp = np.asarray(jqk.strided_quantile_anchors_pallas(
        jnp.asarray(x), window, 0.2, 3, stride, interpret=True))
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)


def test_kernel_cases_plain_matches_jax_xla():
    """chip_smoke.py's B2 cases (a masked tail, a row shorter than one
    window; all but the engine shapes): the plain version against the JAX
    "xla" anchors in float32."""
    for name, x, window, stride, q, mp in chip_smoke.strided_kernel_cases():
        if name == "engine_shapes":
            continue
        got = tq.strided_quantile_anchors_f32_plain(torch.from_numpy(x), window, q, mp,
                                                    stride=stride).numpy()
        exp = np.stack([np.asarray(jq.rolling_quantile_centered_strided(
            jnp.asarray(r), window, q, mp, stride=stride))[::stride] for r in x])
        np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True, err_msg=name)


def test_plain_version_treats_raw_bits_as_the_kernel_does():
    """+inf, negative values and -0.0 are missing (their raw bits are not
    below +inf's); the result equals the "xla" quantile of the series with
    those samples set to NaN."""
    rng = np.random.RandomState(4)
    x = (np.abs(rng.randn(2, 400)) * 10).astype(np.float32)
    x[0, 50:60] = np.inf
    x[0, 100:110] = -3.0
    x[1, 200:210] = -0.0
    x[1, 300] = np.nan
    got = tq.strided_quantile_anchors_f32_plain(torch.from_numpy(x), 61, 0.3, 3, stride=5).numpy()
    masked = np.where(np.signbit(x) | np.isinf(x), np.nan, x)
    exp = tq.strided_quantile_anchors(torch.from_numpy(masked), 61, 0.3, 3, stride=5).numpy()
    np.testing.assert_array_equal(got, exp)
    assert not np.array_equal(
        got, tq.strided_quantile_anchors(torch.from_numpy(x), 61, 0.3, 3, stride=5).numpy(),
        equal_nan=True)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_pallas_case_input())
    before = build.launches["strided_quantile"]
    got = tq.strided_quantile_anchors_f32(x, 603, 0.2, 3, stride=8)
    assert build.launches["strided_quantile"] == before   # no kernel launch on the CPU
    np.testing.assert_array_equal(got.numpy(),
                                  tq.strided_quantile_anchors_f32_plain(x, 603, 0.2, 3, 8).numpy())
    dense = tq.rolling_quantile_strided_f32(x.double(), 603, 0.2, 3, stride=8)
    assert dense.dtype == torch.float64 and dense.shape == x.shape
    np.testing.assert_array_equal(dense.numpy()[:, ::8], got.numpy().astype(np.float64))
    for bad in (x.double(), x.to(torch.int32), x[:, ::2], x[0]):
        with pytest.raises(ValueError):
            tq.strided_quantile_anchors_f32(bad, 603, 0.2, 3, stride=8)
    with pytest.raises(ValueError):
        tq.strided_quantile_anchors_f32(x.to("meta"), 603, 0.2, 3, stride=8)


def _rows(n, seed):
    """Rows: NaN runs and scattered NaN, heavy ties, all-NaN."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n) * 40
    a[n // 4: n // 4 + max(1, n // 10)] = np.nan
    b = np.round(rng.randn(n) * 2)
    b[rng.rand(n) < 0.2] = np.nan
    c = np.full(n, np.nan)
    return np.stack([a, b, c])


@pytest.mark.parametrize("n", [1, 2, 37, 300])
def test_wavelet_quantile_matches_jax(n):
    x = _rows(n, seed=n)
    for window, mp, q in ((5, 1, 0.2), (31, 3, 0.5), (4, 4, 0.9), (301, 3, 0.1)):
        got = tq.rolling_quantile_centered(torch.from_numpy(x), window, q, mp).numpy()
        exp = np.stack([np.asarray(jq.rolling_quantile_centered(jnp.asarray(r), window, q, mp))
                        for r in x])
        np.testing.assert_array_equal(got, exp, err_msg=f"window {window} q {q}")
