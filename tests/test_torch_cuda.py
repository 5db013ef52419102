"""The CUDA kernels (knot quantile, strided quantile) against their plain
versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  The machine
with the card has no JAX, so run these without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu_torch.ops import knot_quantile as kq
from bpm_analysis_tpu_torch.ops.cuda import knot_kernel, quantile_kernel

CASES = chip_smoke.kernel_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pos, val, cnt, n, window, stride, ms, nv = case
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (pos, val, cnt)]
    nv_t = None if nv is None else torch.from_numpy(nv).to(dev)
    before = knot_kernel.launches
    got = knot_kernel.knot_quantile_anchors(*args, n, window, 0.2, min_periods=3,
                                            stride=stride, min_spacing=ms, n_valid=nv_t)
    torch.cuda.synchronize()
    assert knot_kernel.launches == before + 1
    exp = kq.rolling_quantile_knots(*args, n, window, 0.2, min_periods=3, stride=stride,
                                    min_spacing=ms, n_valid=nv_t, dtype=torch.float32)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=chip_smoke.RTOL, atol=chip_smoke.ATOL, equal_nan=True)


@pytest.mark.gpu
def test_knot_kernel_fast_division_equals_ieee_division():
    """The knot kernel's hoisted-reciprocal division gives div.rn.f32's
    quotient bit for bit over its operand range (2^28 pseudo-random pairs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert knot_kernel.division_mismatches(1 << 28, seed=1) == 0


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    val = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    cnt = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        knot_kernel.knot_quantile_anchors(pos.long(), val, cnt, 100, 31, 0.2)
    with pytest.raises(ValueError):
        knot_kernel.knot_quantile_anchors(pos, val.double(), cnt, 100, 31, 0.2)
    strided = torch.zeros((1, 16), dtype=torch.int32, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        knot_kernel.knot_quantile_anchors(strided, val, cnt, 100, 31, 0.2)


STRIDED_CASES = chip_smoke.strided_kernel_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("case", STRIDED_CASES, ids=[c[0] for c in STRIDED_CASES])
def test_strided_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, x, window, stride, q, mp = case
    xt = torch.from_numpy(x).to("cuda")
    before = quantile_kernel.launches
    got = quantile_kernel.strided_quantile_anchors(xt, window, q, mp, stride)
    torch.cuda.synchronize()
    assert quantile_kernel.launches == before + 1
    exp = quantile_kernel.plain_anchors(xt, window, q, mp, stride)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=chip_smoke.STRIDED_RTOL, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_strided_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((2, 400), dtype=torch.float32, device="cuda")
    before = quantile_kernel.launches
    for bad in (x.to(torch.int32), x.double(), x[:, ::2], x[0]):
        with pytest.raises(ValueError):
            quantile_kernel.strided_quantile_anchors(bad, 61, 0.2, 3, 8)
    with pytest.raises(ValueError):
        quantile_kernel.strided_quantile_anchors(x, quantile_kernel.MAX_WINDOW + 1, 0.2, 3, 8)
    assert quantile_kernel.launches == before
