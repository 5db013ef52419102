"""The CUDA knot-quantile kernel against its plain version, on the card.

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
from bpm_analysis_tpu_torch.ops.cuda import knot_kernel

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
