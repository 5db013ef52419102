"""The frozen bounds start from chip_smoke's numbers at the main path's
shapes."""
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_port.yardstick import bounds

sys.path.insert(0, bounds.__file__.rsplit("/bench_port/", 1)[0])
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("bsz", [16, 128])
@pytest.mark.parametrize("want_trace", [False, True])
def test_classify_bound_matches_chip_smoke(bsz, want_trace):
    x = SimpleNamespace(positions=torch.zeros(bsz, 2560, dtype=torch.int32),
                        deviation=torch.zeros(bsz, 2560, dtype=torch.float32))
    want = chip_smoke.scan_bound(x, want_trace, bounds.SM_CLOCK_HZ)
    assert bounds.classify_scan_ms(bsz, 2560, 4, want_trace) == want


@pytest.mark.parametrize("bsz", [16, 128])
def test_filter_bound_matches_chip_smoke(bsz):
    x = torch.zeros(bsz, 181_230, dtype=torch.float32)
    want = chip_smoke.filter_bound(x, 256, 4, bounds.SM_CLOCK_HZ)
    assert bounds.filter_ms(bsz, 181_230, 256, 4, 4) == want


def test_distance_capacity_matches_the_port():
    from bpm_analysis_tpu_torch.ops import find_peaks

    for n, d in [(181_200, 15), (181_233, 15), (36_247, 15), (1000, 3)]:
        assert bounds.distance_capacity(n, d) == find_peaks.distance_capacity_bound(n, d)
