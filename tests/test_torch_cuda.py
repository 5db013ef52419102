"""The CUDA kernels (knot quantile, strided quantile, row quantile, rolling
quantile, classifier scan, rhythm scan, blocked filter and its phase entry
points, metrics, distance NMS) against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  The machine
with the card has no JAX, so run these without the suite's conftest (which
imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_filter_batch
from bpm_analysis_tpu_torch.kernels import build
from bpm_analysis_tpu_torch.ops import knot_quantile as kq
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.ops.cuda import (classify_kernel, filter_kernel, knot_kernel,
                                             metrics_kernel, nms_kernel, quantile_kernel,
                                             rhythm_kernel, rolling_quantile_kernel,
                                             row_quantile_kernel)

CASES = chip_smoke.kernel_cases()
LONG_KNOT_SLOTS = 32_768        # long-2h-b64's max_troughs: its knot tables
FILTER_CASES = chip_smoke.filter_cases()
_SCAN_CALLS = {}


def _scan_calls(dtype: str, kickstart: bool):
    """The scan kernels' arguments on the main path of 4 one-minute
    recordings on the card (chip_smoke's phase-3 cases)."""
    key = (dtype, kickstart)
    if key not in _SCAN_CALLS:
        from bpm_analysis_tpu_torch import synth

        batch = np.stack([synth._quantize_int16(synth.synth_recording(s)[:synth.SR * 60])
                          for s in range(4)]).astype(dtype)
        cfg = chip_smoke.scan_config(dtype, kickstart)
        _SCAN_CALLS[key] = cfg, chip_smoke.scan_calls(batch, cfg)
    return _SCAN_CALLS[key]


@pytest.mark.gpu
@pytest.mark.parametrize("kickstart", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_classify_scan_kernel_matches_plain_version(dtype, kickstart):
    """Every one of the 26 trace fields and the classes equal (max abs error
    0, NaN equal to NaN), with and without the trace, on the path's inputs,
    rows cut to 0-4 peaks and a row at full capacity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.models import classifier

    cfg, (c_calls, _) = _scan_calls(dtype, kickstart)
    assert len(c_calls) == 2
    (x, n, sr, _), _ = c_calls[-1]
    for name, xc in chip_smoke.scan_input_cases(x, n):
        for want_trace in (True, False):
            before = build.launches["classify_scan"]
            got = classifier.classify_scan(xc, n, sr, cfg, want_trace=want_trace)
            torch.cuda.synchronize()
            assert build.launches["classify_scan"] == before + 1
            exp = classifier.scan_plain(xc, sr, cfg, want_trace=want_trace)
            assert chip_smoke.trace_error(got, exp) == 0, (name, want_trace)
            if want_trace:
                for f in classifier.ClassifierTrace._fields:
                    assert getattr(got[1], f).dtype == getattr(exp[1], f).dtype, f
                    assert getattr(got[1], f).shape == getattr(exp[1], f).shape, f


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.RHYTHM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rhythm_scan_kernel_matches_plain_version(dtype, case):
    """``written`` and ``victim`` equal on ``chip_smoke.rhythm_cases`` of the
    path's call: the call itself, edge thresholds, unsorted rows, one run
    over a row, rows of several tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.models import corrections

    _, (_, r_calls) = _scan_calls(dtype, False)
    assert len(r_calls) == 1
    (pos, amp, count, threshold, n, sr), _ = r_calls[0]
    cases = {c[0]: c[1:] for c in chip_smoke.rhythm_cases(pos, amp, count, threshold, n, sr)}
    pos, amp, count, threshold, n = cases[case]
    before = build.launches["rhythm_scan"]
    written, victim = rhythm_kernel.rhythm_scan(pos, amp, count, threshold, n, sr)
    torch.cuda.synchronize()
    assert build.launches["rhythm_scan"] == before + 1
    w_exp, v_exp = corrections.rhythm_scan_plain(pos, amp, count, threshold, sr)
    assert torch.equal(written, w_exp) and torch.equal(victim, v_exp)


@pytest.mark.gpu
def test_scan_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.models import classifier

    cfg, (c_calls, r_calls) = _scan_calls("float32", False)
    (x, n, sr, _), _ = c_calls[-1]
    c_before, r_before = build.launches["classify_scan"], build.launches["rhythm_scan"]
    bad = [x._replace(positions=x.positions.long()),                  # dtype
           x._replace(deviation=x.deviation.double()),                # mixed dtypes
           x._replace(count=x.count[:-1]),                            # shape
           x._replace(strength=x.strength.t().contiguous().t()),      # not contiguous
           x._replace(boost=x.boost.cpu())]                           # device
    for xb in bad:
        with pytest.raises(ValueError):
            classifier.classify_scan(xb, n, sr, cfg)
    with pytest.raises(ValueError):
        classifier.classify_scan(x, 1 << 24, sr, cfg)
    consts, codes = classifier._kernel_tables[(sr, cfg, torch.float32, str(x.deviation.device))]
    with pytest.raises(ValueError, match="CUDA"):                  # the wrapper: CUDA only
        classify_kernel.classify_scan(type(x)(*[t.cpu() for t in x]), n, consts.cpu(),
                                      codes.cpu(), False)
    with pytest.raises(ValueError):
        classify_kernel.classify_scan(x, n, consts[:-1], codes, False)
    (pos, amp, count, threshold, n, sr), _ = r_calls[0]
    for args in ((pos.long(), amp, count, threshold), (pos, amp.double(), count, threshold),
                 (pos, amp, count[:-1], threshold), (pos, amp.t().contiguous().t(), count,
                                                     threshold),
                 (pos, amp, count, threshold.cpu())):
        with pytest.raises(ValueError):
            rhythm_kernel.rhythm_scan(*args, n, sr)
    for n_bad, sr_bad in ((1 << 24, sr), (n, 0), (n, -sr)):      # d* needs both
        with pytest.raises(ValueError):
            rhythm_kernel.rhythm_scan(pos, amp, count, threshold, n_bad, sr_bad)
    with pytest.raises(ValueError, match="CUDA"):
        rhythm_kernel.rhythm_scan(pos.cpu(), amp.cpu(), count.cpu(), threshold.cpu(), n, sr)
    assert build.launches["classify_scan"] == c_before
    assert build.launches["rhythm_scan"] == r_before


@pytest.mark.gpu
@pytest.mark.parametrize("case", FILTER_CASES, ids=[c[0] for c in FILTER_CASES])
def test_block_filter_kernel_matches_plain_version(case):
    """``csrc/block_filter.cu`` equals ``ops/filter.lfilter_plain`` bit for
    bit: rows shorter than a block, a ragged last block, 2-6 states, both
    dtypes, the main path's length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.ops import filter as filt

    _, b, a, x, zi = case
    xt, zt = torch.from_numpy(x).cuda(), torch.from_numpy(zi).cuda()
    before = build.launches["block_filter"]
    got = filt.lfilter(b, a, xt, zt)
    torch.cuda.synchronize()
    assert build.launches["block_filter"] == before + 1
    assert torch.equal(got, filt.lfilter_plain(b, a, xt, zt))


@pytest.mark.gpu
def test_filter_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.ops import filter as filt

    _, b, a, x, zi = FILTER_CASES[1]
    xt, zt = torch.from_numpy(x).cuda(), torch.from_numpy(zi).cuda()
    before = build.launches["block_filter"]
    for args in ((xt.half(), zt), (xt, zt.double()), (xt, zt[:-1]),
                 (xt.t().contiguous().t(), zt), (xt, zt.cpu()), (xt[0], zt)):
        with pytest.raises(ValueError):
            filt.lfilter(b, a, *args)
    b9, a9 = filt.butter_bandpass(5, 20.0, 150.0, 302)          # 10 states
    with pytest.raises(ValueError):
        filt.lfilter(b9, a9, xt, torch.zeros(xt.shape[0], 10, device="cuda"))
    cpu_bf = filt.BlockFilter.build(b, a, 256, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):                  # the wrapper: CUDA only
        filter_kernel.lfilter(cpu_bf, xt.cpu(), zt.cpu())
    assert build.launches["block_filter"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", FILTER_CASES, ids=[c[0] for c in FILTER_CASES])
def test_block_filter_phase_entry_points_match_their_plain_pieces(case):
    """``ops/filter.contributions`` / ``carry_scan`` / ``apply`` on the card
    (the filter kernel's phase entry points) each equal their
    ``BlockFilter`` piece bit for bit (the carry scan's exit state and
    carry-ins both), both dtypes, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, b, a, x, zi = case
    xt, zt = torch.from_numpy(x).cuda(), torch.from_numpy(zi).cuda()
    before = {k: build.launches[k] for k in chip_smoke.FILTER_PHASES}
    errors = chip_smoke.filter_phase_errors(b, a, xt, zt)
    assert errors == {"contributions": 0.0, "carry_scan": 0.0, "carry_ins": 0.0,
                      "apply": 0.0}
    assert {k: build.launches[k] for k in before} == {k: v + 1 for k, v in before.items()}


@pytest.mark.gpu
def test_filter_phase_wrappers_reject_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.ops import filter as filt

    _, b, a, x, zi = FILTER_CASES[1]
    n, L = x.shape[1], 256
    nb = -(-n // L)
    bf = filt.BlockFilter.build(b, a, L, torch.float32, "cuda")
    X = torch.nn.functional.pad(torch.from_numpy(x).cuda(), (0, nb * L - n)).reshape(-1, nb, L)
    zt = torch.from_numpy(zi).cuda()
    C = bf.contributions(X)
    S0 = bf.carry_scan(C, zt)[1]
    before = {k: build.launches[k] for k in chip_smoke.FILTER_PHASES}
    for bad in (X.double(), X[:, :, :-1], X.transpose(0, 1).contiguous().transpose(0, 1),
                X.reshape(X.shape[0], -1)):
        with pytest.raises(ValueError):
            filter_kernel.contributions(bf, bad)
        with pytest.raises(ValueError):
            filter_kernel.apply(bf, bad, S0)
    for c_bad, s_bad in ((C.double(), zt), (C, zt.double()), (C, zt[:-1]), (C[:, :, :-1], zt),
                         (C, zt.cpu())):
        with pytest.raises(ValueError):
            filter_kernel.carry_scan(bf, c_bad, s_bad)
    with pytest.raises(ValueError):
        filter_kernel.apply(bf, X, S0[:, :-1])
    cpu_bf = filt.BlockFilter.build(b, a, L, torch.float32, "cpu")
    with pytest.raises(ValueError):
        filter_kernel.contributions(cpu_bf, X)                 # tables on another device
    with pytest.raises(ValueError, match="CUDA"):              # the wrapper: CUDA only
        filter_kernel.contributions(cpu_bf, X.cpu())
    b9, a9 = filt.butter_bandpass(5, 20.0, 150.0, 302)          # 10 states
    bf9 = filt.BlockFilter.build(b9, a9, L, torch.float32, "cuda")
    with pytest.raises(ValueError):
        filter_kernel.contributions(bf9, X)
    assert {k: build.launches[k] for k in before} == before


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["engine", "default", "random"])
def test_classify_kernel_constant_division_equals_ieee_division(config):
    """The classify kernel's float32 fast division (with its range guard and
    the IEEE fallback) gives div.rn.f32's quotient bit for bit: by each
    constant divisor (the BPM span, the sample rate, 2, each chain interp's
    dx) over 2^22 numerators, for the engine's and the default
    configuration's constants, and over 2^26 random pairs (the carried
    divisors)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.config import DEFAULT_CONFIG
    from bpm_analysis_tpu_torch.models import classifier

    if config == "random":
        assert classify_kernel.division_mismatches(None, 1 << 26, seed=4) == 0
        return
    cfg = chip_smoke.engine_config() if config == "engine" else DEFAULT_CONFIG
    divisors = classifier.constant_divisors(302, cfg)
    assert len(divisors) >= 3 + 1 + 3 + 3
    assert classify_kernel.division_mismatches(divisors, 1 << 22, seed=3) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", test_torch_filter_batch.FILTERS)
def test_filter_rows_do_not_depend_on_the_batch_on_the_card(name, dtype):
    """tests/test_torch_filter_batch.py on the card (ROADMAP C6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    test_torch_filter_batch.assert_rows_do_not_depend_on_the_batch(name, dtype, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pos, val, cnt, n, window, stride, ms, nv = case
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (pos, val, cnt)]
    nv_t = None if nv is None else torch.from_numpy(nv).to(dev)
    before = build.launches["knot_quantile"]
    got = knot_kernel.knot_quantile_anchors(*args, n, window, 0.2, min_periods=3,
                                            stride=stride, min_spacing=ms, n_valid=nv_t)
    torch.cuda.synchronize()
    assert build.launches["knot_quantile"] == before + 1
    exp = kq.rolling_quantile_knots(*args, n, window, 0.2, min_periods=3, stride=stride,
                                    min_spacing=ms, n_valid=nv_t, dtype=torch.float32)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=chip_smoke.RTOL, atol=chip_smoke.ATOL, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_knot_kernel_reads_its_table_from_global_memory_with_the_same_bits(case):
    """Every case with its knot tables padded to the long cell's 32,768
    slots (``chip_smoke.padded_knot_case``), past a block's opt-in shared
    memory, so the kernel reads them from global memory: bit for bit the
    staged kernel's anchors on the unpadded tables and the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", None)
    assert optin is None or LONG_KNOT_SLOTS * 8 > optin

    def anchors(c):
        _, pos, val, cnt, n, window, stride, ms, nv = c
        args = [torch.from_numpy(a).to(dev) for a in (pos, val, cnt)]
        kw = dict(min_periods=3, stride=stride, min_spacing=ms,
                  n_valid=None if nv is None else torch.from_numpy(nv).to(dev))
        return (knot_kernel.knot_quantile_anchors(*args, n, window, 0.2, **kw),
                kq.rolling_quantile_knots(*args, n, window, 0.2, **kw, dtype=torch.float32))

    shared, _ = anchors(case)
    got, exp = anchors(chip_smoke.padded_knot_case(case, LONG_KNOT_SLOTS))
    assert chip_smoke.same_values(got, shared) and chip_smoke.same_values(got, exp)


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
    with pytest.raises(ValueError, match="CUDA"):                  # the wrapper: CUDA only
        knot_kernel.knot_quantile_anchors(pos.cpu(), val.cpu(), cnt.cpu(), 100, 31, 0.2)


STRIDED_CASES = chip_smoke.strided_kernel_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("case", STRIDED_CASES, ids=[c[0] for c in STRIDED_CASES])
def test_strided_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, x, window, stride, q, mp = case
    xt = torch.from_numpy(x).to("cuda")
    before = build.launches["strided_quantile"]
    got = quantile_kernel.strided_quantile_anchors(xt, window, q, mp, stride)
    torch.cuda.synchronize()
    assert build.launches["strided_quantile"] == before + 1
    exp = tq.strided_quantile_anchors_f32_plain(xt, window, q, mp, stride)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=chip_smoke.STRIDED_RTOL, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_strided_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((2, 400), dtype=torch.float32, device="cuda")
    before = build.launches["strided_quantile"]
    for bad in (x.to(torch.int32), x.double(), x[:, ::2], x[0], x.cpu()):
        with pytest.raises(ValueError):
            quantile_kernel.strided_quantile_anchors(bad, 61, 0.2, 3, 8)
    with pytest.raises(ValueError):
        quantile_kernel.strided_quantile_anchors(x, quantile_kernel.MAX_WINDOW + 1, 0.2, 3, 8)
    assert build.launches["strided_quantile"] == before


# The fleet cell's batch, the serial cell's envelope (one ten-minute 44.1 kHz
# WAV decimated by 146 from its 2^25-sample bucket), a ragged small shape.
ROW_QUANTILE_SHAPES = [(512, 181_200), (1, 229_825), (3, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("shape", ROW_QUANTILE_SHAPES, ids=str)
def test_row_quantile_kernel_matches_plain_version(shape, dtype):
    """Every case of ``chip_smoke.row_quantile_cases`` at q = 0, 0.1, 0.5
    and 1 bit for bit (NaN equal to NaN), one launch a call; the batch of 512
    tiles the three rows, the batch of 1 takes each row alone (a cluster
    shares it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bsz, n = shape
    if bsz == 1:
        assert row_quantile_kernel.split(1) > 1
    for name, x, valid in chip_smoke.row_quantile_cases(n):
        xt = torch.from_numpy(x).to("cuda", dtype)
        vt = None if valid is None else torch.from_numpy(valid).to("cuda")
        if bsz == 1:
            batches = [(xt[r:r + 1], None if vt is None else vt[r:r + 1]) for r in range(3)]
        else:
            reps = -(-bsz // 3)
            batches = [(xt.repeat(reps, 1)[:bsz].contiguous(),
                        None if vt is None else vt.repeat(reps, 1)[:bsz].contiguous())]
        for xb, vb in batches:
            for q in chip_smoke.ROW_QUANTILE_QS:
                before = build.launches["row_quantile"]
                got = row_quantile_kernel.quantile_exact(xb, q, vb)
                torch.cuda.synchronize()
                assert build.launches["row_quantile"] == before + 1
                exp = tq.quantile_exact_plain(xb, q, vb)
                assert chip_smoke.same_values(got, exp), (name, q, got[:3], exp[:3])


@pytest.mark.gpu
def test_row_quantile_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((2, 400), dtype=torch.float32, device="cuda")
    valid = torch.ones((2, 400), dtype=torch.bool, device="cuda")
    before = build.launches["row_quantile"]
    for bad, v in ((x.to(torch.int32), None), (x.half(), None), (x[:, ::2], None),
                   (x[0], None), (x, valid[:, :200]), (x, valid.cpu()),
                   (x.cpu(), valid.cpu())):
        with pytest.raises(ValueError):
            row_quantile_kernel.quantile_exact(bad, 0.2, v)
    assert build.launches["row_quantile"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("shape", chip_smoke.ROLLING_SHAPES, ids=str)
def test_rolling_quantile_kernel_matches_plain_version_and_reference(shape, dtype):
    """Every case of ``chip_smoke.rolling_quantile_cases`` at each of its
    quantiles: bit for bit (NaN equal to NaN) against the plain version, one
    launch a call inside ``bpm.rolling_exact`` at every window (those past
    ``shared_window`` sorted in global scratch); and equal to the sorted
    windows of ``bench_port/reference/exact_floor.py``, whose unstable sort
    leaves only the sign of a selected zero open."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_port.reference import exact_floor

    bsz, n = shape
    for name, x, window, qs, mp in chip_smoke.rolling_quantile_cases(n, bsz):
        xt = torch.from_numpy(x).to("cuda", dtype)
        for q in qs:
            before = build.launches["rolling_quantile"]
            got = tq.rolling_quantile_centered(xt, window, q, mp)
            torch.cuda.synchronize()
            assert build.launches["rolling_quantile"] == before + 1, name
            exp = tq.rolling_quantile_centered_plain(xt, window, q, mp)
            assert chip_smoke.same_values(got, exp), (name, window, q)
            ref = exact_floor.rolling_quantile_centered(xt, window, q, mp, block=4096)
            torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} window {window} q={q}")


@pytest.mark.gpu
def test_rolling_quantile_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    """Bad dtypes, shapes, parameters and a CPU tensor raise before a
    launch; a strided tensor is taken as its contiguous copy."""
    x = torch.ones((2, 400), dtype=torch.float32, device="cuda")
    before = build.launches["rolling_quantile"]
    for bad in (x.to(torch.int32), x.half(), x[0], x.cpu()):
        with pytest.raises(ValueError):
            rolling_quantile_kernel.rolling_quantile_centered(bad, 64, 0.2, 3)
    for window, q in ((0, 0.2), (64, 1.5), (64, float("nan"))):
        with pytest.raises(ValueError):
            rolling_quantile_kernel.rolling_quantile_centered(x, window, q, 3)
    assert build.launches["rolling_quantile"] == before
    strided = torch.randn((2, 800), device="cuda")[:, ::2]
    assert chip_smoke.same_values(
        rolling_quantile_kernel.rolling_quantile_centered(strided, 64, 0.2, 3),
        tq.rolling_quantile_centered_plain(strided.contiguous(), 64, 0.2, 3))


@pytest.mark.gpu
def test_batched_host_on_the_card_equals_the_cpu(tmp_path, monkeypatch):
    """``host_batch.analyze_files_batched`` on two short synthetic WAVs on the
    card: final positions equal the same call with ``device="cpu"``; the
    chunk was staged in pinned host memory, copied on the side stream, and
    the compute stream waited on the copy's event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch import host_batch, synth
    from bpm_analysis_tpu_torch.config import AnalyzerConfig, RuntimeConfig
    from bpm_analysis_tpu_torch.io import wav

    cfg = AnalyzerConfig(runtime=RuntimeConfig(
        max_raw_peaks=512, max_troughs=512, max_candidates=256, extrema_capacity=4096,
        noise_quantile_stride=64, quantile_backend="auto", dtype="float32"))
    paths = []
    for seed, seconds in ((0, 45), (1, 42)):     # one length bucket, one chunk
        p = str(tmp_path / f"rec{seed}.wav")
        wav.write(p, synth.SR, synth._quantize_int16(synth.synth_recording(seed)[:synth.SR * seconds]))
        paths.append(p)

    pinned, waits = [], []
    real_buffer, real_wait = host_batch._staging_buffer, torch.cuda.Stream.wait_event

    def spy_buffer(*a, **k):
        buf = real_buffer(*a, **k)
        pinned.append(buf.is_pinned())
        return buf

    def spy_wait(self, event):
        waits.append(event)
        return real_wait(self, event)

    monkeypatch.setattr(host_batch, "_staging_buffer", spy_buffer)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", spy_wait)
    before = build.launches["knot_quantile"]
    card, errors = host_batch.analyze_files_batched(paths, cfg, str(tmp_path / "card"),
                                                   render=False, min_bucket=1 << 13)
    assert errors == []
    assert build.launches["knot_quantile"] == before + 2
    assert pinned and all(pinned) and len(waits) == 1
    cpu, errors = host_batch.analyze_files_batched(paths, cfg, str(tmp_path / "cpu"),
                                                  render=False, min_bucket=1 << 13,
                                                  device="cpu")
    assert errors == []
    for p in paths:
        count = int(cpu[p].final_count)
        assert count > 40 and int(card[p].final_count) == count
        np.testing.assert_array_equal(card[p].final_positions[:count],
                                      cpu[p].final_positions[:count])


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1536, 3072])
@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.metrics_cases(1536)])
def test_metrics_kernel_matches_plain_version_on_the_cases(case, cap):
    """``chip_smoke.metrics_cases`` (the CPU emulation's cases) at the fleet's
    and native-44k's capacities, float32 and float64: every field bit for
    bit, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import analytics

    _, sr, pos, cnt = next(c for c in chip_smoke.metrics_cases(cap) if c[0] == case)
    p, c = torch.from_numpy(pos).cuda(), torch.from_numpy(cnt).cuda()
    cfg = AnalyzerConfig()
    for dtype in (torch.float32, torch.float64):
        before = build.launches["metrics"]
        got = analytics.compute_metrics(p, c, sr, cfg, dtype)
        assert build.launches["metrics"] == before + 1
        assert chip_smoke.metrics_differ(
            got, analytics.compute_metrics_plain(p, c, sr, cfg, dtype)) == [], (case, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("config, dtype, rows", [
    ("engine-302hz", torch.float32, 1), ("engine-302hz", torch.float32, 16),
    ("engine-302hz", torch.float32, 512), ("exact-f64", torch.float64, 256),
    ("native-44k", torch.float32, 16)])
def test_metrics_kernel_matches_plain_version_at_the_cells_shapes(config, dtype, rows):
    """Fleet rows at each cell's capacity and dtype (B = 1, 16 and 512 in
    float32, 256 in float64, native-44k's capacity of 3072): every field bit
    for bit against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_port import core
    from bpm_analysis_tpu_torch.models import analytics

    cfg = core.program_config(core.load_json(core.HERE, "configs", f"{config}.json")["runtime"])
    cap = cfg.runtime.max_candidates
    pos, cnt = chip_smoke.metrics_fleet_rows(rows, cap, chip_smoke.SR, seed=rows)
    p, c = torch.from_numpy(pos).cuda(), torch.from_numpy(cnt).cuda()
    assert analytics.smoothing_slot_bound(chip_smoke.SR, cfg) < cap   # the bounded window
    got = analytics.compute_metrics(p, c, chip_smoke.SR, cfg, dtype)
    assert chip_smoke.metrics_differ(
        got, analytics.compute_metrics_plain(p, c, chip_smoke.SR, cfg, dtype)) == []


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, cap", [(torch.float64, 4608), (torch.float64, 8192),
                                        (torch.float32, 12288), (torch.float32, 16384)])
def test_metrics_kernel_matches_plain_version_past_shared_memory(dtype, cap, monkeypatch):
    """Capacities whose rows do not fit a block's shared memory, as the
    overflow retry's doubled capacities reach: the row's arrays in global
    scratch, 3 blocks looping over 8 rows of up to ~70 minutes of beats;
    every field bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import analytics

    size = torch.finfo(dtype).bits // 8
    per_block = metrics_kernel.LIBRARY.load().metrics_scratch_bytes(
        cap, analytics.HRV_CAPACITY, size)
    assert per_block > 0
    monkeypatch.setattr(metrics_kernel, "SCRATCH_BYTES", 3 * per_block)
    pos, cnt = chip_smoke.metrics_fleet_rows(8, cap, chip_smoke.SR, seed=cap,
                                             seconds=cap * 0.5)
    p, c = torch.from_numpy(pos).cuda(), torch.from_numpy(cnt).cuda()
    cfg = AnalyzerConfig()
    got = analytics.compute_metrics(p, c, chip_smoke.SR, cfg, dtype)
    assert chip_smoke.metrics_differ(
        got, analytics.compute_metrics_plain(p, c, chip_smoke.SR, cfg, dtype)) == []


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fine, cap", [(True, 1536), (False, 40)],
                         ids=["past_128_slots", "window_past_cap"])
def test_metrics_kernel_with_an_unbounded_window(fine, cap, dtype, monkeypatch):
    """A smoothing window of more than 128 slots (beats allowed 10 ms apart)
    or not below the capacity: every field bit for bit against the plain
    version's bounded form at M = cap - 1, and the smoothed BPM within
    ``chip_smoke.METRICS_UNBOUNDED_RTOL`` of its prefix-sum form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import analytics

    cfg = AnalyzerConfig()
    if fine:
        cfg = dataclasses.replace(cfg, features=dataclasses.replace(
            cfg.features, min_peak_distance_sec=0.01))
    sr = chip_smoke.SR
    bound = analytics.smoothing_slot_bound(sr, cfg)
    assert bound is None or bound >= cap
    pos, cnt = chip_smoke.metrics_fleet_rows(16, cap, sr, seed=cap)
    p, c = torch.from_numpy(pos).cuda(), torch.from_numpy(cnt).cuda()
    got = analytics.compute_metrics(p, c, sr, cfg, dtype)
    prefix = analytics.compute_metrics_plain(p, c, sr, cfg, dtype)
    monkeypatch.setattr(analytics, "smoothing_slot_bound", lambda *a: cap - 1)
    bounded = analytics.compute_metrics_plain(p, c, sr, cfg, dtype)
    assert chip_smoke.metrics_differ(got, bounded) == []
    g, e = got.bpm.smoothed, prefix.bpm.smoothed
    assert torch.equal(torch.isnan(g), torch.isnan(e))
    ok = ~torch.isnan(e)
    rtol = chip_smoke.METRICS_UNBOUNDED_RTOL[dtype]
    assert bool(((g[ok] - e[ok]).abs() <= rtol * e[ok].abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", [100, 300])
def test_metrics_kernel_with_wide_hrv_windows(window, dtype):
    """HRV windows past 64 intervals: every field bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import analytics

    cfg = AnalyzerConfig()
    cfg = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, hrv_window_size_beats=window, hrv_step_size_beats=window // 8))
    pos, cnt = chip_smoke.metrics_fleet_rows(16, 1536, chip_smoke.SR, seed=window)
    p, c = torch.from_numpy(pos).cuda(), torch.from_numpy(cnt).cuda()
    got = analytics.compute_metrics(p, c, chip_smoke.SR, cfg, dtype)
    assert int(got.hrv.count.min()) > 0
    assert chip_smoke.metrics_differ(
        got, analytics.compute_metrics_plain(p, c, chip_smoke.SR, cfg, dtype)) == []


@pytest.mark.gpu
def test_fixed_order_sums_do_not_depend_on_the_batch_on_the_card():
    """A row alone and the same row in a batch of 16 give the same bits on
    the card: the rolling means, the fixed-order sums and the metrics built
    on them (a library scan or reduction would take its association from
    the whole shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch.config import AnalyzerConfig
    from bpm_analysis_tpu_torch.models import analytics
    from bpm_analysis_tpu_torch.ops import rolling, series

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    cap = 1536
    gaps = rng.randint(40, 140, size=(16, cap))
    positions = torch.from_numpy(np.cumsum(gaps, axis=1).astype(np.int32)).to(dev)
    count = torch.from_numpy(rng.randint(1000, 1400, size=16).astype(np.int32)).to(dev)
    cfg = AnalyzerConfig()
    batch = analytics.compute_metrics(positions, count, 302, cfg, torch.float32)
    alone = analytics.compute_metrics(positions[:1], count[:1], 302, cfg, torch.float32)
    def same(a, b):
        return torch.equal(torch.nan_to_num(a[:1]), torch.nan_to_num(b))

    for name in ("avg_bpm", "avg_rmssdc", "avg_sdnn"):
        assert same(getattr(batch, name), getattr(alone, name)), name
    for name in ("times", "smoothed"):
        assert same(getattr(batch.bpm, name), getattr(alone.bpm, name)), name
    for name in ("rmssdc", "sdnn", "bpm"):
        assert same(getattr(batch.hrv, name), getattr(alone.hrv, name)), name

    x = torch.from_numpy(rng.rand(16, 2559).astype(np.float32) * 3).to(dev)
    valid = torch.arange(2559, device=dev)[None, :] < torch.from_numpy(
        rng.randint(1500, 2559, size=(16, 1))).to(dev)
    window = torch.full((16,), 97, dtype=torch.int32, device=dev)
    got = rolling.rolling_mean_dynamic_window(x, valid, window, 128)
    one = rolling.rolling_mean_dynamic_window(x[:1], valid[:1], window[:1], 128)
    assert same(got, one)
    assert torch.equal(series.fixed_order_sum(x)[:1], series.fixed_order_sum(x[:1]))

    # The band-pass filter at the main path's length, masked as the host runs it.
    from bpm_analysis_tpu_torch.ops import filter as filt

    sig = torch.from_numpy((rng.randn(16, 181200) * 500).astype(np.float32)).to(dev)
    n_valid = torch.from_numpy(rng.randint(150000, 181201, size=16)).to(dev)
    for nv in (None, n_valid):
        got = filt.bandpass_filtfilt(sig, 302, 20.0, 150.0, 2, n_valid=nv)
        one = filt.bandpass_filtfilt(sig[:1], 302, 20.0, 150.0, 2,
                                     n_valid=None if nv is None else nv[:1])
        assert torch.equal(got[:1], one)


@pytest.mark.gpu
def test_dp_ranks_share_the_card(tmp_path):
    """Two gloo ranks on the one card (the default backend when ranks share
    a card): ``analyze_files_batched(mesh=...)`` gives the unsharded card
    run's final positions on both ranks, and the exchange helpers carry a
    CUDA tensor through gloo and back onto the rank's device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import _torch_rank_bodies as bodies
    from bpm_analysis_tpu_torch import host_batch, synth
    from bpm_analysis_tpu_torch.config import AnalyzerConfig, RuntimeConfig
    from bpm_analysis_tpu_torch.io import wav
    from bpm_analysis_tpu_torch.parallel import mesh

    cfg = AnalyzerConfig(runtime=RuntimeConfig(
        max_raw_peaks=512, max_troughs=512, max_candidates=256, extrema_capacity=4096,
        noise_quantile_stride=64, quantile_backend="auto", dtype="float32"))
    paths = []
    for seed, seconds in ((0, 45), (1, 42)):
        p = str(tmp_path / f"rec{seed}.wav")
        wav.write(p, synth.SR, synth._quantize_int16(synth.synth_recording(seed)[:synth.SR * seconds]))
        paths.append(p)
    card, errors = host_batch.analyze_files_batched(paths, cfg, str(tmp_path / "card"),
                                                   render=False, min_bucket=1 << 13)
    assert errors == []
    ranks = mesh.spawn(bodies.card_dp_rank, 2, None, "cuda", paths, cfg,
                       str(tmp_path / "mesh"))
    for roster, rank_errors, trip in ranks:
        assert rank_errors == []
        for p in paths:
            count = int(card[p].final_count)
            assert count > 40
            np.testing.assert_array_equal(roster[p], card[p].final_positions[:count])
        assert trip["backend"] == "gloo"
        assert trip["device"] == trip["summed_device"] == trip["rank_device"] == "cuda:0"
        np.testing.assert_array_equal(trip["gathered"],
                                      np.arange(5, dtype=np.float32) + [[0], [10]])
        np.testing.assert_array_equal(trip["summed"], 2 * np.arange(5) + 10)


@pytest.mark.gpu
def test_exact_f64_floor_equals_the_plain_reference_at_full_width():
    """``analyze_batch`` at the ``exact-f64`` configuration on 4 rows of the
    ``exact-f64-b256`` cell's first batch (181,200 float64 samples each):
    the floor equals, bit for bit, the plain reference
    (``bench_port/reference/exact_floor.py``: sorted windows) rebuilt from
    the result's sanitized troughs and the envelope.  Both select values of
    the series and finish with the same operations in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_port import core
    from bench_port.reference import exact_floor
    from bench_port.traffic import fleet_rows
    from bpm_analysis_tpu_torch.models import envelope, noise_floor, pipeline

    spec = core.cell_spec("exact-f64-b256")
    cfg = core.program_config(spec.config["runtime"])
    assert noise_floor.quantile_path(cfg) == "exact"
    rows = fleet_rows.make(spec.workload["traffic"], 2**31 + 18, "")["batches"][0][:4]
    env = envelope.preprocess(rows, 302, cfg)[0]
    res = pipeline.analyze_batch(env, 302, cfg)
    assert env.dtype == res.floor.dtype == torch.float64 and env.shape == (4, 181_200)
    assert (res.trough_count > 2).all() and not res.overflowed.any()
    exp = exact_floor.floors(env, res.trough_positions, res.trough_count,
                             int(cfg.noise.noise_window_sec * 302), cfg.noise.noise_floor_quantile)
    err = (res.floor - exp).abs().nan_to_num(nan=float("inf")).max().item()
    print(f"exact-f64 floor against the plain reference, 4 x 181,200: max abs error {err!r}")
    assert chip_smoke.same_values(res.floor, exp), err


# The largest difference of a float field between the card and the CPU, over
# the largest magnitude of the field on the CPU, where every integer field
# is equal: an ulp or two of float32 where a kernel and the plain version
# round one step apart (8.5e-8 on the classifier's trace), far below a beat
# time moved across a smoothing window's edge (1.1e-3 of the BPM series'
# scale on these rows).
FLOAT_FIELD_RTOL = 1e-5


def _leaves(a, b, floating: bool, prefix=""):
    """(name, a's array, b's array) over the float leaves, or the integer
    and boolean leaves, of two results of one type."""
    for name, x in zip(a._fields, a):
        y = getattr(b, name)
        if hasattr(x, "_fields"):
            yield from _leaves(x, y, floating, f"{prefix}{name}.")
        elif isinstance(x, torch.Tensor) and x.is_floating_point() == floating:
            yield f"{prefix}{name}", x.cpu().numpy(), y.cpu().numpy()


@pytest.mark.gpu
def test_stress_rows_on_the_card_equal_the_cpu():
    """``stress-b512``'s configuration on 4 rows of the cell's first batch,
    the first of each family (clipping, dropouts, 40 BPM, 165 BPM; 181,200
    float32 samples each): every integer and boolean field of the result
    equal between the card and the port's CPU path, every float field
    within ``FLOAT_FIELD_RTOL`` of its scale (NaN and infinities in the same
    places), no row overflowed, and each answer within the cell's limits
    against the upstream answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_port import core
    from bench_port.traffic import fleet_stress
    from bpm_analysis_tpu_torch.models import envelope, pipeline

    spec = core.cell_spec("stress-b512")
    cfg = core.program_config(spec.config["runtime"])
    made = fleet_stress.make(spec.workload["traffic"], 2**31 + 22, "")
    ids = made["ids"][0]
    rows = [next(r for r, rid in enumerate(ids) if rid % 4 == family) for family in range(4)]
    x = made["batches"][0][rows]
    out = {}
    for device in ("cuda", "cpu"):
        env = envelope.preprocess(x, 302, cfg, device=device)[0]
        out[device] = pipeline.analyze_batch(env, 302, cfg, device=device)
    _assert_card_equals_cpu(out["cuda"], out["cpu"], spec, [ids[r] for r in rows])


def _assert_card_equals_cpu(card, cpu, spec, ids) -> None:
    """Every integer and boolean field of two results of the main path
    equal, every float field within ``FLOAT_FIELD_RTOL`` of its scale (NaN
    and infinities in the same places), no row overflowed, and each row's
    answer (recording ``ids[r]``) within the cell's limits against the
    pool's answers."""
    from bench_port.entries.engine import _row
    from bench_port.reference import compare, upstream
    from bpm_analysis_tpu_torch import host

    names = set()
    for name, g, c in _leaves(card, cpu, floating=False):
        assert g.shape == c.shape, name
        np.testing.assert_array_equal(g, c, err_msg=name)
        names.add(name)
    assert {"trough_positions", "raw_peak_positions", "classes", "s1_positions",
            "final_positions", "final_count", "overflowed", "ok"} <= names
    floats = {}
    for name, g, c in _leaves(card, cpu, floating=True):
        assert g.shape == c.shape, name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(c), err_msg=name)
        fin = np.isfinite(c)
        np.testing.assert_array_equal(g[~fin], c[~fin], err_msg=name)
        scale = np.abs(c[fin]).max() if fin.any() else 0.0
        floats[name] = float(np.abs(g[fin] - c[fin]).max() / scale) if scale else 0.0
    print(f"float fields, card against CPU, max abs difference over the field's scale: {floats}")
    assert {"floor", "metrics.bpm.smoothed", "metrics.avg_bpm"} <= set(floats)
    assert max(floats.values()) <= FLOAT_FIELD_RTOL, floats
    assert not card.overflowed.any() and card.ok.all()
    pool = upstream.pool(spec.workload["traffic"]["pool"])
    limits = spec.workload["check"]["limits"]
    res = host.to_host(card)
    for r, rid in enumerate(ids):
        got = compare.numbers(compare.answer_of(_row(res, r)), pool.answer(rid))
        print(f"{spec.name}: id {rid} on the card: {got}")
        assert all(got[k] <= limits[k] for k in got), (rid, got)


@pytest.mark.gpu
def test_long_rows_on_the_card_equal_the_cpu():
    """``long-2h-b64``'s configuration on 4 two-hour rows, one from each
    quarter of the pool (2,174,400 float32 samples each): the card against
    the port's CPU path as in the stress test above; and, on the path's own
    inputs on the card, both knot-quantile launches with their 32,768-slot
    tables in global memory, the trough NMS's launch in global scratch
    (264,190 slots), the raw-peak NMS's in a cluster of 8 (196,608 slots),
    the metrics kernel's global-scratch launch (18,432 slots) and both
    classifier passes (32,768 slots) equal to their plain versions.  The
    plain scans run on CPU copies of their inputs: every division in them
    has a tensor divisor and their sums are of flags, so their bits do not
    depend on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_port import core
    from bench_port.traffic import synth
    from bpm_analysis_tpu_torch.models import analytics, classifier

    spec = core.cell_spec("long-2h-b64")
    rt = spec.config["runtime"]
    cfg = core.program_config(rt)
    x = np.stack([synth.quantize_int16(synth.synth_recording(i, 120))
                  for i in chip_smoke.LONG_IDS]).astype(np.float32)
    k_calls, n_calls, m_calls, c_calls = [], [], [], []
    card, launches = chip_smoke.counted_run(x, cfg, {
        (knot_kernel, "knot_quantile_anchors"): k_calls,
        (nms_kernel, "select_by_distance"): n_calls,
        (analytics, "compute_metrics"): m_calls,
        (classifier, "classify_scan"): c_calls})
    print(f"kernel launches on 4 two-hour rows: {launches}")
    _assert_card_equals_cpu(card, chip_smoke.run_main_path(x, cfg, "cpu"), spec,
                            chip_smoke.LONG_IDS)

    assert len(k_calls) == 2
    for a, k in k_calls:
        assert a[0].shape[1] == rt["max_troughs"] == LONG_KNOT_SLOTS
        got = knot_kernel.knot_quantile_anchors(*a, **k)
        assert chip_smoke.same_values(got, kq.rolling_quantile_knots(*a, **k,
                                                                     dtype=torch.float32))
    widths = {a[0].shape[1]: a for a, _ in n_calls}
    assert sorted(widths) == sorted([rt["raw_candidate_capacity"], rt["extrema_capacity"] - 2])
    assert nms_kernel.plan(rt["extrema_capacity"] - 2).scratch
    assert nms_kernel.plan(rt["raw_candidate_capacity"]).split == nms_kernel.MAX_SPLIT
    for width, a in widths.items():
        got, exp = chip_smoke.nms_pair(*a[:4])
        assert torch.equal(got, exp), width
    (a, k), = m_calls
    assert metrics_kernel.LIBRARY.load().metrics_scratch_bytes(
        a[0].shape[1], analytics.HRV_CAPACITY, 4) > 0
    bad = chip_smoke.metrics_differ(analytics.compute_metrics(*a, **k),
                                    analytics.compute_metrics_plain(*a, **k))
    assert not bad, bad
    assert [a[0].positions.shape[1] for a, _ in c_calls] == [rt["max_raw_peaks"]] * 2
    for label, (a, k) in zip(("preliminary", "main"), c_calls):
        got = classifier.classify_scan(*a, **k)
        inputs = type(a[0])(*(t.cpu() for t in a[0]))
        exp = classifier.scan_plain(inputs, *a[2:], **k)
        got = (got[0].cpu(), None if got[1] is None else type(got[1])(
            *(None if t is None else t.cpu() for t in got[1])))
        assert chip_smoke.trace_error(got, exp) == 0, label


# ---------------------------------------------------------------------------
# The distance NMS
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.nms_cases()])
def test_nms_kernel_matches_plain_version_on_the_cases(case):
    """``chip_smoke.nms_cases`` (the CPU emulation's cases): the keep mask
    equal to the plain version's on the card, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, pos, prio, valid, dist = next(c for c in chip_smoke.nms_cases() if c[0] == case)
    got, exp = chip_smoke.nms_pair(*(torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                                     else a for a in (pos, prio, valid, dist)))
    assert torch.equal(got, exp), case


_NMS_CALLS = {}
NMS_CONFIGS = {"fleet": ("engine-302hz", False, {22_014, 16_384}),
               "stress": ("engine-stress-302hz", True, {40_958}),
               "native": ("native-44k", True, {32_766})}


def _nms_calls(config: str) -> list:
    """``nms_kernel.select_by_distance``'s arguments on the main path of 16
    ten-minute 302 Hz recordings on the card, at a cell's configuration:
    the fleet's ids at ``engine-302hz`` (22,014 trough and 16,384 raw-peak
    slots), the stress ids at ``engine-stress-302hz`` (40,958) and at
    ``native-44k``'s capacities (32,766)."""
    if config not in _NMS_CALLS:
        from bench_port import core
        from bpm_analysis_tpu_torch import synth

        name, stress, _ = NMS_CONFIGS[config]
        cfg = core.program_config(core.load_json(core.HERE, "configs", f"{name}.json")["runtime"])
        make = synth.synth_stress_recording if stress else synth.synth_recording
        rows = np.stack([synth._quantize_int16(make(s)) for s in range(16)]).astype(np.float32)
        calls = []
        real = nms_kernel.select_by_distance

        def capture(*a):
            calls.append(a)
            return real(*a)

        nms_kernel.select_by_distance = capture
        try:
            chip_smoke.run_main_path(rows, cfg, "cuda")
        finally:
            nms_kernel.select_by_distance = real
        _NMS_CALLS[config] = calls
    return _NMS_CALLS[config]


@pytest.mark.gpu
@pytest.mark.parametrize("config", sorted(NMS_CONFIGS))
def test_nms_kernel_matches_plain_version_at_the_cells_widths(config):
    """The path's two calls at each width and their ``chip_smoke.nms_variants``
    (B=1, all-equal priorities, signed zeros, float64 ties, a distance of
    200, a per-row distance, no valid slot, every slot valid): keep masks
    equal to the plain version's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    calls = _nms_calls(config)
    assert len(calls) == 2 and {a[0].shape[1] for a in calls} == NMS_CONFIGS[config][2]
    assert all(a[0].shape[0] == 16 and a[3] == chip_smoke.NMS_DISTANCE and a[4] == 9
               for a in calls)
    for a in calls:
        for name, *call in chip_smoke.nms_variants(*a[:4]):
            got, exp = chip_smoke.nms_pair(*call)
            assert torch.equal(got, exp), (tuple(a[0].shape), name)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 3, 8, "scratch"])
def test_nms_kernel_matches_plain_version_in_every_plan(split, monkeypatch):
    """The fleet's trough call held in a cluster of 3 and of 8 blocks (the
    halo across several parts) and in global scratch, as well as in the
    one block its width takes: keep masks equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = next(a for a in _nms_calls("fleet") if a[0].shape[1] == 22_014)
    cap = a[0].shape[1]
    forced = (nms_kernel.Plan(1, cap, True) if split == "scratch"
              else nms_kernel.Plan(split, -(-cap // split), False))
    monkeypatch.setattr(nms_kernel, "plan", lambda c: forced if c == cap else None)
    assert nms_kernel.plan(cap) == forced
    for name, *call in chip_smoke.nms_variants(*a[:4]):
        got, exp = chip_smoke.nms_pair(*call)
        assert torch.equal(got, exp), (split, name)


@pytest.mark.gpu
def test_nms_wrapper_rejects_what_the_kernel_does_not_take():
    """A CUDA int32 position tensor, a mask on the CPU, positions that may
    reach 2^24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos = torch.zeros((2, 8), dtype=torch.int64, device="cuda")
    prio = torch.zeros((2, 8), dtype=torch.float32, device="cuda")
    valid = torch.zeros((2, 8), dtype=torch.bool, device="cuda")
    for args, what in (((pos.int(), prio, valid, 15, 9, 100), "expected"),
                       ((pos, prio, valid.cpu(), 15, 9, 100), "expected"),
                       ((pos, prio, valid, 15, 9, (1 << 24) + 1), "2\\^24")):
        with pytest.raises(ValueError, match=what):
            nms_kernel.select_by_distance(*args)


@pytest.mark.gpu
def test_stress_integer_fields_equal_with_the_plain_nms_on_the_card(monkeypatch):
    """``pipeline.analyze_batch`` at ``engine-stress-302hz`` on the four
    families' first ids on the card, with the kernel and again with the
    plain version in its place: every integer and boolean field equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpm_analysis_tpu_torch import synth
    from bpm_analysis_tpu_torch.ops import find_peaks as fp

    cfg = chip_smoke.bench_config("engine-stress-302hz")
    rows = np.stack([synth._quantize_int16(synth.synth_stress_recording(s))
                     for s in range(4)]).astype(np.float32)
    before = build.launches["distance_nms"]
    kernel = chip_smoke.run_main_path(rows, cfg, "cuda")
    assert build.launches["distance_nms"] == before + 2
    monkeypatch.setattr(nms_kernel, "select_by_distance",
                        lambda p, pr, v, d, reach, length:
                        fp._select_by_distance_plain(p, pr, v, d))
    plain = chip_smoke.run_main_path(rows, cfg, "cuda")
    names = set()
    for name, g, c in _leaves(kernel, plain, floating=False):
        np.testing.assert_array_equal(g, c, err_msg=name)
        names.add(name)
    assert {"trough_positions", "raw_peak_positions", "final_positions"} <= names
